"""Time the grouped-matmul kernels against variants of their source, in turns.

    python3 scripts/torch_gmm_variants.py [--baseline OTHER.cu]

Builds ``bagua_tpu_torch/ops/csrc/gmm.cu`` as it is and as each variant of
``VARIANTS`` (the same file with a line replaced: the output tile's width
and K7b's chunk of rows, the two choices the source note says were settled
by timing), plus, with ``--baseline``, another version of the file (for
example the parent commit's, written by ``git show`` into a directory
``.gitignore`` lists); one ``nvcc`` each, all started together.  Each
build's registers and spills per kernel are printed; each build's K7a (both
forms) and K7b are held against the plain versions (bf16) on a ragged case
and a skewed one of more than a chunk, then timed hot at the MoE path's
shapes (rows 65536, 8 groups, (d, f) = (512, 2048) and (2048, 512)) in the
order A B ... B A, so that two versions are compared on one card in one
call: K7a in its four forms and K7b at both shapes with balanced groups,
with one group holding half the rows, and with the rows per expert that
slice 2's first MoE layer routes after its 10 steps in ``chip_smoke.py``.
``torch._grouped_mm`` is timed first and last as the yardstick.  Needs a
CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# name -> [(text in the source, replacement), ...]: the two choices of the
# design that were settled by timing (PERF.md has the times of these and of
# the variants timed once and dropped)
VARIANTS = {
    # 128 x 128 output tiles (m64n128 wgmma, four stages of 32 KB)
    "tile_n_128": [("constexpr int kTileN = 256;", "constexpr int kTileN = 128;")],
    # K7b: groups cut into chunks of 4096 rows (the balanced case then sums
    # each output tile in two chunks)
    "chunk_4096": [("constexpr int kChunkRows = 8192;", "constexpr int kChunkRows = 4096;")],
}

ROWS, GROUPS = 65536, 8
SHAPES = [(512, 2048), (2048, 512)]
#: rows per expert of slice 2's first MoE layer on its training batch after
#: 10 steps (``chip_smoke.py``'s "slice 2 routing" line): a fresh model's skew
ROUTED = [8097, 9317, 5764, 7384, 10104, 7791, 7657, 9422]


def variant_source(text, edits):
    """``text`` with each edit of a variant made."""
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"{old!r} is not in the source")
        text = text.replace(old, new)
    return text


def start_build(name, source, out_dir):
    from bagua_tpu_torch.ops import _build

    src = out_dir / f"{name}.cu"
    src.write_text(source)
    return subprocess.Popen(_build.nvcc_command(src, out_dir / f"{name}.so"),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def bind(path):
    from bagua_tpu_torch.ops import gmm as gm

    lib = ctypes.CDLL(str(path))
    for fn, argtypes in gm._SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def launchers(lib, lhs, rhs, rhs_t, gout, sizes):
    """K7a (plain and transposed rhs) and K7b of ``lib`` on one bf16 input,
    each a function returning its CUDA error code, and their outputs."""
    rows, m = lhs.shape
    n_groups, _, n = rhs.shape
    out = torch.empty((rows, n), dtype=lhs.dtype, device="cuda")
    out_t = torch.empty_like(out)
    d_rhs = torch.empty((n_groups, m, n), dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    p = lambda t: t.data_ptr()
    fns = {
        "k7a": lambda: lib.bagua_gmm(p(lhs), p(rhs), p(sizes), p(out), rows, m, n, n_groups,
                                     0, 1, stream),
        "k7a_t": lambda: lib.bagua_gmm(p(lhs), p(rhs_t), p(sizes), p(out_t), rows, m, n,
                                       n_groups, 1, 1, stream),
        "k7b": lambda: lib.bagua_gmm_drhs(p(lhs), p(gout), p(sizes), p(d_rhs), rows, m, n,
                                          n_groups, 1, stream),
    }
    return fns, {"k7a": out, "k7a_t": out_t, "k7b": d_rhs}


def inputs(rows, m, n, n_groups, g):
    lhs = torch.randn(rows, m, device="cuda", generator=g).bfloat16()
    rhs = (torch.randn(n_groups, m, n, device="cuda", generator=g) / math.sqrt(m)).bfloat16()
    gout = torch.randn(rows, n, device="cuda", generator=g).bfloat16()
    return lhs, rhs, rhs.transpose(1, 2).contiguous(), gout


def skewed_sizes(rows, n_groups):
    """One group holds half the rows, the others share the rest."""
    sizes = [rows // 2] + [rows // (2 * (n_groups - 1))] * (n_groups - 2)
    return sizes + [rows - sum(sizes)]


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", type=Path, help="another gmm.cu to time")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from chip_smoke import cuda_ms, phase_device, ptxas_usage, rel_err
    from bagua_tpu_torch.ops import _build, gmm as gm

    print(phase_device(), flush=True)   # the card's name and power limit
    out_dir = _build.BUILD_DIR / "gmm_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    final = (_build.CSRC / "gmm.cu").read_text()
    sources = {"final": final}
    for name, edits in VARIANTS.items():
        sources[name] = variant_source(final, edits)
    if args.baseline:
        sources["baseline"] = args.baseline.read_text()
    procs = {name: start_build(name, text, out_dir) for name, text in sources.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        usage = [u for u in ptxas_usage(log) if "f32" not in u]
        slow = sorted({ln.strip() for ln in log.splitlines() if "Performance Loss" in ln})
        print(f"{name}: " + "; ".join(usage) + "".join(f"; {w}" for w in slow), flush=True)
        libs[name] = bind(out_dir / f"{name}.so")

    g = torch.Generator(device="cuda").manual_seed(0)
    # against the plain versions: a ragged case, and one group of more than
    # a chunk (K7b's hand-off between chunks)
    for rows, m, n, sizes in ((300, 128, 256, [1, 0, 170, 100]),
                              (24576, 256, 512, [20000, 1000, 0, 3576])):
        lhs, rhs, rhs_t, gout = inputs(rows, m, n, len(sizes), g)
        sz = torch.tensor(sizes, dtype=torch.int32, device="cuda")
        want = {"k7a": gm.grouped_matmul_plain(lhs, rhs, sz),
                "k7a_t": gm.grouped_matmul_plain(lhs, rhs_t, sz, True),
                "k7b": gm.grouped_matmul_drhs_plain(lhs, gout, sz, len(sizes))}
        for name, lib in libs.items():
            fns, got = launchers(lib, lhs, rhs, rhs_t, gout, sz)
            if any(fn() for fn in fns.values()):
                raise SystemExit(f"{name}: launch failed")
            torch.cuda.synchronize()
            errs = {k: round(rel_err(got[k], want[k]), 6) for k in want}
            print(f"{name}: against plain (rows {rows}, ({m}, {n}), {sizes}) {errs}", flush=True)
            if max(errs["k7a"], errs["k7a_t"]) > 1e-2 or errs["k7b"] > 1e-4:
                raise SystemExit(f"{name} disagrees with the plain versions")

    order = list(libs) + list(libs)[::-1]
    for label, sizes in (("balanced", [ROWS // GROUPS] * GROUPS),
                         ("skewed", skewed_sizes(ROWS, GROUPS)), ("routed", ROUTED)):
        sz = torch.tensor(sizes, dtype=torch.int32, device="cuda")
        offs = torch.cumsum(sz, 0, dtype=torch.int32)
        for m, n in SHAPES:
            lhs, rhs, rhs_t, gout = inputs(ROWS, m, n, GROUPS, g)
            times = {name: {k: [] for k in ("k7a", "k7a_t", "k7b")} for name in libs}
            lib_ms = [cuda_ms(lambda: torch._grouped_mm(lhs, rhs, offs=offs))]
            for name in order:
                fns, _ = launchers(libs[name], lhs, rhs, rhs_t, gout, sz)
                for k, fn in fns.items():
                    times[name][k].append(cuda_ms(fn))
            lib_ms.append(cuda_ms(lambda: torch._grouped_mm(lhs, rhs, offs=offs)))
            for k in ("k7a", "k7a_t", "k7b"):
                print(f"{label} {sizes[:2]}... ({m}, {n}) {k} ms hot, each run twice in the "
                      f"order {order}: " + "; ".join(
                          f"{name} {statistics.fmean(t[k]):.4f} {t[k]}"
                          for name, t in times.items())
                      + (f"; torch._grouped_mm {statistics.fmean(lib_ms):.4f} {lib_ms} "
                         f"(first and last)" if k == "k7a" else ""), flush=True)


if __name__ == "__main__":
    main()
