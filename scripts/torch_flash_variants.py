"""Time the flash kernels against variants of their source, in turns.

    python3 scripts/torch_flash_variants.py [--baseline OTHER.cu]

Builds ``bagua_tpu_torch/ops/csrc/flash_attention.cu`` as it is and as each
variant of ``VARIANTS`` (the same file with a few lines replaced: the two
design choices the source note says were settled by timing), plus, with ``--baseline``, another
version of the file (for example the parent commit's, unpacked with ``git
archive`` into a directory ``.gitignore`` lists); one ``nvcc`` each, all
started together.  Each build's registers and spills per kernel are printed;
each build's forward (o and lse), dK/dV and dQ are held against the plain
versions (bf16, 2e-2) at a ragged length and both head dims, then timed hot at
every slice's shape in the order A B ... B A, so that two versions are
compared on one card in one call, with PyTorch's fused attention forward
(SDPA) timed first and last as the forward's yardstick.  Needs a CUDA card
and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

_KEYS = "constexpr int kFwdKeys = D == 256 ? 64 : 128;"
# the forward's loop, by its first line and the line after it
_FWD_LOOP = ("  // tile it: S = Q K^T is issued before", "  // O / l and lse")
# the plain order: round it issues O += P V of tile it - 1 and S of tile it
# and waits for both, so the softmax overlaps no product of its own
# warpgroup
_PLAIN_ORDER = """\
  for (int it = 0; it <= ntiles; ++it) {
    const int st = it % S, prev = (it + S - 1) % S;
    const bool pv = it >= 1 && it <= own, qk = it < own;
    if (it < ntiles) {
      mbar_wait(&sm.full[st], (it / S) & 1);
      __syncwarp();
    }
    if (pv) issue_pv<T, D, KEYS>(o_acc, pf, sm.v[prev]);
    if (qk) issue_qk<T, D, KEYS>(sc, sm.q, wg, sm.k[st]);
    wgmma_wait<0>();
    if (pv) {
      reg_fence(o_acc);
#pragma unroll
      for (int kk = 0; kk < KEYS / 16; ++kk) reg_fence(pf[kk]);
    }
    if (it > 0) mbar_arrive(&sm.empty[prev]);
    if (qk) {
      reg_fence(sc);
      softmax(sc, m, l, corr, it * KEYS, qw, row_lo, s, causal, tq, scale_log2);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o_acc[i] *= corr[(i % 4) / 2];
#pragma unroll
      for (int kk = 0; kk < KEYS / 16; ++kk) frag_a<T>(pf[kk], sc, kk);
    }
  }

"""
# name -> [(text in the source, or its first line and the line after it;
# replacement), ...]: the two choices of the forward's design that were
# settled by timing (PERF.md has the times of these and of the variants
# timed once and dropped)
VARIANTS = {
    # the forward's key tile at 64 keys (S an m64n64 product) at every D
    "keys_64": [(_KEYS, "constexpr int kFwdKeys = 64;")],
    "plain_order": [(_FWD_LOOP, _PLAIN_ORDER)],
}


def variant_source(text, edits):
    """``text`` with each edit of a variant made; an edit's old text may be
    given by its first line and the line after it."""
    for old, new in edits:
        if isinstance(old, tuple):
            if old[0] not in text or old[1] not in text:
                raise SystemExit(f"{old!r} is not in the source")
            old = text[text.index(old[0]):text.index(old[1])]
        if old not in text:
            raise SystemExit(f"{old!r} is not in the source")
        text = text.replace(old, new)
    return text


SHAPES = [(32, 4096, 64), (64, 4096, 64), (128, 384, 64), (4, 4096, 128)]
KERNELS = ("fwd", "dkv", "dq")


def start_build(name, source, out_dir):
    from bagua_tpu_torch.ops import _build

    src = out_dir / f"{name}.cu"
    src.write_text(source)
    return subprocess.Popen(_build.nvcc_command(src, out_dir / f"{name}.so"),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def bind(path, head_dim_arg):
    """The library at ``path``; a version without the head_dim argument
    (before the entry points padded heads) takes one int fewer."""
    from bagua_tpu_torch.ops import flash_attention as fa

    lib = ctypes.CDLL(str(path))
    for fn, argtypes in fa._SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes if head_dim_arg else argtypes[:-2] + argtypes[-1:]
        getattr(lib, fn).restype = ctypes.c_int
    lib.head_dim_arg = head_dim_arg
    return lib


def launchers(lib, q, k, v, do, lse, delta):
    """The three kernels of ``lib`` on one bf16 input, each a function
    returning its CUDA error code, and their outputs."""
    bh, s, d = q.shape
    o, dk, dv, dq = (torch.empty_like(q) for _ in range(4))
    lse_out = torch.empty_like(lse)
    stream = torch.cuda.current_stream().cuda_stream
    p = [t.data_ptr() for t in (q, k, v, do, lse, delta)]
    shape = (bh, s, d, d) if lib.head_dim_arg else (bh, s, d)   # ..., head_dim
    fns = {
        "fwd": lambda: lib.bagua_flash_fwd(*p[:3], o.data_ptr(), lse_out.data_ptr(),
                                           *shape, 1, 1, stream),
        "dkv": lambda: lib.bagua_flash_bwd_dkv(*p, dk.data_ptr(), dv.data_ptr(), *shape,
                                               1, 1, stream),
        "dq": lambda: lib.bagua_flash_bwd_dq(*p, dq.data_ptr(), *shape, 1, 1, stream),
    }
    return fns, {"o": o, "lse": lse_out, "dk": dk, "dv": dv, "dq": dq}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", type=Path, help="another flash_attention.cu to time")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from chip_smoke import cuda_ms, phase_device, ptxas_usage, rel_err
    from bagua_tpu_torch.ops import _build, flash_attention as fa

    print(phase_device(), flush=True)   # the card's name and power limit
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    final = (_build.CSRC / "flash_attention.cu").read_text()
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
        usage = [u for u in ptxas_usage(log) if "mma" in u]
        slow = sorted({ln.strip() for ln in log.splitlines() if "Performance Loss" in ln})
        print(f"{name}: " + "; ".join(usage) + "".join(f"; {w}" for w in slow), flush=True)
        libs[name] = bind(out_dir / f"{name}.so", "int head_dim, int dtype" in sources[name])

    g = torch.Generator(device="cuda").manual_seed(0)
    for d in (64, 128):
        q, k, v, do = (torch.randn(3, 1000, d, device="cuda", dtype=torch.bfloat16,
                                   generator=g) for _ in range(4))
        po, plse = fa.fwd_plain(q, k, v, True)
        delta = (do.float() * po.float()).sum(-1)
        want = {"o": po, "lse": plse, "dk": None, "dv": None,
                "dq": fa.dq_plain(q, k, v, do, plse, delta, True)}
        want["dk"], want["dv"] = fa.dkv_plain(q, k, v, do, plse, delta, True)
        for name, lib in libs.items():
            fns, got = launchers(lib, q, k, v, do, plse, delta)
            if any(fn() for fn in fns.values()):
                raise SystemExit(f"{name}: launch failed")
            torch.cuda.synchronize()
            errs = {n: round(rel_err(got[n], want[n]), 5) for n in want}
            print(f"{name}: against plain (b·h 3, s 1000, d {d}, causal) {errs}", flush=True)
            if max(errs.values()) > 2e-2:
                raise SystemExit(f"{name} disagrees with the plain versions")

    sdpa = torch.nn.functional.scaled_dot_product_attention
    order = list(libs) + list(libs)[::-1]
    for bh, s, d in SHAPES:
        q, k, v, do = (torch.randn(bh, s, d, device="cuda", dtype=torch.bfloat16, generator=g)
                       for _ in range(4))
        o, lse = fa.flash_fwd(q, k, v, True)
        delta = (do.float() * o.float()).sum(-1)
        q4, k4, v4 = (x.view(1, bh, s, d) for x in (q, k, v))
        times = {name: {kern: [] for kern in KERNELS} for name in libs}
        sdpa_ms = [cuda_ms(lambda: sdpa(q4, k4, v4, is_causal=True))]
        for name in order:
            fns, _ = launchers(libs[name], q, k, v, do, lse, delta)
            for kern in KERNELS:
                times[name][kern].append(cuda_ms(fns[kern]))
        sdpa_ms.append(cuda_ms(lambda: sdpa(q4, k4, v4, is_causal=True)))
        for kern in KERNELS:
            print(f"b·h {bh} s {s} d {d} causal, {kern} ms hot, each run twice in the order "
                  f"{order}: " + "; ".join(
                      f"{n} {statistics.fmean(t[kern]):.4f} {t[kern]}" for n, t in times.items())
                  + (f"; sdpa forward {statistics.fmean(sdpa_ms):.4f} {sdpa_ms} (first and last)"
                     if kern == "fwd" else ""), flush=True)


if __name__ == "__main__":
    main()
