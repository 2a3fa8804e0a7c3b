"""Time the flash backward kernels against variants of their source, in turns.

    python3 scripts/torch_flash_variants.py [--baseline OTHER.cu]

Builds ``bagua_tpu_torch/ops/csrc/flash_attention.cu`` as it is and as each
variant of ``VARIANTS`` (the same file with a few lines replaced: the design
choices the source note argues for), plus, with ``--baseline``, another
version of the file (for example the parent commit's, unpacked with ``git
archive`` into a directory ``.gitignore`` lists).  Each build's registers and
spills per kernel are printed; each build's dK/dV and dQ are held against
the plain versions (bf16, 2e-2) at a ragged length, then timed hot at every
slice's shape in the order A B ... B A, so that two versions are compared on
one card in one call.  Needs a CUDA card and ``nvcc``.
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

# name -> [(text in the source, replacement), ...]
_PRODUCER_WARP = [
    ("constexpr int kBwdThreads = kConsumers + 128;", "constexpr int kBwdThreads = kConsumers + 32;"),
    ('    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\\n" ::"n"(kProducerRegs));\n', ""),
    ('  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\\n" ::"n"(kConsumerRegs));\n', ""),
]
VARIANTS = {
    # one producer warp beside the consumers, no register hand-over
    "producer_warp": _PRODUCER_WARP,
    # the same at two blocks an SM (96 registers a thread)
    "two_blocks": _PRODUCER_WARP + [("__launch_bounds__(kBwdThreads, 1)",
                                     "__launch_bounds__(kBwdThreads, 2)")],
}
SHAPES = [(32, 4096, 64), (64, 4096, 64), (128, 384, 64), (4, 4096, 128)]


def build(name, source, out_dir):
    from bagua_tpu_torch.ops import _build

    src = out_dir / f"{name}.cu"
    src.write_text(source)
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                           str(out_dir / f"{name}.so"), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def bind(path):
    from bagua_tpu_torch.ops import flash_attention as fa

    lib = ctypes.CDLL(str(path))
    for fn, argtypes in fa._SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def backward(lib, q, k, v, do, lse, delta):
    bh, s, d = q.shape
    dk, dv, dq = (torch.empty_like(q) for _ in range(3))
    stream = torch.cuda.current_stream().cuda_stream
    p = [t.data_ptr() for t in (q, k, v, do, lse, delta)]
    dkv = lambda: lib.bagua_flash_bwd_dkv(*p, dk.data_ptr(), dv.data_ptr(), bh, s, d, 1, 1, stream)
    dqf = lambda: lib.bagua_flash_bwd_dq(*p, dq.data_ptr(), bh, s, d, 1, 1, stream)
    return dkv, dqf, (dk, dv, dq)


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
        text = final
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} is not in the source")
            text = text.replace(old, new)
        sources[name] = text
    if args.baseline:
        sources["baseline"] = args.baseline.read_text()
    libs = {}
    for name, text in sources.items():
        log = build(name, text, out_dir)
        usage = [u for u in ptxas_usage(log) if "dkv" in u or "dq" in u]
        print(f"{name}: " + "; ".join(usage), flush=True)
        libs[name] = bind(out_dir / f"{name}.so")

    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(3, 1000, 64, device="cuda", dtype=torch.bfloat16, generator=g)
                   for _ in range(4))
    po, plse = fa.fwd_plain(q, k, v, True)
    delta = (do.float() * po.float()).sum(-1)
    want = (*fa.dkv_plain(q, k, v, do, plse, delta, True),
            fa.dq_plain(q, k, v, do, plse, delta, True))
    for name, lib in libs.items():
        dkv, dqf, got = backward(lib, q, k, v, do, plse, delta)
        if dkv() or dqf():
            raise SystemExit(f"{name}: launch failed")
        torch.cuda.synchronize()
        errs = [rel_err(a, b) for a, b in zip(got, want)]
        print(f"{name}: dk, dv, dq against plain (b·h 3, s 1000, causal) {errs}", flush=True)
        if max(errs) > 2e-2:
            raise SystemExit(f"{name} disagrees with the plain versions")

    order = list(libs) + list(libs)[::-1]
    for bh, s, d in SHAPES:
        q, k, v, do = (torch.randn(bh, s, d, device="cuda", dtype=torch.bfloat16, generator=g)
                       for _ in range(4))
        o, lse = fa.flash_fwd(q, k, v, True)
        delta = (do.float() * o.float()).sum(-1)
        times = {name: ([], []) for name in libs}
        for name in order:
            dkv, dqf, _ = backward(libs[name], q, k, v, do, lse, delta)
            times[name][0].append(cuda_ms(dkv))
            times[name][1].append(cuda_ms(dqf))
        print(f"b·h {bh} s {s} d {d} causal, ms hot (dK/dV; dQ), each run twice in the "
              f"order {order}: " + "; ".join(
                  f"{n} {statistics.fmean(a):.4f} {a}; {statistics.fmean(b):.4f} {b}"
                  for n, (a, b) in times.items()), flush=True)


if __name__ == "__main__":
    main()
