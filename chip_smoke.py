"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. device: a CUDA card is required; prints its name and power limit.
2. build: compiles every ``bagua_tpu_torch/ops/csrc/*.cu`` with ``nvcc``.
3. kernels: each flash-attention kernel against its plain PyTorch version on
   the card (bf16 at every slice's training shape: b·h 32 and 64 at seq
   4096, BERT-Large's 128 at seq 384; a ragged bf16 length; f32; f16; heads
   of 32, 96 and 136, which the kernels widen to 64, 128 and 256, and of 256
   in bf16, f16 and f32); a head of 100 through ``flash_attention``, which
   pads it to 104 (forward and gradients against the same call on the CPU);
   every kernel at a ragged length beside a head of values near 1e4 (no read
   across heads) and twice on the same inputs (bitwise equal), at D = 64,
   128 and 256; the times of
   each kernel (hot and cold L2), its plain version and the PyTorch library
   call at slice 1's shape, the forward's and SDPA's forward at slice 2's and
   BERT-Large's shapes, and the port's whole backward (delta, dK/dV and dQ,
   as autograd runs them) against SDPA's backward; SDPA's forward and
   backward kernels are named from one profiler window each.
4. gmm kernels: each grouped-matmul kernel against its plain version at the
   MoE path's shapes (both (d, f) pairs; balanced, skewed and empty-group
   sizes), a small ragged case, one at widths that end inside a tile (64 and
   200), one in f32, f16 at the path's shapes, widths that are not multiples
   of 8 ((100, 200) and (200, 100)) through ``gmm``, which pads them; K7b
   twice on the same inputs, balanced and skewed (bitwise equal); each
   kernel's times per form, hot and cold, balanced and skewed, beside
   ``torch._grouped_mm``; and one MoE layer's forward and backward under
   ``torch.cuda.set_sync_debug_mode("error")``, so that a host sync on the
   MoE path fails the run.
5. codec kernels: the MinMaxUInt8 compress (K1) and decompress (K2) and the
   absmax (K3) kernels against their plain versions, payload bytes,
   sidecars and decoded values exactly equal: chunks of 128 KiB, 1 MiB,
   8 MiB, the path's bucket chunk (10 MiB / 2 ranks) and its embedding
   bucket's chunk, a ragged, a tiny, a constant, a ±inf and a NaN chunk, a
   bf16 input; their times against the plain versions at every size, and
   each kernel's time with a cold L2.
6. sign kernels: the 1-bit codec's compress (K4) and decompress (K5) against
   their plain versions, payload bytes and decoded values exactly equal, the
   scale within 1e-6 relative: chunks of 128 KiB, 1 MiB, 8 MiB, the main
   path's ring chunk (5 MiB), its whole 10 MiB bucket (the error-feedback
   step encodes a bucket as one chunk), its embedding bucket's chunk and the
   2 x 2 path's inter-node chunk, a ragged, a tiny, an all-zero, a ±inf and a
   NaN chunk, a bf16 input; their times hot and cold against the plain
   versions and against ``abs().sum(dim=1)``, K4's reduction half.
7. narrow, f16 and f32 shapes: the tiny SQuAD model of
   ``examples/squad_finetune.py`` (head_dim 32), in bf16 and in f16, takes
   one forward and backward on the card through the flash kernels (one launch
   of each a layer), its loss and gradients finite and its logits against
   the same model with the plain attention; an ``MoEMLP`` with d_model 64 in
   bf16, one with d_model 128 in f32 and one with d_model 128 in f16 each
   take one forward and backward through the gmm kernels, against the same
   layer with the dense reference gmm.
8. slice 1: the long-context TransformerLM (``bench_longctx``'s widths,
   random weights from a seed) trained for 10 steps by ``BaguaTrainer`` with
   ``GradientAllReduceAlgorithm`` over NCCL; losses must be finite and
   falling, every flash kernel must have launched ``n_layers * steps`` times,
   and the model's logits on a short input must agree with the plain
   attention.
9. slice 2: the dropless MoE TransformerLM of ``bench_moe_longseq`` (MoE in
   every odd layer, 8 experts, top-2) trained for 10 steps with Adam and the
   load-balancing loss; losses finite and falling, exact launch counts of
   the gmm and flash kernels, and the logits on a short input against the
   plain gmm and plain attention.
10. slice 3: compressed data parallelism at world size 2.  The script starts
   itself twice as worker processes, two ranks on the one card, whose
   collectives go over gloo through host memory (NCCL refuses two ranks on
   one device).  Each rank trains BERT-Large (``bench_bert``: 24 layers,
   seq 384, batch 8 per rank, AdamW 1e-4) for 10 steps with
   ``ByteGradAlgorithm``, then a 4-layer cut of it with
   ``GradientAllReduceAlgorithm`` and ``compress_intra`` ``int8`` and
   ``fp8_e4m3``, and with ``QAdamAlgorithm(warmup_steps=2, lr=1e-5)``; losses finite
   and falling, exact codec and flash launch counts, parameters bitwise
   equal on both ranks, and one ByteGrad bucket's reduction through the
   kernels equal byte for byte to the same collective through the plain
   codec.  Each run prints its step time, the bytes staged through the host
   and the time of a forward and backward alone.
11. slice 4, the 1-bit and top-k codecs with the error-feedback residual, two
   ranks as in slice 3: the main path is the README quick start with
   ``GradientAllReduceAlgorithm()`` and ``compress_intra="onebit_ef"`` on the
   full BERT-Large, AdamW 1e-4, 10 steps; then ``compress_intra="topk"`` on
   the 4-layer cut.  Launches exact (K4 = K5 = 3 x buckets x steps), the
   residual finite and nonzero, parameters bitwise equal on both ranks, and
   the error-feedback step of the largest bucket through the kernels against
   the plain codec (payload equal, residual within 1e-5 of the scale).
12. slice 4 at 2 x 2: four ranks of this script on the card, two nodes of two
   (``intra_size=2``), on the 4-layer cut: ``GradientAllReduceAlgorithm(
   hierarchical=True)`` with ``compress_inter="onebit_ef"`` (K4 = K5 = 3 x
   buckets x steps) and ``ByteGradAlgorithm()`` at its default two-level form
   (K1 = K2 = 2 x buckets x steps); the same checks.

The flash kernels are checked at every slice's shape (phase 3).  The line
before the last is a JSON object with one entry per kernel; the last line is
``{"ok": true, "device": {...}}``.  ``build_slice`` holds slices 1 and 2's
model, trainer and batch; ``scripts/torch_step_profile.py`` profiles the
same ones.
"""

from __future__ import annotations

import functools
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import torch

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12     # H100 SXM f32 rate outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 rate
SLEEP_CYCLES = 50_000_000  # about 25 ms at the H100's clock: longer than any timed enqueue
L2_FLUSH_BYTES = 256 * 1024 ** 2   # five times the H100's 50 MB L2

MAIN = dict(b=2, s=4096, h=16, d=64)
MOE = dict(b=8, s=4096, h=8, experts=8, k=2, d_model=512, d_ff=2048)
BERT = dict(b=8, s=384, h=16, d=64, cut_layers=4)   # bench_bert, per rank
#: examples/squad_finetune.py --tiny: head_dim 32, which the flash kernels widen to 64
SQUAD_TINY = dict(vocab_size=1024, d_model=128, n_heads=4, n_layers=4, d_ff=512,
                  max_seq_len=384)
CODEC_WORLD = 2
CODEC_BUCKET_BYTES = 10 * 1024 ** 2
STEPS = 10
# flash: bf16 and f16 round P and dS at other places than the plain versions
# (f16's ulp is an eighth of bf16's); f32 sums in another order
TOL = {torch.bfloat16: 2e-2, torch.float16: 5e-3, torch.float32: 1e-4}
# gmm, by the operands' dtype: a 16-bit product is summed in f32 and rounded
# once on both sides (one ulp: bf16 2^-8, f16 2^-11); an f32 product, and
# d_rhs (f32 on both sides), differ by summation order only
GMM_TOL = {torch.bfloat16: 1e-2, torch.float16: 2e-3, torch.float32: 1e-4}
GMM_DRHS_TOL = 1e-4
REPLACES = {
    "flash_fwd": "bagua_tpu/ops/flash_attention.py:119",
    "flash_bwd_dkv": "bagua_tpu/ops/flash_attention.py:274",
    "flash_bwd_dq": "bagua_tpu/ops/flash_attention.py:291",
    "grouped_matmul": "bagua_tpu/ops/gmm.py:95",
    "grouped_matmul_drhs": "bagua_tpu/ops/gmm.py:133",
    "compress_chunked": "bagua_tpu/compression/pallas_codec.py:158",
    "decompress_chunked": "bagua_tpu/compression/pallas_codec.py:515",
    "absmax_chunked": "bagua_tpu/compression/pallas_codec.py:276",
    "sign_compress_chunked": "bagua_tpu/compression/pallas_codec.py:409",
    "sign_decompress_chunked": "bagua_tpu/compression/pallas_codec.py:483",
}
#: K4's scale against its plain version: the same sum of |x| in another order
SIGN_RTOL = 1e-6
#: the same, over the main path's largest bucket encoded as one chunk (31.6 M
#: elements): two f32 sums of that many positive terms in different orders
#: (the pairwise bound alone is log2(n) 2^-24 = 1.5e-6 for each)
EF_BUCKET_RTOL = 1e-5
SOURCE = "bagua_tpu_torch/ops/csrc/flash_attention.cu"
GMM_SOURCE = "bagua_tpu_torch/ops/csrc/gmm.cu"
CODEC_SOURCE = "bagua_tpu_torch/ops/csrc/codec.cu"


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up.  A
    sleep kernel queued first holds the card while the host enqueues every
    call, so the launches run back to back and the events time the device,
    not the host's enqueue (longer than a small kernel's run)."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_cold(fn, reps: int = 10) -> float:
    """Mean device time of ``fn`` with a cold L2: before each call a write of
    ``L2_FLUSH_BYTES`` evicts its inputs, and two events around the call
    alone time it (behind a sleep kernel, as in :func:`cuda_ms`)."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(2)] for _ in range(reps)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.fmean(start.elapsed_time(end) for start, end in events)


def rel_err(got, want) -> float:
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def abs_err(got, want) -> float:
    d = (got.float() - want.float()).abs()
    return d.max().item() if d.numel() else 0.0


def phase_device():
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device available")
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    return card


def phase_build():
    from bagua_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"build: {sorted(logs)} in {time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        log(f"  {name}: " + "; ".join(ptxas_usage(text)))
        for warning in sorted({ln.strip() for ln in text.splitlines() if "Performance Loss" in ln}):
            log(f"  {name}: {warning}")


def ptxas_usage(text):
    """Each kernel's registers and spills from ``nvcc -Xptxas -v``'s output,
    as ``name<template args>: N registers, S spill bytes``."""
    out, kernel, spill = [], "?", "0"
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:   # the mangled name: <length><name>, then I<template args>E
            mangled = m.group(1)
            names = [(mangled[end - n:end], end) for end in
                     (k.end() for k in re.finditer("kernel", mangled))
                     for n in range(len("kernel"), end)
                     if mangled[:end - n].endswith(str(n)) and not mangled[end - n].isdigit()]
            kernel = names[-1][0] + _template_args(mangled, names[-1][1]) if names else mangled
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.append(f"{kernel}: {m.group(1)} registers, {spill} spill bytes")
            spill = "0"
    return out


def _template_args(mangled, i):
    """The template arguments that follow a kernel's name at ``i`` in its
    mangled name (``I`` ... ``E``), as ``<a,b>``; integers and bools by
    value, types by name."""
    if mangled[i:i + 1] != "I":
        return ""
    i, args = i + 1, []
    while i < len(mangled) and mangled[i] != "E":
        m = re.match(r"L[ib](\d+)E", mangled[i:])
        n = re.match(r"\d+", mangled[i:])
        if m:
            args.append(m.group(1))
            i += m.end()
        elif n:
            j = i + n.end()
            args.append(mangled[j:j + int(n.group())])
            i = j + int(n.group())
        else:
            args.append({"f": "float", "b": "bool", "i": "int"}.get(mangled[i], mangled[i]))
            i += 1
    return "<" + ",".join(args) + ">"


def _inputs(bh, s, d, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(bh, s, d, device="cuda", dtype=dtype, generator=g)
            for _ in range(4)]


def check_kernels(bh, s, d, dtype, causal, seed=0):
    """Every kernel against its plain version on one input; returns the
    inputs and the absolute errors by kernel."""
    from bagua_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _inputs(bh, s, d, dtype, seed)
    o, lse = fa.flash_fwd(q, k, v, causal)
    po, plse = fa.fwd_plain(q, k, v, causal)
    delta = (do.float() * po.float()).sum(dim=-1)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, plse, delta, causal)
    pdk, pdv = fa.dkv_plain(q, k, v, do, plse, delta, causal)
    dq = fa.flash_bwd_dq(q, k, v, do, plse, delta, causal)
    pdq = fa.dq_plain(q, k, v, do, plse, delta, causal)
    torch.cuda.synchronize()
    rel = {"o": rel_err(o, po), "lse": rel_err(lse, plse), "dk": rel_err(dk, pdk),
           "dv": rel_err(dv, pdv), "dq": rel_err(dq, pdq)}
    log(f"kernels bh={bh} s={s} d={d} {dtype} causal={causal}: "
        + ", ".join(f"{n} {e:.3g}" for n, e in rel.items()))
    bad = {n: e for n, e in rel.items() if not e <= TOL[dtype]}
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {bad} "
                             f"(tolerance {TOL[dtype]})")
    errs = {"flash_fwd": max(abs_err(o, po), abs_err(lse, plse)),
            "flash_bwd_dkv": max(abs_err(dk, pdk), abs_err(dv, pdv)),
            "flash_bwd_dq": abs_err(dq, pdq)}
    return (q, k, v, do, plse, delta), errs


def check_backward_edges():
    """The forward and backward kernels at a ragged length (100) with every
    row of the next head set to 1e4: the other heads' o, lse and gradients
    still match the plain versions (a tensor map over [bh * s, d] would fill
    a head's last tile with the next head's rows); and two launches on the
    same ordinary inputs give bitwise-equal o, lse, dK, dV and dQ (one block
    writes each output tile, in a fixed order)."""
    from bagua_tpu_torch.ops import flash_attention as fa

    def outputs(q, k, v, do, kernels):
        po, plse = fa.fwd_plain(q, k, v, True)
        delta = (do.float() * po.float()).sum(dim=-1)
        if kernels:
            return [*fa.flash_fwd(q, k, v, True),
                    *fa.flash_bwd_dkv(q, k, v, do, plse, delta, True),
                    fa.flash_bwd_dq(q, k, v, do, plse, delta, True)]
        return [po, plse, *fa.dkv_plain(q, k, v, do, plse, delta, True),
                fa.dq_plain(q, k, v, do, plse, delta, True)]

    for d in (32, 64, 128, 256):
        q, k, v, do = _inputs(3, 100, d, torch.bfloat16, seed=8)
        for x in (q, k, v, do):
            x[1] = 1e4
        got, want = outputs(q, k, v, do, True), outputs(q, k, v, do, False)
        rel = {n: max(rel_err(a[h], b[h]) for h in (0, 2))
               for n, a, b in zip(("o", "lse", "dk", "dv", "dq"), got, want)}
        inputs = _inputs(8, 1000, d, torch.bfloat16, seed=9)
        same_bits = all(torch.equal(a, b) for a, b in
                        zip(outputs(*inputs, True), outputs(*inputs, True)))
        torch.cuda.synchronize()
        log(f"forward and backward head boundary d={d} (s 100, head 1 at 1e4): heads 0 "
            f"and 2 " + ", ".join(f"{n} {e:.3g}" for n, e in rel.items())
            + f"; two launches (b·h 8, s 1000) bitwise equal: {same_bits}")
        if not (max(rel.values()) <= TOL[torch.bfloat16] and same_bits):
            raise AssertionError(f"flash kernels read across heads or are not "
                                 f"deterministic: {rel}, bitwise {same_bits}")


def check_padded_head():
    """A head of 100 through ``flash_attention``, which pads it to 104 on the
    card and passes the scale of 100: one launch of each kernel, and o and
    the gradients of q, k and v against the same call on the CPU, whose
    wrappers run the plain versions on the unpadded head (o within the
    kernels' tolerance, the gradients, two products deep, within twice it)."""
    from bagua_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(19)
    q, k, v, do = (torch.randn(2, 512, 4, 100, device="cuda", generator=g).bfloat16()
                   for _ in range(4))
    runs = []
    for device in ("cuda", "cpu"):
        leaves = [x.detach().to(device).requires_grad_() for x in (q, k, v)]
        fa.reset_launch_counts()
        out = fa.flash_attention(*leaves)
        out.backward(do.to(device))
        torch.cuda.synchronize()
        runs.append(([out.cpu(), *(x.grad.cpu() for x in leaves)],
                     [f.launches for f in fa.KERNELS]))
    (got, launches), (want, _) = runs
    rel = {n: rel_err(a, b) for n, a, b in zip(("o", "dq", "dk", "dv"), got, want)}
    log(f"head_dim 100 through flash_attention (padded to 104; b 2, s 512, 4 heads, bf16): "
        f"launches {launches}, against the CPU's plain versions "
        + ", ".join(f"{n} {e:.3g}" for n, e in rel.items()))
    tol = TOL[torch.bfloat16]
    if launches != [1, 1, 1] or rel["o"] > tol or max(rel.values()) > 2 * tol:
        raise AssertionError(f"padded head: launches {launches}, rel err {rel}")


def device_kernels(fn):
    """Names of the device kernels one call of ``fn`` runs (one profiler
    window), so that a yardstick's implementation is on record."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def bound(name, bh, s, d, dtype, causal):
    """Least time on the card: the larger of the matmul flops over the
    tensor-core peak and the bytes each input read once and each output
    written once over the memory rate."""
    pairs = bh * (s * (s + 1) // 2 if causal else s * s)
    matmuls = {"flash_fwd": 2, "flash_bwd_dkv": 4, "flash_bwd_dq": 3}[name]
    flops = 2 * d * pairs * matmuls
    item = torch.finfo(dtype).bits // 8
    mat, row = bh * s * d * item, bh * s * 4
    nbytes = {"flash_fwd": 4 * mat + row,          # q k v -> o, lse
              "flash_bwd_dkv": 6 * mat + 2 * row,  # q k v do lse delta -> dk dv
              "flash_bwd_dq": 5 * mat + 2 * row}[name]
    peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS   # f16's = bf16's
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_kernels():
    from bagua_tpu_torch.ops import flash_attention as fa

    b, s, h, d = MAIN["b"], MAIN["s"], MAIN["h"], MAIN["d"]
    bh = b * h
    check_kernels(bh, 1000, d, torch.bfloat16, True, seed=1)
    check_kernels(4, 512, d, torch.float32, True, seed=2)
    check_kernels(4, 512, 128, torch.float32, False, seed=3)
    check_kernels(4, 1000, 128, torch.bfloat16, True, seed=4)
    # heads the kernels widen: 32 to 64, 96 to 128, 136 to 256
    check_kernels(4, 1000, 32, torch.bfloat16, True, seed=10)
    check_kernels(4, 512, 32, torch.float32, True, seed=11)
    check_kernels(4, 384, 96, torch.bfloat16, False, seed=12)
    check_kernels(4, 384, 136, torch.bfloat16, False, seed=17)
    # f16, and heads of 256 (Gemma's), in every dtype
    check_kernels(4, 1000, 64, torch.float16, True, seed=14)
    check_kernels(4, 1000, 256, torch.float16, True, seed=15)
    check_kernels(4, 1000, 256, torch.bfloat16, True, seed=16)
    check_kernels(2, 256, 256, torch.float32, True, seed=18)
    check_padded_head()
    # slice 2's shape: b·h = 64 (batch 8 × 8 heads of 64) at its seq
    moe_inputs, errs_moe = check_kernels(MOE["b"] * MOE["h"], MOE["s"],
                                         MOE["d_model"] // MOE["h"], torch.bfloat16, True,
                                         seed=6)
    # slice 3's shape: BERT-Large, b·h = 128 (batch 8 × 16 heads of 64) at seq 384
    bert_inputs, errs_bert = check_kernels(BERT["b"] * BERT["h"], BERT["s"], BERT["d"],
                                           torch.bfloat16, True, seed=7)
    (q, k, v, do, lse, delta), errs = check_kernels(bh, s, d, torch.bfloat16, True)
    errs = {n: max(e, errs_moe[n], errs_bert[n]) for n, e in errs.items()}
    check_backward_edges()

    ms = {
        "flash_fwd": cuda_ms(lambda: fa.flash_fwd(q, k, v, True)),
        "flash_bwd_dkv": cuda_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, True)),
        "flash_bwd_dq": cuda_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, True)),
    }
    cold_ms = {
        "flash_fwd": cuda_ms_cold(lambda: fa.flash_fwd(q, k, v, True)),
        "flash_bwd_dkv": cuda_ms_cold(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, True)),
        "flash_bwd_dq": cuda_ms_cold(lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, True)),
    }
    # a head of 32 runs the kernels of width 64: its times beside d 64's
    qn, kn, vn, don = _inputs(bh, s, 32, torch.bfloat16, seed=13)
    on, lsen = fa.flash_fwd(qn, kn, vn, True)
    deltan = (don.float() * on.float()).sum(dim=-1)
    narrow = {
        "flash_fwd": cuda_ms(lambda: fa.flash_fwd(qn, kn, vn, True)),
        "flash_bwd_dkv": cuda_ms(lambda: fa.flash_bwd_dkv(qn, kn, vn, don, lsen, deltan, True)),
        "flash_bwd_dq": cuda_ms(lambda: fa.flash_bwd_dq(qn, kn, vn, don, lsen, deltan, True)),
    }
    log(f"narrow head bh={bh} s={s} d=32 bf16 causal (widened to 64): "
        + ", ".join(f"{n} {narrow[n]:.4f} ms (d 64 {ms[n]:.4f})" for n in ms))
    del qn, kn, vn, don, on, lsen, deltan
    # heads of 256 (the D = 256 layouts) and f16 at d 64: their times, at the
    # same tokens and the same b·h times head_dim as slice 1
    for dtype, bh_, d_ in ((torch.bfloat16, bh // 4, 256), (torch.float16, bh, d)):
        qw, kw, vw, dow = _inputs(bh_, s, d_, dtype, seed=20)
        ow, lsew = fa.flash_fwd(qw, kw, vw, True)
        deltaw = (dow.float() * ow.float()).sum(dim=-1)
        wide = {
            "flash_fwd": cuda_ms(lambda: fa.flash_fwd(qw, kw, vw, True)),
            "flash_bwd_dkv": cuda_ms(lambda: fa.flash_bwd_dkv(qw, kw, vw, dow, lsew, deltaw, True)),
            "flash_bwd_dq": cuda_ms(lambda: fa.flash_bwd_dq(qw, kw, vw, dow, lsew, deltaw, True)),
        }
        log(f"head bh={bh_} s={s} d={d_} {dtype} causal: "
            + ", ".join(f"{n} {t:.4f} ms (bound {bound(n, bh_, s, d_, dtype, True)[0]:.4f})"
                        for n, t in wide.items()))
        del qw, kw, vw, dow, ow, lsew, deltaw
    plain_ms = {
        "flash_fwd": cuda_ms(lambda: fa.fwd_plain(q, k, v, True), 3),
        "flash_bwd_dkv": cuda_ms(lambda: fa.dkv_plain(q, k, v, do, lse, delta, True), 3),
        "flash_bwd_dq": cuda_ms(lambda: fa.dq_plain(q, k, v, do, lse, delta, True), 3),
    }
    # the library yardstick, timed here only: PyTorch's fused attention on
    # the same [b, h, s, d] inputs (the port never calls it).  Its backward
    # computes dK, dV and dQ in one call, and its own row statistic (delta)
    # inside, so that one time stands against dK/dV and dQ together, on both
    # rows, and against the port's whole backward: delta, dK/dV and dQ as
    # autograd runs _FlashLse.backward
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4, do4 = (x.view(b, h, s, d) for x in (q, k, v, do))
    qg, kg, vg = (x.clone().requires_grad_() for x in (q4, k4, v4))
    sdpa_out = sdpa(qg, kg, vg, is_causal=True)   # one forward, built once
    sdpa_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        sdpa_out, (qg, kg, vg), do4, retain_graph=True))
    sdpa_kernels = device_kernels(lambda: torch.autograd.grad(
        sdpa_out, (qg, kg, vg), do4, retain_graph=True))
    qf, kf, vf = (x.clone().requires_grad_() for x in (q, k, v))
    port_out, _ = fa._FlashLse.apply(qf, kf, vf, True)
    port_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        port_out, (qf, kf, vf), do, retain_graph=True))
    log(f"whole backward bh={bh} s={s} d={d} bf16 causal: port (delta + dK/dV + dQ) "
        f"{port_bwd_ms:.4f} ms, sdpa {sdpa_bwd_ms:.4f} ms, port / sdpa "
        f"{port_bwd_ms / sdpa_bwd_ms:.3f}; sdpa backward kernels: {sdpa_kernels}")
    library = {"flash_fwd": cuda_ms(lambda: sdpa(q4, k4, v4, is_causal=True)),
               "flash_bwd_dkv": sdpa_bwd_ms, "flash_bwd_dq": sdpa_bwd_ms}
    log(f"sdpa forward kernels: "
        f"{device_kernels(lambda: sdpa(q4, k4, v4, is_causal=True))}")
    # the forward at slice 2's and BERT-Large's shapes, beside SDPA's forward
    for label, (q_, k_, v_, *_) in (("slice 2", moe_inputs), ("BERT-Large", bert_inputs)):
        bh_, s_, d_ = q_.shape
        q4_, k4_, v4_ = (x.view(1, bh_, s_, d_) for x in (q_, k_, v_))
        fwd_ms = cuda_ms(lambda: fa.flash_fwd(q_, k_, v_, True))
        sdpa_ms = cuda_ms(lambda: sdpa(q4_, k4_, v4_, is_causal=True))
        log(f"forward {label} bh={bh_} s={s_} d={d_} bf16 causal: flash_fwd {fwd_ms:.4f} ms, "
            f"cold {cuda_ms_cold(lambda: fa.flash_fwd(q_, k_, v_, True)):.4f} ms, sdpa "
            f"forward {sdpa_ms:.4f} ms, flash / sdpa {fwd_ms / sdpa_ms:.3f}, bound "
            f"{bound('flash_fwd', bh_, s_, d_, torch.bfloat16, True)[0]:.4f} ms")

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(qg, kg, vg, is_causal=True), (qg, kg, vg), do4)

    sdpa_train_ms = cuda_ms(sdpa_fwd_bwd)
    flash_train_ms = ms["flash_fwd"] + ms["flash_bwd_dkv"] + ms["flash_bwd_dq"]
    log(f"timing bh={bh} s={s} d={d} bf16 causal: kernels {ms}, cold {cold_ms}, "
        f"plain {plain_ms}, "
        f"sdpa fwd {library['flash_fwd']:.4f} ms, sdpa bwd alone {sdpa_bwd_ms:.4f} ms "
        f"(flash dkv+dq {ms['flash_bwd_dkv'] + ms['flash_bwd_dq']:.4f} ms), sdpa "
        f"fwd+bwd {sdpa_train_ms:.4f} ms, flash fwd+dkv+dq {flash_train_ms:.4f} ms")
    rows = {}
    for name in ms:
        b_ms, b_by = bound(name, bh, s, d, torch.bfloat16, True)
        rows[name] = {"name": name, "route": "cuda", "source": SOURCE,
                      "replaces": REPLACES[name], "launches": None,
                      "max_abs_err": errs[name], "ms": ms[name],
                      "plain_ms": plain_ms[name], "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": library[name]}
    return rows


def slice_model(name, attn_fn=None, gmm_fn=None):
    """The model of slice ``name``, weights from seed 0: ``"longctx"`` the
    long-context LM of ``bench_longctx``, ``"moe"`` the dropless MoE LM of
    ``bench_moe_longseq`` (a ``MoEMLP`` in every odd layer).  ``attn_fn`` and
    ``gmm_fn`` replace the attention and the grouped matmul (for example with
    their plain versions)."""
    from bagua_tpu_torch.model_parallel.moe import MoEMLP
    from bagua_tpu_torch.models.transformer import TransformerConfig, TransformerLM

    if name == "moe":
        cfg = TransformerConfig(vocab_size=32768, d_model=MOE["d_model"], n_heads=MOE["h"],
                                n_layers=4, d_ff=MOE["d_ff"], max_seq_len=MOE["s"])
        moe = lambda: MoEMLP(MOE["experts"], cfg.d_ff, d_model=cfg.d_model, k=MOE["k"],
                             dropless=True, gmm_fn=gmm_fn)
        factory = lambda i: moe if i % 2 == 1 else None
    else:
        cfg = TransformerConfig(vocab_size=32768, d_model=MAIN["h"] * MAIN["d"],
                                n_heads=MAIN["h"], n_layers=4, d_ff=4096,
                                max_seq_len=MAIN["s"])
        factory = None
    return TransformerLM(cfg, seed=0, attn_fn=attn_fn, mlp_factory=factory)


def build_slice(name):
    """Slice ``name``'s model, its ``BaguaTrainer`` (GradientAllReduce; AdamW
    for ``"longctx"``, Adam and the load-balancing loss for ``"moe"``), the
    initial state and one fixed random batch (seed 1).  Needs the process
    group."""
    import bagua_tpu_torch as bt

    model = slice_model(name)
    if name == "moe":
        loss_fn, batch_size = bt.moe_lm_loss_fn(aux_loss_weight=0.01), MOE["b"]
        opt = functools.partial(torch.optim.Adam, lr=1e-4)
    else:
        loss_fn, batch_size = bt.lm_loss_fn, MAIN["b"]
        opt = functools.partial(torch.optim.AdamW, lr=1e-4, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=1e-4)
    trainer = bt.BaguaTrainer(loss_fn, opt, bt.GradientAllReduceAlgorithm(hierarchical=False))
    state = trainer.init(model)
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, model.cfg.vocab_size, (batch_size, model.cfg.max_seq_len + 1),
                           device="cuda", generator=g)
    return model, trainer, state, trainer.shard_batch({"tokens": tokens})


def train_steps(trainer, state, batch, tokens_per_step, modules):
    """``STEPS`` training steps with every launch count of ``modules`` set to
    0 just before and read just after; returns the losses, the launches by
    kernel, the step statistics and the last state."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in modules:
        mod.reset_launch_counts()
    losses, stamps = [], [time.perf_counter()]
    for _ in range(STEPS):
        state, loss = trainer.train_step(state, batch)
        losses.append(loss.item())   # synchronizes
        stamps.append(time.perf_counter())
    launches = {k.__name__: k.launches for mod in modules for k in mod.KERNELS}
    # step 1 pays the allocator's and the libraries' warm-up; the rest is
    # one window, so a slow step in it counts in full
    window_s = stamps[-1] - stamps[1]
    stats = {
        "step_ms": window_s / (STEPS - 1) * 1e3,
        "tokens_s": (STEPS - 1) * tokens_per_step / window_s,
        "median_ms": statistics.median(b - a for a, b in zip(stamps[1:], stamps[2:])) * 1e3,
        "first_ms": (stamps[1] - stamps[0]) * 1e3,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    return losses, launches, stats, state


def log_steps(name, losses, launches, st):
    log(f"{name} losses: {losses}")
    log(f"{name}: step {st['step_ms']:.3f} ms (steps 2-{STEPS} as one window; median "
        f"step {st['median_ms']:.3f} ms; first {st['first_ms']:.3f} ms), "
        f"{st['tokens_s']:.1f} tokens/s, peak memory {st['peak_gb']:.3f} GB, "
        f"launches {launches}")


def phase_slice():
    """The port's first path: BaguaTrainer over the long-context LM."""
    import bagua_tpu_torch as bt
    from bagua_tpu_torch.ops import flash_attention as fa

    bt.init_process_group()
    model, trainer, state, batch = build_slice("longctx")
    cfg, tokens = model.cfg, batch["tokens"]
    n_params = sum(p.numel() for p in model.parameters())
    log(f"slice: {n_params} params in {len(trainer.plan.buckets)} buckets, "
        f"world {trainer.world_size} over {torch.distributed.get_backend()}")

    losses, launches, st, _ = train_steps(trainer, state, batch,
                                          MAIN["b"] * cfg.max_seq_len, [fa])
    log_steps("slice", losses, launches, st)
    want = cfg.n_layers * STEPS
    if any(n != want for n in launches.values()):
        raise AssertionError(f"kernel launches {launches}, expected {want} each")

    # the model's logits on a short input against the plain attention path
    plain = slice_model("longctx", attn_fn=lambda q, k, v, dtype:
                        fa.reference_attention(q, k, v, dtype))
    plain.load_state_dict(model.state_dict())
    with torch.no_grad():
        short = tokens[:1, :512]
        got, want_logits = model(short), plain(short)
    err = rel_err(got, want_logits)
    log(f"slice logits vs plain attention (seq 512): rel err {err:.3g}")
    if not (torch.isfinite(got).all() and got.shape == (1, 512, cfg.vocab_size)
            and err <= 5e-2):
        raise AssertionError(f"logits disagree with the plain path: {err}")
    return launches


# ---------------------------------------------------------------------------
# slice 2: dropless MoE, the grouped-matmul kernels
# ---------------------------------------------------------------------------


def _gmm_inputs(rows, d, f, groups, seed, dtype=torch.bfloat16):
    g = torch.Generator(device="cuda").manual_seed(seed)
    lhs = torch.randn(rows, d, device="cuda", generator=g).to(dtype)
    rhs = (torch.randn(groups, d, f, device="cuda", generator=g) / math.sqrt(d)).to(dtype)
    gout = torch.randn(rows, f, device="cuda", generator=g).to(dtype)
    return lhs, rhs, gout


def check_gmm(lhs, rhs, gout, sizes, label):
    """Both gmm kernels (K7a also in its transposed-rhs d_lhs form) against
    their plain versions on one input; returns the absolute errors."""
    from bagua_tpu_torch.ops import gmm as gm

    n = rhs.shape[0]
    sizes = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    got = {"grouped_matmul": gm.grouped_matmul(lhs, rhs, sizes),
           "grouped_matmul_dlhs": gm.grouped_matmul(gout, rhs, sizes, transpose_rhs=True),
           "grouped_matmul_drhs": gm.grouped_matmul_drhs(lhs, gout, sizes, n)}
    want = {"grouped_matmul": gm.grouped_matmul_plain(lhs, rhs, sizes),
            "grouped_matmul_dlhs": gm.grouped_matmul_plain(gout, rhs, sizes, True),
            "grouped_matmul_drhs": gm.grouped_matmul_drhs_plain(lhs, gout, sizes, n)}
    torch.cuda.synchronize()
    rel = {k: rel_err(got[k], want[k]) for k in got}
    log(f"gmm {label}: " + ", ".join(f"{k} {e:.3g}" for k, e in rel.items()))
    tol = {k: GMM_DRHS_TOL if k == "grouped_matmul_drhs" else GMM_TOL[lhs.dtype] for k in rel}
    bad = {k: e for k, e in rel.items() if not e <= tol[k]}
    if bad:
        raise AssertionError(f"gmm kernel disagrees with its plain version: {bad} "
                             f"(tolerance {tol})")
    errs = {k: abs_err(got[k], want[k]) for k in got}
    return {"grouped_matmul": max(errs["grouped_matmul"], errs["grouped_matmul_dlhs"]),
            "grouped_matmul_drhs": errs["grouped_matmul_drhs"]}


def gmm_bound(name, rows, m, n, groups):
    """Least time on the card of one gmm launch over ``rows`` grouped rows:
    2 rows m n flops over the bf16 tensor-core peak against the bytes (each
    input read once, each output written once) over the memory rate."""
    flops = 2 * rows * m * n
    if name == "grouped_matmul":   # lhs [rows, m], rhs [G, m, n] -> [rows, n] bf16
        nbytes = 2 * (rows * m + groups * m * n + rows * n)
    else:                          # lhs [rows, m], gout [rows, n] -> [G, m, n] f32
        nbytes = 2 * (rows * m + rows * n) + 4 * groups * m * n
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_moe_no_sync():
    """One MoE layer's forward and backward at the path's shapes with host
    syncs turned into errors."""
    from bagua_tpu_torch.model_parallel.moe import MoEMLP

    layer = MoEMLP(MOE["experts"], MOE["d_ff"], d_model=MOE["d_model"], k=MOE["k"],
                   dropless=True).cuda()
    g = torch.Generator(device="cuda").manual_seed(5)
    shape = (MOE["b"], MOE["s"], MOE["d_model"])
    x = torch.randn(shape, device="cuda", generator=g).bfloat16().requires_grad_()
    gy = torch.randn(shape, device="cuda", generator=g).bfloat16()
    layer(x).backward(gy)            # warm-up: library loads, allocator
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        layer(x).backward(gy)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("gmm: one MoE layer's forward and backward ran under "
        "set_sync_debug_mode('error') with no host sync")


def check_gmm_padded(d, f, dtype, seed):
    """A product whose d and f are not multiples of 8 through ``gmm``, which
    pads its operands (one K7a launch forward, one K7a and one K7b backward),
    against the plain versions on the unpadded operands: output and
    gradients within the product's tolerance."""
    from bagua_tpu_torch.ops import gmm as gm

    lhs, rhs, gout = _gmm_inputs(300, d, f, 3, seed=seed, dtype=dtype)
    sizes = torch.tensor([120, 0, 150], dtype=torch.int32, device="cuda")
    runs = []
    for fn in (gm.gmm, gm.grouped_matmul_plain):
        a, b = lhs.clone().requires_grad_(), rhs.clone().requires_grad_()
        gm.reset_launch_counts()
        out = fn(a, b, sizes)
        out.backward(gout)
        torch.cuda.synchronize()
        runs.append(([out, a.grad, b.grad], [k.launches for k in gm.KERNELS]))
    (got, launches), (want, _) = runs
    rel = {n: rel_err(x, y) for n, x, y in zip(("out", "d_lhs", "d_rhs"), got, want)}
    tol = GMM_TOL[dtype]
    log(f"gmm ({d}, {f}) {dtype} through gmm (padded to multiples of 8): launches "
        f"{launches}, " + ", ".join(f"{n} {e:.3g}" for n, e in rel.items()))
    if launches != [2, 1] or max(rel.values()) > tol or got[0].shape != (300, f):
        raise AssertionError(f"padded gmm ({d}, {f}): launches {launches}, rel err {rel}")


def phase_gmm_kernels():
    from bagua_tpu_torch.ops import gmm as gm

    rows, G = MOE["b"] * MOE["s"] * MOE["k"], MOE["experts"]
    d, f = MOE["d_model"], MOE["d_ff"]
    balanced = [rows // G] * G
    skewed = [rows // 2] + [rows // (2 * (G - 1))] * (G - 2)
    skewed.append(rows - sum(skewed))             # one group holds half the rows
    empty = [0, rows // 2, 0, rows // 4, rows // 4, 0, 0, 0]
    check_gmm(*_gmm_inputs(300, 128, 256, 4, seed=9), [1, 0, 170, 100], "ragged 300 rows")
    check_gmm(*_gmm_inputs(300, 64, 200, 4, seed=10), [1, 0, 170, 100],
              "ragged 300 rows (64, 200)")
    check_gmm(*_gmm_inputs(300, 200, 64, 4, seed=11, dtype=torch.float32), [1, 0, 170, 100],
              "ragged 300 rows (200, 64) f32")
    check_gmm_padded(100, 200, torch.bfloat16, seed=12)
    check_gmm_padded(200, 100, torch.float16, seed=13)
    errs = {}
    for m, n in ((d, f), (f, d)):
        inputs = _gmm_inputs(rows, m, n, G, seed=m)
        for label, sizes in (("skewed", skewed), ("empty groups", empty),
                             ("balanced", balanced)):
            e = check_gmm(*inputs, sizes, f"rows {rows} ({m}, {n}) {label}")
            for k, v in e.items():
                errs[k] = max(errs.get(k, 0.0), v)
    check_gmm(*_gmm_inputs(rows, d, f, G, seed=14, dtype=torch.float16), skewed,
              f"rows {rows} ({d}, {f}) skewed f16")
    # K7b sums a group of more than one chunk in chunk order: two launches on
    # the same inputs are bitwise equal
    lhs, _, gout = _gmm_inputs(rows, d, f, G, seed=15)
    same_bits = {}
    for label, sizes in (("balanced", balanced), ("skewed", skewed)):
        sz = torch.tensor(sizes, dtype=torch.int32, device="cuda")
        first = gm.grouped_matmul_drhs(lhs, gout, sz, G)
        second = gm.grouped_matmul_drhs(lhs, gout, sz, G)
        torch.cuda.synchronize()
        same_bits[label] = torch.equal(first, second)
    log(f"gmm: two grouped_matmul_drhs launches on the same inputs bitwise equal: {same_bits}")
    if not all(same_bits.values()):
        raise AssertionError(f"grouped_matmul_drhs is not deterministic: {same_bits}")
    del lhs, gout, first, second

    # times at the path's shapes: the four K7a launches of a MoE layer's
    # step ((d, f) and (f, d), each plain and transposed) and its two K7b
    # launches, balanced (hot and cold) and skewed (hot)
    ms, cold_ms, plain_ms, library, bounds, refused = {}, {}, {}, {}, {}, []
    names = ("grouped_matmul", "grouped_matmul_drhs")
    for name in names:
        ms[name], cold_ms[name], plain_ms[name], library[name], bounds[name] = [], [], [], [], []
    sizes = torch.tensor(balanced, dtype=torch.int32, device="cuda")
    sk = torch.tensor(skewed, dtype=torch.int32, device="cuda")
    offs = torch.cumsum(sizes, 0, dtype=torch.int32)
    for m, n in ((d, f), (f, d)):
        lhs, rhs, gout = _gmm_inputs(rows, m, n, G, seed=m)
        rhs_t = rhs.transpose(1, 2).contiguous()   # [G, n, m]: d_lhs of [rows, n]
        variants = {
            "grouped_matmul": [
                ("plain rhs", lambda sz: gm.grouped_matmul(lhs, rhs, sz),
                 lambda: gm.grouped_matmul_plain(lhs, rhs, sizes),
                 lambda: torch._grouped_mm(lhs, rhs, offs=offs)),
                ("transposed rhs", lambda sz: gm.grouped_matmul(lhs, rhs_t, sz, transpose_rhs=True),
                 lambda: gm.grouped_matmul_plain(lhs, rhs_t, sizes, True),
                 lambda: torch._grouped_mm(lhs, rhs_t.transpose(1, 2), offs=offs)),
            ],
            "grouped_matmul_drhs": [
                ("", lambda sz: gm.grouped_matmul_drhs(lhs, gout, sz, G),
                 lambda: gm.grouped_matmul_drhs_plain(lhs, gout, sizes, G),
                 lambda: torch._grouped_mm(lhs.t(), gout, offs=offs)),
            ],
        }
        for name, runs in variants.items():
            for form, kernel, plain, lib in runs:
                hot, cold = cuda_ms(lambda: kernel(sizes)), cuda_ms_cold(lambda: kernel(sizes))
                skewed_ms = cuda_ms(lambda: kernel(sk))
                ms[name].append(hot)
                cold_ms[name].append(cold)
                plain_ms[name].append(cuda_ms(plain, 3))
                try:   # the yardstick only: a refusal is recorded, not fatal
                    library[name].append(cuda_ms(lib))
                except (RuntimeError, AttributeError, TypeError) as e:
                    library[name].append(None)
                    refused.append(f"{name} {(m, n)}: {str(e).splitlines()[0]}")
                bounds[name].append(gmm_bound(name, rows, m, n, G))
                lib_ms = library[name][-1]
                log(f"gmm timing {name} {form} ({m}, {n}): balanced {hot:.4f} ms hot, "
                    f"{cold:.4f} cold; skewed {skewed_ms:.4f} hot ({skewed_ms / hot:.3f}x); "
                    f"plain {plain_ms[name][-1]:.4f}; torch._grouped_mm "
                    + (f"{lib_ms:.4f}" if lib_ms is not None else "refused")
                    + f"; bound {bounds[name][-1][0]:.4f}")
    # f32 operands run the FMA kernels, f16 the tensor cores: their times at
    # the path's first shape
    for dtype in (torch.float32, torch.float16):
        lhs, rhs, gout = _gmm_inputs(rows, d, f, G, seed=2, dtype=dtype)
        log(f"gmm {dtype} rows {rows} ({d}, {f}) balanced: grouped_matmul "
            f"{cuda_ms(lambda: gm.grouped_matmul(lhs, rhs, sizes)):.4f} ms, grouped_matmul_drhs "
            f"{cuda_ms(lambda: gm.grouped_matmul_drhs(lhs, gout, sizes, G)):.4f} ms (bf16 "
            f"{ms['grouped_matmul'][0]:.4f} and {ms['grouped_matmul_drhs'][0]:.4f}), bound "
            f"{2 * rows * d * f / (PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS) * 1e3:.4f} ms each")
    log(f"gmm timing rows {rows} G {G} balanced, per form: kernels {ms}, cold {cold_ms}, plain "
        f"{plain_ms}, torch._grouped_mm {library}"
        + (f", refused: {refused}" if refused else ""))
    mean = statistics.fmean
    rows_out = {}
    for name in names:
        b_ms = mean(b for b, _ in bounds[name])
        lib = None if None in library[name] else mean(library[name])
        rows_out[name] = {"name": name, "route": "cuda", "source": GMM_SOURCE,
                          "replaces": REPLACES[name], "launches": None,
                          "max_abs_err": errs[name], "ms": mean(ms[name]),
                          "plain_ms": mean(plain_ms[name]), "bound_ms": b_ms,
                          "bound_by": bounds[name][0][1], "library_ms": lib}
    check_moe_no_sync()
    return rows_out


def phase_slice_moe():
    """The port's second path: BaguaTrainer over the dropless MoE LM."""
    import bagua_tpu_torch as bt
    from bagua_tpu_torch.model_parallel.moe import MoEMLP
    from bagua_tpu_torch.ops import flash_attention as fa
    from bagua_tpu_torch.ops import gmm as gm

    bt.init_process_group()
    model, trainer, state, batch = build_slice("moe")
    cfg, tokens = model.cfg, batch["tokens"]
    n_params = sum(p.numel() for p in model.parameters())
    log(f"slice 2: {n_params} params in {len(trainer.plan.buckets)} buckets, "
        f"world {trainer.world_size} over {torch.distributed.get_backend()}")

    losses, launches, st, _ = train_steps(trainer, state, batch,
                                          MOE["b"] * cfg.max_seq_len, [fa, gm])
    log_steps("slice 2", losses, launches, st)
    n_moe = cfg.n_layers // 2
    # the rows each expert gets on the training batch after the steps: the
    # skew the gmm kernels meet on this path
    routed = []
    hooks = [m.router.register_forward_hook(
        lambda mod, inp, out: routed.append(torch.bincount(
            torch.topk(out, MOE["k"], dim=-1).indices.reshape(-1),
            minlength=MOE["experts"]).tolist()))
        for m in model.modules() if isinstance(m, MoEMLP)]
    with torch.no_grad():
        model(tokens[:, :cfg.max_seq_len])
    for h in hooks:
        h.remove()
    log(f"slice 2 routing: rows per expert of each MoE layer on the training batch "
        f"after {STEPS} steps: {routed}")
    want = {"flash_fwd": cfg.n_layers * STEPS, "flash_bwd_dkv": cfg.n_layers * STEPS,
            "flash_bwd_dq": cfg.n_layers * STEPS,
            "grouped_matmul": 4 * n_moe * STEPS,       # 2 forward + 2 d_lhs
            "grouped_matmul_drhs": 2 * n_moe * STEPS}
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want}")

    # logits on a short input against the plain gmm and plain attention.  A
    # bf16 ulp of difference before a router can flip a near-tied top-2
    # choice, which moves a token's whole output and, through attention, the
    # tokens after it.  So the plain model routes with the kernel model's
    # router logits (same experts, same gates); the share of tokens whose
    # routing the plain model would have chosen alike is reported and must be
    # at least 95%.  Tolerance: 5e-2 of the largest logit, as slice 1.
    plain = slice_model("moe", gmm_fn=gm.gmm_reference,
                        attn_fn=lambda q, k, v, dtype: fa.reference_attention(q, k, v, dtype))
    plain.load_state_dict(model.state_dict())
    fed, agree = [], []

    def topk(logits):
        return torch.topk(logits, MOE["k"], dim=-1).indices.sort(dim=-1).values

    def record(mod, inp, out):
        fed.append(out)

    def feed(mod, inp, out):
        theirs = fed[len(agree)]
        agree.append((topk(out) == topk(theirs)).all(-1).float().mean().item())
        return theirs

    hooks = [m.router.register_forward_hook(hook)
             for net, hook in ((model, record), (plain, feed))
             for m in net.modules() if isinstance(m, MoEMLP)]
    with torch.no_grad():
        short = tokens[:1, :512]
        got, want_logits = model(short), plain(short)
    for h in hooks:
        h.remove()
    err = rel_err(got, want_logits)
    log(f"slice 2 logits vs plain gmm + plain attention, same routing (seq 512): rel "
        f"err {err:.3g}; the plain model's own routing agrees for {agree} of the "
        f"tokens per MoE layer")
    if not (torch.isfinite(got).all() and got.shape == (1, 512, cfg.vocab_size)
            and err <= 5e-2 and len(agree) == n_moe and min(agree) >= 0.95):
        raise AssertionError(f"logits disagree with the plain path: {err}, routing "
                             f"agreement {agree}")
    return launches, st


# ---------------------------------------------------------------------------
# codec kernels (K1-K3), the compressed path's
# ---------------------------------------------------------------------------


def same(a, b) -> bool:
    """Bitwise equal, any NaN equal to any NaN (its bits are not defined)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        nan = a.isnan()
        if not torch.equal(nan, b.isnan()):
            return False
        bits = {4: torch.int32, 2: torch.int16}[a.element_size()]
        return torch.equal(a.view(bits)[~nan], b.view(bits)[~nan])
    return torch.equal(a, b)


def check_codec(x, n, label):
    """K1, K2 and K3 against their plain versions on one input: sidecars,
    payload bytes (of the chunks whose values are all finite: elsewhere the
    grid is NaN and the u8 convert undefined on every side) and decoded
    values exactly equal; returns the largest absolute decode difference
    (0 when exact) by kernel."""
    from bagua_tpu_torch.ops import codec as cd

    mn, mx, p = cd.compress_chunked(x, n)
    pmn, pmx, pp = cd.compress_chunked_plain(x, n)
    y = cd.decompress_chunked(mn, mx, p)
    py = cd.decompress_chunked_plain(pmn, pmx, pp)
    am = cd.absmax_chunked(x, n)
    pam = cd.absmax_chunked_plain(x, n)
    torch.cuda.synchronize()
    finite = torch.isfinite(x.view(n, -1).float()).all(dim=1)
    checks = {"mn": same(mn, pmn), "mx": same(mx, pmx),
              "payload": torch.equal(p[finite], pp[finite]), "decoded": same(y, py),
              "absmax": same(am, pam)}
    log(f"codec {label} ({n} x {x.numel() // n} {x.dtype}): "
        + ", ".join(f"{k} {'equal' if v else 'DIFFERS'}" for k, v in checks.items())
        + f"; {int((~finite).sum())} non-finite chunks")
    if not all(checks.values()):
        raise AssertionError(f"codec kernel disagrees with its plain version on {label}: "
                             f"{checks}")
    ok = torch.isfinite(y) & torch.isfinite(py)
    errs = {"compress_chunked": max(abs_err(mn[finite], pmn[finite]),
                                    abs_err(mx[finite], pmx[finite]),
                                    abs_err(p[finite], pp[finite])),
            "decompress_chunked": abs_err(y[ok], py[ok]),
            "absmax_chunked": abs_err(am[finite], pam[finite])}
    return finite, (mn, y, am), errs


def codec_bound(name, n, m):
    """Least time of one launch: each input byte read once, each output byte
    written once, over the memory rate (K1: f32 in, u8 out; K2: u8 in, f32
    out; K3: f32 in; the per-chunk sidecars are noise)."""
    per_elem = {"compress_chunked": 5, "decompress_chunked": 5, "absmax_chunked": 4}[name]
    return per_elem * n * m / PEAK_BYTES * 1e3, "bytes"


def phase_codec_kernels():
    from bagua_tpu_torch.models.transformer import bert_large_config
    from bagua_tpu_torch.ops import codec as cd

    g = torch.Generator(device="cuda").manual_seed(11)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, device="cuda", generator=g).to(dtype)

    n = CODEC_WORLD
    path_m = CODEC_BUCKET_BYTES // 4 // n
    embed_m = bert_large_config().vocab_size * bert_large_config().d_model // n
    sizes = {"128 KiB": 32768, "1 MiB": 262144, "8 MiB": 2097152,
             "bucket chunk 5 MiB": path_m}
    errs = {}

    def check(x, label):
        finite, outs, e = check_codec(x, n, label)
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)
        return finite, outs

    for label, m in {**sizes, "embedding bucket chunk": embed_m}.items():
        check(randn(n * m), label)
    check(randn(n * 100003) * 1e-3, "ragged")
    check(randn(n * 3), "tiny")
    check(torch.ones(n * 4099, device="cuda"), "constant 1.0")
    check(torch.full((n * 4099,), -3.0, device="cuda"), "constant -3.0")
    check(randn(n * path_m, dtype=torch.bfloat16), "bf16 bucket chunk")
    x = randn(n * 50001)
    x[17], x[50001 + 5] = float("inf"), float("-inf")
    check(x, "±inf")
    x = randn(n * 50001)
    x[123] = float("nan")
    finite, (mn, y, am) = check(x, "NaN")
    if finite.tolist() != [False, True] or not (mn[0].isnan() and y[:50001].isnan().all()
                                               and am[0].isnan()):
        raise AssertionError("a NaN chunk must give a NaN sidecar, a NaN absmax and a "
                             "NaN decode")

    # times at each chunk size (f32), kernel against plain, both with the
    # inputs repeated (hot L2: the path's 5 MiB chunk fits in it) and the
    # kernel alone with a cold L2; K3 as the ring encode calls it, one chunk
    times, cold = {}, {}
    for label, m in sizes.items():
        x = randn(n * m)
        mn, mx, p = cd.compress_chunked(x, n)
        x1 = x[:m]
        fns = {"compress_chunked": (lambda: cd.compress_chunked(x, n),
                                    lambda: cd.compress_chunked_plain(x, n)),
               "decompress_chunked": (lambda: cd.decompress_chunked(mn, mx, p),
                                      lambda: cd.decompress_chunked_plain(mn, mx, p)),
               "absmax_chunked": (lambda: cd.absmax_chunked(x1, 1),
                                  lambda: cd.absmax_chunked_plain(x1, 1))}
        times[label] = {k: (cuda_ms(kern, 20), cuda_ms(plain, 5))
                        for k, (kern, plain) in fns.items()}
        cold[label] = {k: cuda_ms_cold(kern) for k, (kern, _) in fns.items()}
        log(f"codec timing chunk {label} ({m} f32): " + ", ".join(
            f"{k} {a:.4f} ms, cold L2 {cold[label][k]:.4f} ms (plain {b:.4f}, "
            f"{'kernel' if a < b else 'PLAIN'} faster)"
            for k, (a, b) in times[label].items()))
    # the library yardsticks at the path's chunk: aminmax computes only the
    # reduction half of K1; vector_norm(inf) is K3's whole function
    x = randn(n * path_m)
    x1 = x[:path_m]
    library = {"compress_chunked": cuda_ms(lambda: torch.aminmax(x.view(n, -1), dim=1), 20),
               "decompress_chunked": None,
               "absmax_chunked": cuda_ms(lambda: torch.linalg.vector_norm(
                   x1.view(1, -1), float("inf"), dim=1), 20)}
    log(f"codec library at the bucket chunk: torch.aminmax {library['compress_chunked']:.4f} "
        f"ms (reduction only), vector_norm(inf) {library['absmax_chunked']:.4f} ms")
    rows = {}
    path = times["bucket chunk 5 MiB"]
    for name in ("compress_chunked", "decompress_chunked", "absmax_chunked"):
        b_ms, b_by = codec_bound(name, 1 if name == "absmax_chunked" else n, path_m)
        rows[name] = {"name": name, "route": "cuda", "source": CODEC_SOURCE,
                      "replaces": REPLACES[name], "launches": None, "max_abs_err": errs[name],
                      "ms": path[name][0], "plain_ms": path[name][1], "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": library[name]}
    return rows


# ---------------------------------------------------------------------------
# sign codec kernels (K4, K5), the 1-bit path's
# ---------------------------------------------------------------------------


def check_sign(x, n, label):
    """K4 and K5 against their plain versions on one input: payload bytes
    exactly equal, the scale (a sum in another order) within ``SIGN_RTOL``
    relative, K5 on the kernel's parts exactly equal to its plain version;
    returns the parts, the decode and the largest absolute differences."""
    from bagua_tpu_torch.ops import codec as cd

    scale, p = cd.sign_compress_chunked(x, n)
    pscale, pp = cd.sign_compress_chunked_plain(x, n)
    y = cd.sign_decompress_chunked(scale, p)
    py = cd.sign_decompress_chunked_plain(scale, p)
    torch.cuda.synchronize()
    finite = torch.isfinite(pscale)
    rel = ((scale - pscale).abs() / pscale.abs().clamp_min(1e-30))[finite]
    checks = {"payload": torch.equal(p, pp),
              "scale": torch.equal(finite, torch.isfinite(scale))
              and torch.equal(scale.isnan(), pscale.isnan())
              and bool((rel <= SIGN_RTOL).all()),
              "decoded": same(y, py)}
    log(f"sign {label} ({n} x {x.numel() // n} {x.dtype}, {p.shape[1]} bytes a chunk): "
        + ", ".join(f"{k} {'equal' if v else 'DIFFERS'}" for k, v in checks.items())
        + f"; scale rel err {rel.max().item() if rel.numel() else 0.0:.3g}; "
        f"{int((~finite).sum())} non-finite chunks")
    if not all(checks.values()):
        raise AssertionError(f"sign kernel disagrees with its plain version on {label}: "
                             f"{checks}")
    ok = torch.isfinite(y) & torch.isfinite(py)
    errs = {"sign_compress_chunked": abs_err(scale[finite], pscale[finite]),
            "sign_decompress_chunked": abs_err(y[ok], py[ok])}
    return (scale, p, y), errs


def sign_bound(name, n, m, itemsize=4):
    """Least time of one launch: each input byte read once, each output byte
    written once, over the memory rate.  K4 reads ``m`` elements and writes
    ``B = ceil(m / 1024) * 128`` bytes and a scale a chunk; K5 reads those and
    writes the padded ``8 B`` f32 elements.  At f32 and m a multiple of 1024,
    4.125 bytes an element each."""
    from bagua_tpu_torch.ops.codec import sign_payload_bytes

    nbytes = sign_payload_bytes(m)
    moved = n * (m * itemsize + nbytes + 4) if name == "sign_compress_chunked" \
        else n * (nbytes + 4 + 32 * nbytes)
    return moved / PEAK_BYTES * 1e3, "bytes"


def phase_sign_kernels():
    from bagua_tpu_torch.models.transformer import bert_large_config
    from bagua_tpu_torch.ops import codec as cd

    g = torch.Generator(device="cuda").manual_seed(13)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, device="cuda", generator=g).to(dtype)

    n = CODEC_WORLD
    cfg = bert_large_config()
    path_m = CODEC_BUCKET_BYTES // 4 // n          # the main path's ring chunk
    sizes = {"128 KiB": 32768, "1 MiB": 262144, "8 MiB": 2097152,
             "ring chunk 5 MiB": path_m}
    # the 2 x 2 path's inter-node ring chunk: a quarter of a 10 MiB bucket
    shapes = {**{k: (n, m) for k, m in sizes.items()},
              "2x2 inter chunk 2.5 MiB": (2, CODEC_BUCKET_BYTES // 4 // 4),
              "embedding bucket chunk": (n, cfg.vocab_size * cfg.d_model // n),
              "whole 10 MiB bucket (compensate)": (1, CODEC_BUCKET_BYTES // 4)}
    errs = {}

    def check(x, k, label):
        outs, e = check_sign(x, k, label)
        for key, v in e.items():
            errs[key] = max(errs.get(key, 0.0), v)
        return outs

    for label, (k, m) in shapes.items():
        check(randn(k * m), k, label)
    check(randn(n * 100003) * 1e-3, n, "ragged")
    check(randn(n * 3), n, "tiny")
    scale, p, y = check(torch.zeros(n * 5000, device="cuda"), n, "all-zero")
    if not ((scale == 0).all() and (p == 255).all() and (y == 0).all()):
        raise AssertionError("an all-zero chunk must give scale 0, all sign bits 1, zeros")
    check(randn(n * path_m, dtype=torch.bfloat16), n, "bf16 ring chunk")
    x = randn(n * 50001)
    x[17], x[50001 + 5] = float("inf"), float("-inf")
    scale, _, y = check(x, n, "±inf")
    if torch.isfinite(scale).any() or torch.isfinite(y).any():
        raise AssertionError("an inf in a chunk must make its scale and decode non-finite")
    x = randn(n * 50001)
    x[123] = float("nan")
    scale, _, y = check(x, n, "NaN")
    if not (scale[0].isnan() and y[0].isnan().all() and torch.isfinite(y[1]).all()):
        raise AssertionError("a NaN chunk must give a NaN scale and a NaN decode")

    # times at each chunk size (f32): kernels hot and with a cold L2, plain
    # versions hot
    times, cold = {}, {}
    for label, m in sizes.items():
        x = randn(n * m)
        scale, p = cd.sign_compress_chunked(x, n)
        fns = {"sign_compress_chunked": (lambda: cd.sign_compress_chunked(x, n),
                                         lambda: cd.sign_compress_chunked_plain(x, n)),
               "sign_decompress_chunked": (lambda: cd.sign_decompress_chunked(scale, p),
                                           lambda: cd.sign_decompress_chunked_plain(scale, p))}
        times[label] = {k: (cuda_ms(kern, 20), cuda_ms(plain, 5))
                        for k, (kern, plain) in fns.items()}
        cold[label] = {k: cuda_ms_cold(kern) for k, (kern, _) in fns.items()}
        log(f"sign timing chunk {label} ({m} f32): " + ", ".join(
            f"{k} {a:.4f} ms, cold L2 {cold[label][k]:.4f} ms (plain {b:.4f}, "
            f"{'kernel' if a < b else 'PLAIN'} faster)"
            for k, (a, b) in times[label].items()))
    # the library yardstick of K4 at the path's chunk: its reduction half
    x = randn(n * path_m)
    library = {"sign_compress_chunked": cuda_ms(lambda: x.view(n, -1).abs().sum(dim=1), 20),
               "sign_decompress_chunked": None}
    log(f"sign library at the ring chunk: abs().sum(dim=1) "
        f"{library['sign_compress_chunked']:.4f} ms (reduction only)")
    rows = {}
    path = times["ring chunk 5 MiB"]
    for name in ("sign_compress_chunked", "sign_decompress_chunked"):
        b_ms, b_by = sign_bound(name, n, path_m)
        rows[name] = {"name": name, "route": "cuda", "source": CODEC_SOURCE,
                      "replaces": REPLACES[name], "launches": None, "max_abs_err": errs[name],
                      "ms": path[name][0], "plain_ms": path[name][1], "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": library[name]}
    return rows


# ---------------------------------------------------------------------------
# narrow and f32 shapes: the kernels widen what is narrower than their tiles
# ---------------------------------------------------------------------------


def phase_narrow_shapes():
    """The tiny SQuAD model (head_dim 32), in bf16 and in f16: one forward
    and backward on the card through the flash kernels, one launch of each a
    layer, the loss and every gradient finite, and the logits on the same
    input within the slices' 5e-2 of the same model with the plain
    attention.  An ``MoEMLP`` with d_model 64 in bf16, one with d_model 128 in
    f32 and one with d_model 128 in f16: one forward and backward each
    through the gmm kernels (four K7a and two K7b launches), against the same
    layer whose gmm is the dense reference (the routing, computed before
    either, is the same): the output within the product's tolerance and
    every gradient within twice it."""
    from bagua_tpu_torch.model_parallel.moe import MoEMLP
    from bagua_tpu_torch.models.transformer import TransformerConfig, TransformerLM, lm_loss_fn
    from bagua_tpu_torch.ops import flash_attention as fa
    from bagua_tpu_torch.ops import gmm as gm

    for dtype in (torch.bfloat16, torch.float16):
        cfg = TransformerConfig(**SQUAD_TINY, dtype=dtype)
        model = TransformerLM(cfg, seed=0)
        g = torch.Generator(device="cuda").manual_seed(12)
        tokens = torch.randint(0, cfg.vocab_size, (2, cfg.max_seq_len + 1), device="cuda",
                               generator=g)
        fa.reset_launch_counts()
        loss = lm_loss_fn(model, {"tokens": tokens})
        loss.backward()
        torch.cuda.synchronize()
        launches = {k.__name__: k.launches for k in fa.KERNELS}
        finite = bool(torch.isfinite(loss)) and all(
            torch.isfinite(p.grad).all() for p in model.parameters())
        plain = TransformerLM(cfg, attn_fn=lambda q, k, v, dtype:
                              fa.reference_attention(q, k, v, dtype))
        plain.load_state_dict(model.state_dict())
        with torch.no_grad():
            short = tokens[:1, :cfg.max_seq_len]
            got, want = model(short), plain(short)
        err = rel_err(got, want)
        log(f"narrow heads: SQuAD tiny (head_dim {cfg.head_dim}) {dtype} loss "
            f"{loss.item():.4f}, finite {finite}, launches {launches}; logits vs plain "
            f"attention rel err {err:.3g}")
        if not (finite and set(launches.values()) == {cfg.n_layers} and err <= 5e-2):
            raise AssertionError(f"head_dim {cfg.head_dim} {dtype}: launches {launches}, "
                                 f"finite {finite}, logits rel err {err}")

    for d_model, dtype in ((64, torch.bfloat16), (128, torch.float32), (128, torch.float16)):
        g = torch.Generator(device="cuda").manual_seed(d_model)
        x0 = torch.randn(2, SQUAD_TINY["max_seq_len"], d_model, device="cuda",
                         generator=g).to(dtype)
        runs = []
        for gmm_fn in (None, gm.gmm_reference):
            torch.manual_seed(0)
            layer = MoEMLP(MOE["experts"], 256, d_model=d_model, k=MOE["k"], dropless=True,
                           dtype=dtype, gmm_fn=gmm_fn).cuda()
            x = x0.clone().requires_grad_()
            gm.reset_launch_counts()
            y = layer(x)
            (y.float().square().mean() + layer.l_aux).backward()
            torch.cuda.synchronize()
            runs.append((y, [x.grad, *(p.grad for p in layer.parameters())],
                         [k.launches for k in gm.KERNELS]))
        (y, grads, launches), (ref_y, ref_grads, _) = runs
        tol = GMM_TOL[dtype]
        err = rel_err(y, ref_y)
        grad_err = max(rel_err(a, b) for a, b in zip(grads, ref_grads))
        finite = all(torch.isfinite(t).all() for t in (y, *grads))
        log(f"narrow, f16 and f32 gmm: MoEMLP d_model {d_model} {dtype}: launches {launches}, "
            f"output vs dense reference rel err {err:.3g}, gradients {grad_err:.3g}, "
            f"finite {finite}")
        if not (finite and launches == [4, 2] and err <= tol and grad_err <= 2 * tol):
            raise AssertionError(f"MoEMLP d_model {d_model} {dtype}: launches {launches}, "
                                 f"rel err {err}, gradients {grad_err}, finite {finite}")


# ---------------------------------------------------------------------------
# slices 3 and 4: compressed data parallelism, several ranks on one card over
# gloo
# ---------------------------------------------------------------------------

#: (name, layers, algorithm, BaguaTrainer keywords).  Slice 3: (a) ByteGrad on
#: the full BERT-Large, (b) the forced int8 and fp8 rings and (c) QAdam on a
#: 4-layer cut of it
SLICE3_RUNS = (
    ("bytegrad", None, "bytegrad", {}),
    ("int8", BERT["cut_layers"], "gradient_allreduce", {"compress_intra": "int8"}),
    ("fp8_e4m3", BERT["cut_layers"], "gradient_allreduce", {"compress_intra": "fp8_e4m3"}),
    ("qadam", BERT["cut_layers"], "qadam", {}),
)
#: slice 4 at world 2: (a) the main path, the README quick start with the
#: 1-bit codec on the full BERT-Large, (b) top-k (1%) on the 4-layer cut
SLICE4_RUNS = (
    ("onebit_ef", None, "gradient_allreduce", {"compress_intra": "onebit_ef"}),
    ("topk", BERT["cut_layers"], "gradient_allreduce", {"compress_intra": "topk"}),
)
#: slice 4 at world 4, two nodes of two ranks, on the 4-layer cut: (a) the
#: two-level allreduce with the 1-bit codec on the inter-node tier, (b)
#: ByteGrad at its default hierarchical=True (MinMaxUInt8 on that tier)
SLICE4_2X2_RUNS = (
    ("hier_onebit_ef", BERT["cut_layers"], "hierarchical", {"compress_inter": "onebit_ef"}),
    ("bytegrad_2x2", BERT["cut_layers"], "bytegrad_default", {}),
)
#: the multi-rank phases: name -> (label, runs, world, intra-node size)
MULTI_RANK = {
    "slice3": ("slice 3", SLICE3_RUNS, CODEC_WORLD, None),
    "slice4": ("slice 4", SLICE4_RUNS, CODEC_WORLD, None),
    "slice4_2x2": ("slice 4 (2 x 2)", SLICE4_2X2_RUNS, 4, 2),
}
QADAM_WARMUP = 2
#: seconds a multi-rank phase may take before its ranks are killed
WORKER_TIMEOUT = 420


def _algorithm(name):
    import bagua_tpu_torch as bt

    if name == "bytegrad":
        return bt.ByteGradAlgorithm(hierarchical=False)
    if name == "bytegrad_default":
        return bt.ByteGradAlgorithm()
    if name == "qadam":
        # lr 1e-5: at 1e-4 the second moment frozen after two warmup steps
        # turns grown gradients into steps that make the loss diverge from
        # the third compressed step on, with the codec or without it
        # (compress_intra="off"), in the JAX package's QAdam as in the port
        return bt.QAdamAlgorithm(warmup_steps=QADAM_WARMUP, hierarchical=False, lr=1e-5)
    return bt.GradientAllReduceAlgorithm(hierarchical=name == "hierarchical")


def _want_launches(algo_name, kw, n_layers, n_buckets):
    """Each codec and flash kernel's launches in ``STEPS`` steps.  Per bucket
    and step: ByteGrad's and QAdam's scatter-gather one K1 and two K2; the
    two-level ByteGrad's inter-node ring at n = 2 one hop and the allgather's
    encode, two K1 and two K2; the int8/fp8 rings at world 2 two K3; the
    1-bit codec's error-feedback step one K4 and one K5, its ring at n = 2
    two more of each (one hop, then the allgather's encode and the decode of
    the gathered parts); top-k none."""
    from bagua_tpu_torch.ops import codec as cd

    want = {k.__name__: 0 for k in cd.KERNELS}
    want.update({k: n_layers * STEPS for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")})
    codec = kw.get("compress_intra") or kw.get("compress_inter")
    if algo_name in ("bytegrad", "qadam"):
        codec_steps = STEPS - QADAM_WARMUP if algo_name == "qadam" else STEPS
        want["compress_chunked"] = n_buckets * codec_steps
        want["decompress_chunked"] = 2 * n_buckets * codec_steps
    elif algo_name == "bytegrad_default":
        want["compress_chunked"] = want["decompress_chunked"] = 2 * n_buckets * STEPS
    elif codec in ("int8", "fp8_e4m3"):
        want["absmax_chunked"] = 2 * n_buckets * STEPS
    elif codec == "onebit_ef":
        want["sign_compress_chunked"] = want["sign_decompress_chunked"] = 3 * n_buckets * STEPS
    return want


def fwd_bwd_ms(model, batch, reps: int = 3) -> float:
    """Median host time of this rank's forward and backward alone, no
    communication; every rank runs it at once on the one card, as in a step."""
    import bagua_tpu_torch as bt

    times = []
    for _ in range(reps):
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bt.lm_loss_fn(model, batch).backward()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def _flat_digests(trainer, model):
    """sha256 of every bucket flat of the parameters."""
    import hashlib

    with torch.no_grad():
        flats = trainer.plan.flatten(dict(model.named_parameters()))
    return [hashlib.sha256(f.cpu().numpy().tobytes()).hexdigest() for f in flats]


def _check_plain_bucket(rank, trainer, model, batch, record):
    """One ByteGrad bucket's reduction through the kernels against the same
    collective through the plain codec (CPU tensors take it), on a fresh
    local gradient: byte for byte."""
    import bagua_tpu_torch as bt
    from bagua_tpu_torch.compression import compressed_scatter_gather_allreduce

    model.zero_grad(set_to_none=True)
    bt.lm_loss_fn(model, batch).backward()
    i = len(trainer.plan.buckets) // 2
    flat = trainer.plan.flatten({n: p.grad for n, p in model.named_parameters()})[i]
    got = compressed_scatter_gather_allreduce(trainer.comm, flat).cpu()
    want_flat = compressed_scatter_gather_allreduce(trainer.comm, flat.cpu())
    record["plain_bucket"] = {"index": i, "numel": flat.numel(),
                              "equal": bool(same(got, want_flat))}
    log(f"[rank {rank}] bucket {i} ({flat.numel()} elements) reduced through the "
        f"kernels vs the plain codec: {'equal' if record['plain_bucket']['equal'] else 'DIFFERS'}")
    if not record["plain_bucket"]["equal"]:
        raise AssertionError(f"[rank {rank}] the kernel path's bucket {i} differs from "
                             f"the plain codec's")


def _check_ef_bucket(rank, trainer, state, model, batch, record):
    """The error-feedback step of the largest bucket through the kernels
    against the plain codec, on a fresh local gradient and the run's
    residual: ``c = g + r`` is the same on both sides, so the payload must be
    equal byte for byte and the new residual ``c - decode(encode(c))`` within
    ``EF_BUCKET_RTOL`` of the scale (the scale's sum runs in another order),
    and each side's scale within it of the f64 mean of ``|c|``."""
    import bagua_tpu_torch as bt
    from bagua_tpu_torch.compression import get_codec

    model.zero_grad(set_to_none=True)
    bt.lm_loss_fn(model, batch).backward()
    buckets = trainer.plan.buckets
    i = max(range(len(buckets)), key=lambda j: buckets[j].padded_numel)
    flat = trainer.plan.flatten({n: p.grad for n, p in model.named_parameters()})[i]
    c = (flat.float() + state.algo_state["ef"]["buckets"][i])[None]
    codec = get_codec("onebit_ef")
    parts, pparts = codec.encode(c), codec.encode(c.cpu())
    res = (c - codec.decode(parts, c.shape[1])).cpu()
    pres = c.cpu() - codec.decode(pparts, c.shape[1])
    scale = pparts[0].item()
    err = (res - pres).abs().max().item() / scale
    exact = c.double().abs().mean().item()
    scale_err = {"kernel": abs(parts[0].item() / exact - 1), "plain": abs(scale / exact - 1)}
    equal = bool(torch.equal(parts[1].cpu(), pparts[1]))
    record["ef_bucket"] = {"index": i, "numel": c.shape[1], "payload_equal": equal,
                           "residual_err_over_scale": err, "scale_err_vs_f64": scale_err}
    log(f"[rank {rank}] bucket {i} ({c.shape[1]} elements) error-feedback step through the "
        f"kernels vs the plain codec: payload {'equal' if equal else 'DIFFERS'}, new "
        f"residual within {err:.3g} of the scale; scale relative error against the f64 "
        f"mean: kernel {scale_err['kernel']:.3g}, plain {scale_err['plain']:.3g}")
    if not (equal and err <= EF_BUCKET_RTOL and max(scale_err.values()) <= EF_BUCKET_RTOL):
        raise AssertionError(f"[rank {rank}] the kernel path's error-feedback step of bucket "
                             f"{i} differs from the plain codec's: {record['ef_bucket']}")


def compressed_run(rank, world, run, device, label):
    """One run of a multi-rank slice on this rank; returns its record."""
    import bagua_tpu_torch as bt
    from bagua_tpu_torch.ops import codec as cd
    from bagua_tpu_torch.ops import flash_attention as fa

    name, layers, algo_name, kw = run
    cfg = bt.bert_large_config(max_seq_len=BERT["s"],
                               **({} if layers is None else {"n_layers": layers}))
    model = bt.TransformerLM(cfg, device=device, seed=0)
    adamw = functools.partial(torch.optim.AdamW, lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                              weight_decay=1e-4)
    trainer = bt.BaguaTrainer(bt.lm_loss_fn, adamw, _algorithm(algo_name), device=device,
                              **kw)
    state = trainer.init(model)
    # each rank feeds its own slice of one global batch (seed 1)
    g = torch.Generator(device=device).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (world * BERT["b"], cfg.max_seq_len + 1),
                           device=device, generator=g)
    batch = trainer.shard_batch({"tokens": tokens[rank * BERT["b"]:(rank + 1) * BERT["b"]]})
    staged0 = trainer.host_staged_bytes
    losses, launches, st, state = train_steps(trainer, state, batch,
                                              BERT["b"] * cfg.max_seq_len, [fa, cd])
    staged = trainer.host_staged_bytes - staged0
    n_buckets = len(trainer.plan.buckets)
    ef = state.algo_state["ef"]["buckets"] if state.algo_state else None
    record = {"name": name, "layers": cfg.n_layers, "buckets": n_buckets,
              "params": sum(p.numel() for p in model.parameters()), "losses": losses,
              "launches": launches, "stats": st, "host_staged_bytes": staged,
              "ef_norm": None if ef is None else sum(r.abs().sum().item() for r in ef),
              "ef_finite": ef is None or all(bool(r.isfinite().all()) for r in ef),
              "digests": _flat_digests(trainer, model)}
    record["fwd_bwd_ms"] = fwd_bwd_ms(model, batch)
    log(f"[rank {rank}] {label} {name}: {record['params']} params, {cfg.n_layers} layers, "
        f"{n_buckets} buckets; losses {losses}; residual L1 {record['ef_norm']}")
    want = _want_launches(algo_name, kw, cfg.n_layers, n_buckets)
    if device.type == "cuda" and launches != want:
        raise AssertionError(f"[rank {rank}] {name}: launches {launches}, expected {want}")
    if trainer._ef_active() != (ef is not None) or not record["ef_finite"] or \
            (ef is not None and not record["ef_norm"] > 0):
        raise AssertionError(f"[rank {rank}] {name}: the error-feedback residual is "
                             f"{record['ef_norm']} (finite {record['ef_finite']})")
    if name == "bytegrad":
        _check_plain_bucket(rank, trainer, model, batch, record)
    if name == "onebit_ef":
        _check_ef_bucket(rank, trainer, state, model, batch, record)
    return record


def multi_rank_worker(phase, rank, init_method, out_path, device="cuda"):
    """One rank of a multi-rank phase of ``MULTI_RANK``: every run, records
    to ``out_path`` as JSON."""
    import bagua_tpu_torch as bt

    label, runs, world, intra = MULTI_RANK[phase]
    device = torch.device(device)
    bt.init_process_group(init_method, world_size=world, rank=rank, device=device,
                          backend="gloo", intra_size=intra)
    records = []
    for run in runs:
        records.append(compressed_run(rank, world, run, device, label))
        if device.type == "cuda":
            torch.cuda.empty_cache()
    with open(out_path, "w") as f:
        json.dump(records, f)
    torch.distributed.destroy_process_group()


def phase_multi_rank(phase):
    """Start the phase's ranks as processes of this script on the one card and
    check them; fails if any rank fails or the phase outlasts
    ``WORKER_TIMEOUT``."""
    label, _, world, _ = MULTI_RANK[phase]
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{os.path.join(tmp, 'store')}"
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(world)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                   "--worker", phase, str(r), init, outs[r]])
                 for r in range(world)]
        deadline = time.monotonic() + WORKER_TIMEOUT
        try:
            codes = [p.wait(timeout=max(1.0, deadline - time.monotonic())) for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        if codes != [0] * world:
            raise AssertionError(f"{label} ranks exited with {codes}")
        ranks = []
        for path in outs:
            with open(path) as f:
                ranks.append(json.load(f))
    for runs in zip(*ranks):
        name = runs[0]["name"]
        if any(r["digests"] != runs[0]["digests"] for r in runs):
            raise AssertionError(f"{label} {name}: parameters differ between the ranks")
        if any(r["losses"] != runs[0]["losses"] for r in runs):
            raise AssertionError(f"{label} {name}: losses differ between the ranks")
        for r, rec in enumerate(runs):
            st = rec["stats"]
            log(f"{label} {name} rank {r} (gloo through host memory, {world} ranks on one "
                f"card): step {st['step_ms']:.3f} ms (steps 2-{STEPS} as one window; median "
                f"{st['median_ms']:.3f} ms; first {st['first_ms']:.3f} ms), "
                f"{st['tokens_s']:.1f} tokens/s, peak memory {st['peak_gb']:.3f} GB, "
                f"host-staged {rec['host_staged_bytes']} bytes in {STEPS} steps, "
                f"{rec['buckets']} buckets, launches {rec['launches']}; forward+backward "
                f"alone (no communication) {rec['fwd_bwd_ms']:.3f} ms")
        log(f"{label} {name}: parameters bitwise equal on all {world} ranks "
            f"({len(runs[0]['digests'])} bucket digests)")
    return {rec["name"]: rec for rec in ranks[0]}


def main():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if sys.argv[1:2] == ["--worker"]:
        phase, rank, init, out = sys.argv[2:6]
        multi_rank_worker(phase, int(rank), init, out)
        return
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    card = timed("device", phase_device)
    timed("build", phase_build)
    rows = timed("kernels", phase_kernels)
    rows.update(timed("gmm kernels", phase_gmm_kernels))
    rows.update(timed("codec kernels", phase_codec_kernels))
    rows.update(timed("sign kernels", phase_sign_kernels))
    timed("narrow shapes", phase_narrow_shapes)
    launches = timed("slice 1", phase_slice)
    launches_moe, _ = timed("slice 2", phase_slice_moe)
    torch.distributed.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()   # the ranks of slices 3 and 4 share this card
    slice3 = timed("slice 3", phase_multi_rank, "slice3")
    slice4 = timed("slice 4", phase_multi_rank, "slice4")
    timed("slice 4 (2 x 2)", phase_multi_rank, "slice4_2x2")
    log(f"seconds by phase: {seconds}")
    # each kernel's launches come from its own path: flash from slice 1, gmm
    # from slice 2, K1 and K2 from slice 3's ByteGrad run, K3 from its int8
    # ring, K4 and K5 from slice 4's main path (the other slices checked the
    # flash counts too, and slice 4's 2 x 2 runs K1, K2, K4 and K5)
    own = {"compress_chunked": slice3["bytegrad"]["launches"],
           "decompress_chunked": slice3["bytegrad"]["launches"],
           "absmax_chunked": slice3["int8"]["launches"],
           "sign_compress_chunked": slice4["onebit_ef"]["launches"],
           "sign_decompress_chunked": slice4["onebit_ef"]["launches"]}
    for name, row in rows.items():
        row["launches"] = (own[name][name] if name in own else launches[name]
                           if name in launches else launches_moe[name])
    log(card)
    log(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
