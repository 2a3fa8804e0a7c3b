"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. device: a CUDA card is required; prints its name and power limit.
2. build: compiles every ``bagua_tpu_torch/ops/csrc/*.cu`` with ``nvcc``.
3. kernels: each flash-attention kernel against its plain PyTorch version on
   the card (bf16 at every slice's training shape: b·h 32 and 64 at seq
   4096, BERT-Large's 128 at seq 384; a ragged bf16 length; f32; f16; heads
   of 32, 96 and 136, which the kernels widen to 64, 128 and 256, of 256
   in bf16, f16 and f32, and of 384 and 512, above 256, on the wide kernels,
   in every dtype); a head of 100 through ``flash_attention``, which
   pads it to 104 (forward and gradients against the same call on the CPU);
   every kernel at a ragged length beside a head of values near 1e4 (no read
   across heads) and twice on the same inputs (bitwise equal), at D = 64,
   128 and 256; the times of
   each kernel (hot and cold L2), its plain version and the PyTorch library
   call at slice 1's shape, the forward's and SDPA's forward at slice 2's and
   BERT-Large's shapes, each kernel at heads of 384 and 512 (b·h 4, seq 4096)
   beside its bound and SDPA's forward and backward, and the port's whole
   backward (delta, dK/dV and dQ,
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
   sidecars, decoded values and maxima exactly equal: chunks of 128 KiB,
   1 MiB, 8 MiB, the path's bucket chunk (10 MiB / 2 ranks) and its embedding
   bucket's chunk, a ragged, a tiny, a constant, a ±inf and a NaN chunk, a
   bf16 input, and for K3 a chunk of -0.0 and one holding ±inf and a NaN;
   their times against the plain versions at every size, and each kernel's
   time with a cold L2, beside its bound; K1's times on the embedding
   bucket's chunk (more than its grid holds in shared memory); K1 and K2 on
   a whole 10 MiB bucket and the whole embedding bucket as one chunk, as
   the low-precision gossip ring runs them, equal to plain, with their
   times hot, cold and plain and their bounds; the device
   kernels a call of each runs (K1 and K3 must run one).
6. sign kernels: the 1-bit codec's compress (K4) and decompress (K5) against
   their plain versions, payload bytes and decoded values exactly equal, the
   scale within 1e-6 relative: chunks of 128 KiB, 1 MiB, 8 MiB, the main
   path's ring chunk (5 MiB), its whole 10 MiB bucket (the error-feedback
   step encodes a bucket as one chunk), its embedding bucket's chunk and the
   2 x 2 path's inter-node chunk, a ragged, a tiny, an all-zero, a ±inf and a
   NaN chunk, a bf16 input; their times hot and cold against the plain
   versions and their bounds, and against ``abs().sum(dim=1)``, K4's
   reduction half; the device kernels a call of each runs (K4 must run one).
7. narrow, f16 and f32 shapes: the tiny SQuAD model of
   ``examples/squad_finetune.py`` (head_dim 32), in bf16 and in f16, takes
   one forward and backward on the card through the flash kernels (one launch
   of each a layer), its loss and gradients finite and its logits against
   the same model with the plain attention; an ``MoEMLP`` with d_model 64 in
   bf16, one with d_model 128 in f32 and one with d_model 128 in f16 each
   take one forward and backward through the gmm kernels, against the same
   layer with the dense reference gmm.
8. slice 1: every ``ReduceOp`` through the communicator over NCCL at world
   1 (f32; int32 for the bitwise ops, which take NCCL's gather path), each
   equal to its operand, nothing staged; every eager collective
   (``eager_checks``) equal to plain torch, and refused after an abort; then
   the long-context
   TransformerLM (``bench_longctx``'s widths,
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
10. remat: slices 1 and 2 again from the same weights, batch and optimizer,
   each under its bench's rematerialization (slice 1 ``dots_no_batch``,
   slice 2 whole blocks): exact launches (the flash forward twice a layer,
   the gmm forward twice more a MoE layer), losses finite and falling, the
   first loss bitwise equal to the run just before without remat, the
   parameters' updates after 10 steps within the bf16 tolerance of it (the
   log says whether bitwise), the peak below it; the step time, the peak and
   each kernel's device time a step beside it.
11. slice 3: compressed data parallelism at world size 2.  The script starts
   itself twice as worker processes, two ranks on the one card, whose
   collectives go over gloo through host memory (NCCL refuses two ranks on
   one device).  Each rank trains BERT-Large (``bench_bert``: 24 layers,
   seq 384, batch 8 per rank, AdamW 1e-4) for 5 steps (``FULL_STEPS``) with
   ``ByteGradAlgorithm``, then a 4-layer cut of it with
   ``GradientAllReduceAlgorithm`` and ``compress_intra`` ``int8`` and
   ``fp8_e4m3``, and with ``QAdamAlgorithm(warmup_steps=2, lr=1e-5)``; losses finite
   and falling, exact codec and flash launch counts, parameters bitwise
   equal on both ranks, and one ByteGrad bucket's reduction through the
   kernels equal byte for byte to the same collective through the plain
   codec.  Each run prints its step time, the bytes staged through the host
   and the time of a forward and backward alone.
12. slice 4, the 1-bit and top-k codecs with the error-feedback residual, two
   ranks as in slice 3: the main path is the README quick start with
   ``GradientAllReduceAlgorithm()`` and ``compress_intra="onebit_ef"`` on the
   full BERT-Large, AdamW 1e-4, 5 steps; then ``compress_intra="topk"`` on
   the 4-layer cut.  Launches exact (K4 = K5 = 3 x buckets x steps), the
   residual finite and nonzero, parameters bitwise equal on both ranks, and
   the error-feedback step of the largest bucket through the kernels against
   the plain codec (payload equal, residual within 1e-5 of the scale).
13. slice 4 at 2 x 2: four ranks of this script on the card, two nodes of two
   (``intra_size=2``), on the 4-layer cut: ``GradientAllReduceAlgorithm(
   hierarchical=True)`` with ``compress_inter="onebit_ef"`` (K4 = K5 = 3 x
   buckets x steps) and ``ByteGradAlgorithm()`` at its default two-level form
   (K1 = K2 = 2 x buckets x steps), and staged ZeRO
   (``ZeroOptimizerAlgorithm(hierarchical=True)``, AdamW 1e-4; no codec);
   the same checks.
14. zero, ZeRO-1 at world size 2, two ranks as in slice 3: the full
   BERT-Large with ``ZeroOptimizerAlgorithm`` over AdamW 1e-4 beside the
   replicated ``GradientAllReduceAlgorithm`` with the same AdamW, then the
   4-layer cut with ``compress_intra="int8"`` (K3 = 2 x buckets x steps: one
   encode on the scatter hop, one on the gather; AdamW 1e-3, see
   ``ZERO_RUNS``); the same checks, and ZeRO's optimizer state a rank exactly
   half of the replicated run's, its peak memory below it.
15. decentralized, the gossip families at world size 2, two ranks as in
   slice 3, on the full BERT-Large with AdamW 1e-4: ``DecentralizedAlgorithm(
   hierarchical=False, peer_selection_mode="all", track_peer_weights=True)``
   (no codec), then ``LowPrecisionDecentralizedAlgorithm(hierarchical=False)``
   (K1 = buckets x steps, a whole bucket one chunk; K2 three times that).
   Their ranks differ by design, so in place of the parameters' equality:
   after every step, fingerprints of every bucket show the peer weights
   equal on both ranks (``all``), or each rank's ``left`` and ``right``
   replicas equal to its neighbours' ``self`` and its parameters to its own
   ``self`` (the ring), and the parameters of the ranks differ after the
   last step; losses equal on the ranks, finite and falling; exact launches;
   the ring's codec of a middle bucket's and of the embedding bucket's
   ``diff`` through the kernels equal to the plain codec.
16. decentralized at 2 x 2, four ranks as two nodes of two on the 4-layer
   cut: ``shift_one`` over the four ranks (the peer weights equal to those
   of the step's partner) and ``LowPrecisionDecentralizedAlgorithm(
   hierarchical=True)`` (the intra-node average, then the ring over the two
   nodes); the same checks.
17. async, async model average at world size 2, two ranks as in slice 3:
   the full BERT-Large with the bench's ``AsyncModelAverageAlgorithm(
   sync_interval_ms=100)``, AdamW 1e-4, then on the 4-layer cut a pinned
   period of 2 after 2 warmup steps with ``async.partition`` armed on rank 1
   alone (staleness cap 2), and a period of 1 with an abort from rank 0 and
   a resume from rank 1.  Gates: the same period, launches, catch-ups and
   status after every step on both ranks; a round applied inside the full
   run's window; the ranks' parameters differ after the window and are
   bitwise equal after ``barrier`` and ``sync_for_checkpoint``; staged
   bytes exactly two f32 copies of the weights a round, warmup step or
   catch-up plus the losses; the partition run's catch-up at the same step
   on both ranks, bitwise equal right after it, its lag within the cap; the
   abort run's status turning at the same steps on both ranks; losses
   finite and falling; exact flash launches, no codec.  Prints the agreed
   period, the rounds, the step times against the replicated and ``all``
   gossip runs of the same call, the peak, and how long each apply waited
   for its round against a round's whole time alone.
18. features, the trainer's step features at world size 2, two ranks as in
   slice 3: the full BERT-Large ZeRO over AdamW 1e-4 on the leaf layout
   (``flat_resident="off"``, 5 steps), its per-step bucket fingerprints equal
   to the zero phase's ZeRO run (resident by default) and its peak at least
   0.9 GB above; the full BERT-Large with ``GradientAllReduceAlgorithm``,
   ``accum_steps=2`` and ``grad_guard="skip"`` (5 steps), its losses within 1e-2 of the
   zero phase's replicated run and every verdict healthy; on the cut, the
   1-bit ring under the guard with ``grad.poison`` at step 4 of 10 against a
   clean run of 9 (parameters and residual bitwise equal, after two clean
   runs shown bitwise equal; one skip), and a rebucket from 10 MiB to 2 MiB
   buckets after step 5, full precision (parameters bitwise equal to the run
   without it, AdamW's state on the new plan) and under the 1-bit ring (the
   residual on the new plan).  Every earlier phase runs on the default
   ``flat_resident="auto"`` layout, which each log line names.
19. overlap, the overlap scheduler at world size 2, two ranks as in slice 3
   (``OVERLAP_RUNS``): (a) the full BERT-Large with GradientAllReduce, AdamW
   1e-4, ``accum_steps=2``, ``overlap`` off then on (5 steps each): parameters
   bitwise equal after every step; the backward's time, the communication's
   and the wait after the backward a step, and the share of the serialized
   communication the overlap hides; (b) ByteGrad with ``overlap="on"`` (5
   steps): every K1 and K2 launch made on the comm stream by the comm worker
   (99 and 198 a step), one real K1 call of the last step equal to plain,
   parameters bitwise equal to the serialized run on the same plan; K1's
   device intervals against the backward's kernels in one profiled step; (c)
   ZeRO with ``overlap="on"`` (5 steps): per-step fingerprints equal to the
   zero phase's serialized run, its state exactly half the replicated run's,
   its peak no higher; on the 4-layer cut, (d) the chunked ring
   (``overlap_chunk_bytes`` 1 MiB) within 1e-5 of the fused allreduce's
   losses, and the int8 (K3) and 1-bit (K4, K5) chunked rings with exact
   launches and the first sub-chunk encode of their last step on the comm
   worker equal to plain; (e) every eager collective on card tensors.

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
#: heads above 256, timed at slice 1's seq (no configuration of the repo has one)
WIDE = dict(bh=4)
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


def device_kernels(fn, unique=True):
    """Names of the device kernels one call of ``fn`` runs (one profiler
    window), so that a yardstick's implementation is on record; with
    ``unique`` False, one name a launch, in order."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sorted(set(names)) if unique else names


def kernels_a_call(label, fns, single, calls=3):
    """Logs the device kernels a call of each codec wrapper of ``fns`` (name
    -> call) runs; fails unless each one named in ``single`` runs exactly one
    a call."""
    from bagua_tpu_torch.ops import _build

    for name, fn in fns.items():
        fn()   # built and warm
        kernels = _build.kernels_of_calls(fn, calls)
        log(f"{label}: {name} runs {len(kernels) / calls:g} device kernel(s) a call: "
            f"{sorted(set(kernels))}")
        if name in single and len(kernels) != calls:
            raise AssertionError(f"{name} must be one launch a call, ran {kernels} in "
                                 f"{calls} calls")


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


def time_wide_head(bh, s, d):
    """The wide kernels' times at a head above 256 (bf16, causal), each
    beside its bound, and SDPA's forward and forward + backward on the same
    inputs (its kernels named: which backend takes such a head)."""
    from bagua_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _inputs(bh, s, d, torch.bfloat16, seed=d)
    o, lse = fa.flash_fwd(q, k, v, True)
    delta = (do.float() * o.float()).sum(dim=-1)
    fns = {"flash_fwd": lambda: fa.flash_fwd(q, k, v, True),
           "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, True),
           "flash_bwd_dq": lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, True)}
    ms = {n: cuda_ms(fn, 3) for n, fn in fns.items()}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4, do4 = (x.view(1, bh, s, d) for x in (q, k, v, do))
    qg, kg, vg = (x.clone().requires_grad_() for x in (q4, k4, v4))

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(qg, kg, vg, is_causal=True), (qg, kg, vg), do4)

    sdpa_ms = cuda_ms(lambda: sdpa(q4, k4, v4, is_causal=True), 3)
    sdpa_train_ms = cuda_ms(sdpa_fwd_bwd, 3)
    log(f"wide head bh={bh} s={s} d={d} bf16 causal: "
        + ", ".join(f"{n} {t:.4f} ms (bound {bound(n, bh, s, d, torch.bfloat16, True)[0]:.4f})"
                    for n, t in ms.items())
        + f"; sdpa forward {sdpa_ms:.4f} ms, sdpa fwd+bwd {sdpa_train_ms:.4f} ms (flash "
        f"{sum(ms.values()):.4f}); sdpa kernels "
        f"{device_kernels(lambda: sdpa(q4, k4, v4, is_causal=True))}")


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
    # heads above 256 (the wide kernels), in every dtype, ragged and not
    check_kernels(4, 1000, 384, torch.bfloat16, True, seed=22)
    check_kernels(4, 1000, 512, torch.bfloat16, True, seed=23)
    check_kernels(3, 333, 384, torch.float16, False, seed=24)
    check_kernels(2, 256, 512, torch.float32, True, seed=25)
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
    for d_ in (384, 512):
        time_wide_head(WIDE["bh"], s, d_)
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


def slice_model(name, attn_fn=None, gmm_fn=None, remat=False, remat_policy=None):
    """The model of slice ``name``, weights from seed 0: ``"longctx"`` the
    long-context LM of ``bench_longctx``, ``"moe"`` the dropless MoE LM of
    ``bench_moe_longseq`` (a ``MoEMLP`` in every odd layer).  ``attn_fn`` and
    ``gmm_fn`` replace the attention and the grouped matmul (for example with
    their plain versions); ``remat`` and ``remat_policy`` are the model's
    rematerialization knobs."""
    from bagua_tpu_torch.model_parallel.moe import MoEMLP
    from bagua_tpu_torch.models.transformer import TransformerConfig, TransformerLM

    knobs = dict(remat=remat, remat_policy=remat_policy)
    if name == "moe":
        cfg = TransformerConfig(vocab_size=32768, d_model=MOE["d_model"], n_heads=MOE["h"],
                                n_layers=4, d_ff=MOE["d_ff"], max_seq_len=MOE["s"], **knobs)
        moe = lambda: MoEMLP(MOE["experts"], cfg.d_ff, d_model=cfg.d_model, k=MOE["k"],
                             dropless=True, gmm_fn=gmm_fn)
        factory = lambda i: moe if i % 2 == 1 else None
    else:
        cfg = TransformerConfig(vocab_size=32768, d_model=MAIN["h"] * MAIN["d"],
                                n_heads=MAIN["h"], n_layers=4, d_ff=4096,
                                max_seq_len=MAIN["s"], **knobs)
        factory = None
    return TransformerLM(cfg, seed=0, attn_fn=attn_fn, mlp_factory=factory)


def build_slice(name, remat=False, remat_policy=None):
    """Slice ``name``'s model (with the given rematerialization), its
    ``BaguaTrainer`` (GradientAllReduce; AdamW for ``"longctx"``, Adam and the
    load-balancing loss for ``"moe"``), the initial state and one fixed random
    batch (seed 1).  Needs the process group."""
    import bagua_tpu_torch as bt

    model = slice_model(name, remat=remat, remat_policy=remat_policy)
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


def train_steps(trainer, state, batch, tokens_per_step, modules, after_step=None, steps=STEPS):
    """``steps`` training steps with every launch count of ``modules`` set to
    0 just before and read just after; returns the losses, the launches by
    kernel, the step statistics and the last state.  ``after_step(state)``
    runs after each step, outside the steps' times, and launches none of
    ``modules``' kernels."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in modules:
        mod.reset_launch_counts()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, loss = trainer.train_step(state, batch)
        losses.append(loss.item())   # synchronizes
        times.append(time.perf_counter() - t0)
        if after_step is not None:
            after_step(state)
    launches = {k.__name__: k.launches for mod in modules for k in mod.KERNELS}
    # step 1 pays the allocator's and the libraries' warm-up; the rest is
    # one window, so a slow step in it counts in full
    window_s = sum(times[1:])
    stats = {
        "step_ms": window_s / (steps - 1) * 1e3,
        "tokens_s": (steps - 1) * tokens_per_step / window_s,
        "median_ms": statistics.median(times[1:]) * 1e3,
        "first_ms": times[0] * 1e3,
        "times_ms": [t * 1e3 for t in times],
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "layout": "resident" if trainer._flat_resident else "leaf",
    }
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    return losses, launches, stats, state


def log_steps(name, losses, launches, st):
    log(f"{name} losses: {losses}")
    log(f"{name}: step {st['step_ms']:.3f} ms (steps 2-{len(losses)} as one window; median "
        f"step {st['median_ms']:.3f} ms; first {st['first_ms']:.3f} ms), "
        f"{st['tokens_s']:.1f} tokens/s, peak memory {st['peak_gb']:.3f} GB ({st['layout']} "
        f"layout), launches {launches}")


def check_reductions():
    """Every ``ReduceOp`` through the global communicator on the card: NCCL at
    world 1, where each reduction of one rank is its operand, bit for bit
    (AVG divides by 1).  SUM, AVG, MIN, MAX and PRODUCT on f32 run NCCL's own
    reductions; BOR, BAND and BXOR on int32 its gather, then the local fold
    (NCCL has no bitwise reductions).  Nothing stages through the host."""
    import bagua_tpu_torch as bt

    comm = bt.get_backend().global_communicator
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(1 << 20, device="cuda", generator=g)
    i = torch.randint(0, 2 ** 30, (1 << 20,), device="cuda", dtype=torch.int32, generator=g)
    bitwise = (bt.ReduceOp.BOR, bt.ReduceOp.BAND, bt.ReduceOp.BXOR)
    staged0 = comm.host_staged_bytes
    results = {}
    for op in bt.ReduceOp:
        src = i if op in bitwise else x
        results[op.name] = torch.equal(comm.allreduce(src.clone(), op), src)
    staged = comm.host_staged_bytes - staged0
    log(f"reductions on {torch.distributed.get_backend()} at world "
        f"{comm.nranks()} (f32, int32 for the bitwise ops, 2^20 elements): {results}, "
        f"staged {staged} bytes")
    if not all(results.values()) or staged:
        raise AssertionError(f"reductions on the card: {results}, staged {staged}")


def phase_slice():
    """The port's first path: BaguaTrainer over the long-context LM."""
    import bagua_tpu_torch as bt
    from bagua_tpu_torch.ops import flash_attention as fa

    bt.init_process_group()
    check_reductions()
    eager_checks(0, 1, torch.device("cuda"), "slice 1")
    model, trainer, state, batch = build_slice("longctx")
    cfg, tokens = model.cfg, batch["tokens"]
    n_params = sum(p.numel() for p in model.parameters())
    log(f"slice: {n_params} params in {len(trainer.plan.buckets)} buckets, "
        f"world {trainer.world_size} over {torch.distributed.get_backend()}")

    losses, launches, st, state = train_steps(trainer, state, batch,
                                              MAIN["b"] * cfg.max_seq_len, [fa])
    log_steps("slice", losses, launches, st)
    want = cfg.n_layers * STEPS
    if any(n != want for n in launches.values()):
        raise AssertionError(f"kernel launches {launches}, expected {want} each")
    # what the remat phase holds its run against: the losses, the peak, the
    # parameters after the steps and (last) the kernels' device time of one more
    base = {"losses": losses, "stats": st, "params": _params_on_host(model)}

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
    base["kernel_ms"] = kernel_step_ms(trainer, state, batch)
    return launches, base


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

    losses, launches, st, state = train_steps(trainer, state, batch,
                                              MOE["b"] * cfg.max_seq_len, [fa, gm])
    log_steps("slice 2", losses, launches, st)
    base = {"losses": losses, "stats": st, "params": _params_on_host(model)}
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
    base["kernel_ms"] = kernel_step_ms(trainer, state, batch)
    return launches, st, base


# ---------------------------------------------------------------------------
# remat: slices 1 and 2 under their benches' rematerialization
# ---------------------------------------------------------------------------

#: the flash and gmm kernels by their device names (profiler events)
KERNEL_NAMES = re.compile(r"(?<![A-Za-z0-9_])(fwd|dkv|dq|gmm_drhs|gmm)_"
                          r"(?:wgmma_narrow_|wgmma_|wide_|f32_)?kernel")
KERNEL_OF = {"fwd": "flash_fwd", "dkv": "flash_bwd_dkv", "dq": "flash_bwd_dq",
             "gmm": "grouped_matmul", "gmm_drhs": "grouped_matmul_drhs"}
#: slice -> remat policy, as its bench sets it: ``bench_longctx`` saves the
#: matmuls without batch dimensions (``bench.py:586-590``),
#: ``bench_moe_longseq`` recomputes whole blocks at seq 4096 (``bench.py:294``)
REMAT = {"longctx": "dots_no_batch", "moe": None}


def _params_on_host(model):
    return {n: p.detach().cpu().clone() for n, p in model.named_parameters()}


def kernel_step_ms(trainer, state, batch):
    """Device milliseconds of each flash and gmm kernel in one training step
    (one profiler window over the step); the step's state is dropped."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        _, loss = trainer.train_step(state, batch)
        loss.item()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            m = KERNEL_NAMES.search(e.name)
            if m:
                key = KERNEL_OF[m.group(1)]
                out[key] = out.get(key, 0.0) + e.time_range.elapsed_us() / 1e3
    return out


def phase_remat(bases):
    """Slices 1 and 2 again, each under its bench's remat (``REMAT``), from
    the same weights, batch and optimizer, against the run without remat of
    the same call (``bases``): exact launches (every block's forward runs
    twice, so the flash forward launches ``2 * n_layers`` a step and the gmm
    forward of a MoE layer four times, its backward ones as before), losses
    finite and falling, the first step's loss bitwise equal, the parameters'
    updates within the bf16 tolerance of the kernels' checks (``TOL``; the
    log says whether bitwise), and the peak below.  Prints step time, peak and
    the kernels' device time a step beside the run without remat."""
    import bagua_tpu_torch as bt
    from bagua_tpu_torch.ops import flash_attention as fa
    from bagua_tpu_torch.ops import gmm as gm

    bt.init_process_group()
    out = {}
    for name, base in bases.items():
        model, trainer, state, batch = build_slice(name, remat=True, remat_policy=REMAT[name])
        cfg = model.cfg
        p0 = _params_on_host(model)
        tokens = (MOE["b"] if name == "moe" else MAIN["b"]) * cfg.max_seq_len
        losses, launches, st, state = train_steps(trainer, state, batch, tokens,
                                                  [fa, gm] if name == "moe" else [fa])
        label = f"remat {name} (policy {REMAT[name]})"
        log_steps(label, losses, launches, st)
        layer_steps = cfg.n_layers * STEPS
        want = {"flash_fwd": 2 * layer_steps, "flash_bwd_dkv": layer_steps,
                "flash_bwd_dq": layer_steps}
        if name == "moe":
            n_moe = cfg.n_layers // 2
            # 2 forward, 2 again in the recompute, 2 d_lhs; d_rhs unchanged
            want.update({"grouped_matmul": 6 * n_moe * STEPS,
                         "grouped_matmul_drhs": 2 * n_moe * STEPS})
        if launches != want:
            raise AssertionError(f"{label}: launches {launches}, expected {want}")
        params = _params_on_host(model)
        bitwise = all(torch.equal(params[n], base["params"][n]) for n in params)
        upd = torch.cat([(params[n] - p0[n]).reshape(-1) for n in params])
        base_upd = torch.cat([(base["params"][n] - p0[n]).reshape(-1) for n in params])
        err = rel_err(upd, base_upd)
        del params, upd, base_upd, p0
        kernel_ms = kernel_step_ms(trainer, state, batch)
        bst = base["stats"]
        log(f"{label}: first loss {losses[0]!r} against {base['losses'][0]!r} without remat "
            f"({'bitwise equal' if losses[0] == base['losses'][0] else 'DIFFERENT'}); "
            f"parameters after {STEPS} steps {'bitwise equal to' if bitwise else 'differ from'} "
            f"the run without remat, updates within {err:.3g} of its largest; step "
            f"{st['step_ms']:.3f} ms against {bst['step_ms']:.3f} ms "
            f"({st['step_ms'] / bst['step_ms'] - 1:+.2%}), peak {st['peak_gb']:.3f} GB against "
            f"{bst['peak_gb']:.3f} GB ({st['peak_gb'] - bst['peak_gb']:+.3f} GB); kernels' "
            f"device ms a step {json.dumps({k: round(v, 4) for k, v in kernel_ms.items()})} "
            f"against {json.dumps({k: round(v, 4) for k, v in base['kernel_ms'].items()})}")
        if not (losses[0] == base["losses"][0] and err <= TOL[torch.bfloat16]
                and st["peak_gb"] < bst["peak_gb"]):
            raise AssertionError(f"{label}: first loss {losses[0]} vs {base['losses'][0]}, "
                                 f"update error {err}, peak {st['peak_gb']} vs {bst['peak_gb']}")
        out[name] = {"launches": launches, "stats": st, "bitwise": bitwise, "update_err": err,
                     "kernel_ms": kernel_ms}
        del model, trainer, state, batch
        release()
    return out


def release():
    """Free what the last phase or run left (objects in reference cycles
    included) and return the cached blocks to the card, so that the next
    run's peak counts its own memory only."""
    gc.collect()
    torch.cuda.empty_cache()


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

    def check(x, label, chunks=n):
        finite, outs, e = check_codec(x, chunks, label)
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
    # K3's edges: a chunk of -0.0 (its max is +0.0), and +inf, -inf and a NaN
    # in one chunk of the path's length (NaN) beside ±inf alone (inf)
    x = randn(n * 50001)
    x[:50001] = -0.0
    _, (_, _, am) = check(x, "-0.0")
    if am[0].view(torch.int32).item() != 0:
        raise AssertionError(f"a chunk of -0.0 must give an absmax of +0.0, got {am[0]}")
    x = randn(n * path_m)
    x[5], x[path_m // 2], x[path_m - 1] = float("inf"), float("-inf"), float("nan")
    x[path_m + 9], x[2 * path_m - 3] = float("-inf"), float("inf")
    _, (_, _, am) = check(x, "±inf and NaN")
    if not (am[0].isnan() and am[1].item() == float("inf")):
        raise AssertionError(f"±inf with a NaN must give NaN, ±inf alone inf: {am}")

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
            f"{k} {a:.5f} ms, cold L2 {cold[label][k]:.5f} ms, bound "
            f"{codec_bound(k, 1 if k == 'absmax_chunked' else n, m)[0]:.5f} (plain {b:.4f}, "
            f"{'kernel' if a < b else 'PLAIN'} faster)"
            for k, (a, b) in times[label].items()))
        if label == "bucket chunk 5 MiB":
            kernels_a_call(f"codec chunk {label}", {k: kern for k, (kern, _) in fns.items()},
                           ("compress_chunked", "absmax_chunked"))
    # K1 on the embedding bucket's chunk: more than the grid holds in shared
    # memory, so the part that does not fit is read again
    x = randn(n * embed_m)
    k1 = lambda: cd.compress_chunked(x, n)
    log(f"codec timing embedding chunk ({embed_m} f32): compress_chunked "
        f"{cuda_ms(k1, 5):.5f} ms, cold L2 {cuda_ms_cold(k1, 5):.5f} ms, bound "
        f"{codec_bound('compress_chunked', n, embed_m)[0]:.5f} ms")
    del x
    # the low-precision gossip ring compresses a whole bucket as one chunk
    # (every SM of K1's grid on it): a 10 MiB bucket, and the embedding
    # bucket, more than the grid holds in shared memory
    for label, m in {"one-chunk bucket 10 MiB": CODEC_BUCKET_BYTES // 4,
                     "one-chunk embedding bucket": n * embed_m}.items():
        x = randn(m)
        check(x, label, chunks=1)
        mn, mx, p = cd.compress_chunked(x, 1)
        fns = {"compress_chunked": (lambda: cd.compress_chunked(x, 1),
                                    lambda: cd.compress_chunked_plain(x, 1)),
               "decompress_chunked": (lambda: cd.decompress_chunked(mn, mx, p),
                                      lambda: cd.decompress_chunked_plain(mn, mx, p))}
        log(f"codec timing {label} (1 x {m} f32): " + ", ".join(
            f"{k} {cuda_ms(kern, 10):.5f} ms, cold L2 {cuda_ms_cold(kern, 5):.5f} ms, plain "
            f"{cuda_ms(plain, 3):.4f} ms, bound {codec_bound(k, 1, m)[0]:.5f} ms"
            for k, (kern, plain) in fns.items()))
        del x, mn, mx, p
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
            f"{k} {a:.5f} ms, cold L2 {cold[label][k]:.5f} ms, bound "
            f"{sign_bound(k, n, m)[0]:.5f} (plain {b:.4f}, "
            f"{'kernel' if a < b else 'PLAIN'} faster)"
            for k, (a, b) in times[label].items()))
        if label == "ring chunk 5 MiB":
            kernels_a_call(f"sign chunk {label}", {k: kern for k, (kern, _) in fns.items()},
                           ("sign_compress_chunked",))
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

#: steps of the multi-rank runs (a step costs 0.2-6 s through gloo on the
#: shared card); QAdam's run keeps ``STEPS`` for its warmup, the async and
#: features phases' cut runs for their schedules
FULL_STEPS = 5
#: (name, layers, algorithm, BaguaTrainer keywords).  Slice 3: (a) ByteGrad on
#: the full BERT-Large, (b) the forced int8 and fp8 rings and (c) QAdam on a
#: 4-layer cut of it
SLICE3_RUNS = (
    ("bytegrad", None, "bytegrad", {"steps": FULL_STEPS}),
    ("int8", BERT["cut_layers"], "gradient_allreduce",
     {"compress_intra": "int8", "steps": FULL_STEPS}),
    ("fp8_e4m3", BERT["cut_layers"], "gradient_allreduce",
     {"compress_intra": "fp8_e4m3", "steps": FULL_STEPS}),
    ("qadam", BERT["cut_layers"], "qadam", {}),
)
#: slice 4 at world 2: (a) the main path, the README quick start with the
#: 1-bit codec on the full BERT-Large, (b) top-k (1%) on the 4-layer cut
SLICE4_RUNS = (
    ("onebit_ef", None, "gradient_allreduce", {"compress_intra": "onebit_ef", "steps": FULL_STEPS}),
    ("topk", BERT["cut_layers"], "gradient_allreduce",
     {"compress_intra": "topk", "steps": FULL_STEPS}),
)
#: slice 4 at world 4, two nodes of two ranks, on the 4-layer cut: (a) the
#: two-level allreduce with the 1-bit codec on the inter-node tier, (b)
#: ByteGrad at its default hierarchical=True (MinMaxUInt8 on that tier)
SLICE4_2X2_RUNS = (
    ("hier_onebit_ef", BERT["cut_layers"], "hierarchical",
     {"compress_inter": "onebit_ef", "steps": FULL_STEPS}),
    ("bytegrad_2x2", BERT["cut_layers"], "bytegrad_default", {"steps": FULL_STEPS}),
    ("zero_2x2", BERT["cut_layers"], "zero_hierarchical", {"steps": FULL_STEPS}),
)
#: ZeRO-1 at world 2: (a) the full BERT-Large, its optimizer state sharded,
#: beside (b) the replicated run it must halve that state of; (c) the 4-layer
#: cut through the int8 ring.  (c) runs AdamW at 1e-3: its gather sends the
#: parameters through the codec, and an AdamW step of 1e-4 is below half of
#: the int8 grid step of every chunk of the weights (absmax / 127: 6.7e-4 to
#: 1.3e-3 for 1.3 M draws of N(0, 1 / fan_in), 7.9e-3 where a norm scale of 1
#: shares the chunk), so at 1e-4 the decoded parameters would not move, in
#: the JAX package's ZeRO as in the port
ZERO_RUNS = (
    ("zero", None, "zero", {"steps": FULL_STEPS}),
    ("replicated", None, "gradient_allreduce", {"steps": FULL_STEPS}),
    ("zero_int8", BERT["cut_layers"], "zero", {"compress_intra": "int8", "lr": 1e-3}),
)
#: the gossip families at world 2 on the full BERT-Large: (a) full-precision
#: ``all`` with the peer weights tracked (no codec), (b) the low-precision
#: ring, flat (a whole bucket one K1 chunk)
DECENTRALIZED_RUNS = (
    ("decentralized_all", None, "decentralized_all", {"steps": FULL_STEPS}),
    ("low_precision", None, "low_precision", {"steps": FULL_STEPS}),
)
#: the gossip families at world 4, two nodes of two ranks, on the 4-layer
#: cut: (a) ``shift_one`` over the four ranks, the partner rotating with the
#: step, (b) the low-precision ring hierarchical: the intra-node average,
#: then the ring over the two nodes
DECENTRALIZED_4_RUNS = (
    ("shift_one", BERT["cut_layers"], "shift_one", {"steps": FULL_STEPS}),
    ("low_precision_2x2", BERT["cut_layers"], "low_precision_2x2", {"steps": FULL_STEPS}),
)
#: async model average at world 2: (a) the full BERT-Large with the bench's
#: ``AsyncModelAverageAlgorithm(sync_interval_ms=100)`` (``bench.py:88``); on
#: the 4-layer cut, (b) a pinned period of 2 after 2 warmup steps with
#: ``async.partition`` armed on rank 1 alone under a staleness cap of 2, and
#: (c) a period of 1, rank 0 aborting after step ``ASYNC_ABORT_AFTER`` and
#: rank 1 resuming after step ``ASYNC_RESUME_AFTER``
ASYNC_RUNS = (
    ("async", None, "async", {}),
    ("async_partition", BERT["cut_layers"], "async_partition", {}),
    ("async_abort", BERT["cut_layers"], "async_abort", {}),
)
ASYNC_ABORT_AFTER, ASYNC_RESUME_AFTER = 3, 6
#: the trainer's step features at world 2: (a) the full BERT-Large ZeRO on the
#: leaf layout, beside the zero phase's ZeRO, which the default makes
#: resident; (b) the full BERT-Large with GradientAllReduce, two microbatches
#: of 4 of a rank's 8 rows and the guard on ``skip``, no fault; on the 4-layer
#: cut, (c) the 1-bit ring under the guard: two clean runs of
#: ``POISON_STEPS - 1`` steps and one of ``POISON_STEPS`` with ``grad.poison``
#: at step ``POISON_AT``; (d) full precision, resident, without and with a
#: rebucket from 10 MiB to ``REBUCKET_BYTES`` buckets after step
#: ``REBUCKET_AFTER``, then the same rebucket under the 1-bit ring.  The two
#: full BERT-Large runs take ``FULL_STEPS`` steps, held against the first
#: steps of the zero phase's runs (each costs 2-6 s a step through gloo)
POISON_AT, POISON_STEPS = 4, STEPS
REBUCKET_AFTER, REBUCKET_BYTES = 5, 2 * 1024 ** 2
FEATURES_RUNS = (
    ("zero_leaf", None, "zero", {"flat_resident": "off", "steps": FULL_STEPS}),
    ("accum_guard", None, "gradient_allreduce",
     {"accum_steps": 2, "grad_guard": "skip", "steps": FULL_STEPS}),
    ("onebit_clean", BERT["cut_layers"], "gradient_allreduce",
     {"compress_intra": "onebit_ef", "grad_guard": "skip", "steps": POISON_STEPS - 1}),
    ("onebit_clean_again", BERT["cut_layers"], "gradient_allreduce",
     {"compress_intra": "onebit_ef", "grad_guard": "skip", "steps": POISON_STEPS - 1}),
    ("onebit_poison", BERT["cut_layers"], "gradient_allreduce",
     {"compress_intra": "onebit_ef", "grad_guard": "skip", "poison": POISON_AT,
      "steps": POISON_STEPS}),
    ("no_rebucket", BERT["cut_layers"], "gradient_allreduce", {}),
    ("rebucket", BERT["cut_layers"], "gradient_allreduce", {"rebucket": True}),
    ("onebit_rebucket", BERT["cut_layers"], "gradient_allreduce",
     {"compress_intra": "onebit_ef", "rebucket": True}),
)
#: the overlap phase at world 2 (``OVERLAP_RUNS``): (a) the full BERT-Large
#: with GradientAllReduce, two microbatches of 4, serialized then overlapped;
#: (b) ByteGrad overlapped, then serialized on the overlapped run's plan (the
#: readiness rebucket moves the codec's chunks, so a bitwise comparison needs
#: one plan); (c) ZeRO overlapped, against the zero phase's serialized run;
#: on the 4-layer cut, (d) the fused allreduce, then the chunked rings of
#: ``OVERLAP_CHUNK_BYTES`` sub-rings in full precision, under int8 (K3) and
#: under the 1-bit codec (K4, K5); (e) every eager collective on card tensors
OVERLAP_CHUNK_BYTES = 1 << 20
OVERLAP_RUNS = (
    ("ga_serial", None, "gradient_allreduce",
     {"accum_steps": 2, "overlap": "off", "steps": FULL_STEPS}),
    ("ga_overlap", None, "gradient_allreduce",
     {"accum_steps": 2, "overlap": "on", "steps": FULL_STEPS}),
    ("bytegrad_overlap", None, "bytegrad", {"overlap": "on", "steps": FULL_STEPS}),
    ("bytegrad_serial", None, "bytegrad",
     {"overlap": "off", "steps": FULL_STEPS, "plan_of": "bytegrad_overlap"}),
    ("zero_overlap", None, "zero", {"overlap": "on", "steps": FULL_STEPS}),
    ("ring_fused", BERT["cut_layers"], "gradient_allreduce",
     {"overlap": "off", "steps": FULL_STEPS}),
    ("ring_chunked", BERT["cut_layers"], "gradient_allreduce",
     {"overlap": "on", "overlap_chunk_bytes": OVERLAP_CHUNK_BYTES, "steps": FULL_STEPS}),
    ("ring_int8", BERT["cut_layers"], "gradient_allreduce",
     {"overlap": "on", "overlap_chunk_bytes": OVERLAP_CHUNK_BYTES, "compress_intra": "int8",
      "steps": FULL_STEPS}),
    ("ring_onebit", BERT["cut_layers"], "gradient_allreduce",
     {"overlap": "on", "overlap_chunk_bytes": OVERLAP_CHUNK_BYTES,
      "compress_intra": "onebit_ef", "steps": FULL_STEPS}),
    ("eager", None, "eager", {}),
)
#: the chunked ring's losses against the fused allreduce's (relative, every
#: step): at world 2 a sub-ring adds the same two values, so they agree
#: exactly; more ranks would add them in another order
RING_LOSS_RTOL = 1e-5
#: the least drop of the peak from the leaf layout to the resident one, ZeRO
#: on the full BERT-Large (GB): the chunk copy a rank (0.931 GB) that the
#: resident layout does without
RESIDENT_PEAK_DROP_GB = 0.9
#: the features runs' tolerance of the accumulated losses against the
#: replicated run of the zero phase (relative, every step)
ACCUM_LOSS_RTOL = 1e-2
#: the multi-rank phases: name -> (label, runs, world, intra-node size)
MULTI_RANK = {
    "slice3": ("slice 3", SLICE3_RUNS, CODEC_WORLD, None),
    "slice4": ("slice 4", SLICE4_RUNS, CODEC_WORLD, None),
    "slice4_2x2": ("slice 4 (2 x 2)", SLICE4_2X2_RUNS, 4, 2),
    "zero": ("zero", ZERO_RUNS, CODEC_WORLD, None),
    "decentralized": ("decentralized", DECENTRALIZED_RUNS, CODEC_WORLD, None),
    "decentralized_4": ("decentralized (2 x 2)", DECENTRALIZED_4_RUNS, 4, 2),
    "async": ("async", ASYNC_RUNS, CODEC_WORLD, None),
    "features": ("features", FEATURES_RUNS, CODEC_WORLD, None),
    "overlap": ("overlap", OVERLAP_RUNS, CODEC_WORLD, None),
}
QADAM_WARMUP = 2
#: seconds a multi-rank phase may take before its ranks are killed
WORKER_TIMEOUT = 420


def _adamw(lr=1e-4):
    """``bench_bert``'s AdamW."""
    return functools.partial(torch.optim.AdamW, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def _algorithm(name, lr=1e-4):
    import bagua_tpu_torch as bt

    if name in ("zero", "zero_hierarchical"):
        return bt.ZeroOptimizerAlgorithm(_adamw(lr), hierarchical=name == "zero_hierarchical")
    if name in ("decentralized_all", "shift_one"):
        mode = "all" if name == "decentralized_all" else "shift_one"
        return bt.DecentralizedAlgorithm(hierarchical=False, peer_selection_mode=mode,
                                         track_peer_weights=True)
    if name in ("low_precision", "low_precision_2x2"):
        return bt.LowPrecisionDecentralizedAlgorithm(hierarchical=name == "low_precision_2x2")
    if name == "async":
        return bt.AsyncModelAverageAlgorithm(sync_interval_ms=100)
    if name == "async_partition":
        return bt.AsyncModelAverageAlgorithm(warmup_steps=2, period_steps=2,
                                             max_staleness_rounds=2)
    if name == "async_abort":
        return bt.AsyncModelAverageAlgorithm(period_steps=1)
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


def _want_launches(algo_name, kw, n_layers, n_buckets, steps=STEPS):
    """Each codec and flash kernel's launches in ``steps`` steps.  Per bucket
    and step: ByteGrad's and QAdam's scatter-gather one K1 and two K2; the
    two-level ByteGrad's inter-node ring at n = 2 one hop and the allgather's
    encode, two K1 and two K2; the int8/fp8 rings at world 2 two K3 (the
    allreduce's, and ZeRO's: one on the scatter hop, one on the gather); the
    1-bit codec's error-feedback step one K4 and one K5, its ring at n = 2
    two more of each (one hop, then the allgather's encode and the decode of
    the gathered parts); the low-precision gossip ring one K1 (the bucket's
    ``diff`` as one chunk) and three K2 (from the left, from the right, its
    own); top-k and the full-precision gossip none."""
    from bagua_tpu_torch.ops import codec as cd

    want = {k.__name__: 0 for k in cd.KERNELS}
    want.update({k: n_layers * steps for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")})
    codec = kw.get("compress_intra") or kw.get("compress_inter")
    if algo_name in ("bytegrad", "qadam"):
        codec_steps = steps - QADAM_WARMUP if algo_name == "qadam" else steps
        want["compress_chunked"] = n_buckets * codec_steps
        want["decompress_chunked"] = 2 * n_buckets * codec_steps
    elif algo_name == "bytegrad_default":
        want["compress_chunked"] = want["decompress_chunked"] = 2 * n_buckets * steps
    elif algo_name in ("low_precision", "low_precision_2x2"):
        want["compress_chunked"] = n_buckets * steps
        want["decompress_chunked"] = 3 * n_buckets * steps
    elif codec in ("int8", "fp8_e4m3"):
        want["absmax_chunked"] = 2 * n_buckets * steps
    elif codec == "onebit_ef":
        want["sign_compress_chunked"] = want["sign_decompress_chunked"] = 3 * n_buckets * steps
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


def optimizer_state_bytes(opt) -> int:
    """Bytes of an optimizer's per-element state on this rank: every state
    tensor shaped like its parameter (AdamW's two moments), not the step
    counters."""
    return sum(t.numel() * t.element_size() for p, st in opt.state.items()
               for t in st.values() if torch.is_tensor(t) and t.shape == p.shape)


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


def fingerprints(groups):
    """64-bit fingerprints of lists of f32 flats, computed on their device:
    the sum, wrapping modulo 2^64, of every element's bits times an odd
    pseudo-random 64-bit weight of its index (the same weights on every
    rank, from a seed; made anew each call, so that they hold no memory
    between calls).  Flats that differ in one element always differ here
    (the difference of the bits times an odd weight is not a multiple of
    2^64); more differences collide with a chance of about 2^-64."""
    flats = [f for fl in groups.values() for f in fl]
    g = torch.Generator(device=flats[0].device).manual_seed(7)
    weights = torch.randint(-2 ** 62, 2 ** 62, (max(f.numel() for f in flats),), generator=g,
                            dtype=torch.int64, device=flats[0].device) | 1
    return {key: torch.stack([(f.view(torch.int32).long() * weights[:f.numel()]).sum()
                              for f in fl]).tolist() for key, fl in groups.items()}


def _gossip_trace(trainer, model):
    """``(trace, after_step)``: ``after_step(state)`` appends the
    fingerprints of every bucket flat of the parameters (``params``) and of
    the gossip state (``peer_weights``; ``left``, ``right``, ``self``) to
    ``trace[key]``, one list of buckets a step."""
    trace = {}

    @torch.no_grad()
    def after_step(state):
        flats = {"params": trainer.plan.flatten(dict(model.named_parameters())),
                 **state.algo_state}
        for key, fp in fingerprints(flats).items():
            trace.setdefault(key, []).append(fp)

    return trace, after_step


def _check_lowprec_bucket(rank, trainer, state, model, record):
    """The low-precision ring's compress and decompress through the kernels
    against the plain codec (CPU tensors take it) on the ``diff`` of the
    run's last state, in a bucket of the middle and in the embedding bucket
    (the largest), each one chunk: sidecars, payload bytes and decoded
    values equal."""
    from bagua_tpu_torch.compression import compress_chunked, decompress_chunked

    buckets, st = trainer.plan.buckets, state.algo_state
    with torch.no_grad():
        params = trainer.plan.flatten(dict(model.named_parameters()))
    record["plain_buckets"] = []
    for i in (len(buckets) // 2, max(range(len(buckets)), key=lambda j: buckets[j].padded_numel)):
        diff = params[i] + st["left"][i] / 3.0 + st["right"][i] / 3.0 - (5.0 / 3.0) * st["self"][i]
        got = compress_chunked(diff, 1)
        got = (*got, decompress_chunked(*got))
        want = compress_chunked(diff.cpu(), 1)
        want = (*want, decompress_chunked(*want))
        equal = all(same(a.cpu(), b) for a, b in zip(got, want))
        record["plain_buckets"].append({"index": i, "numel": diff.numel(), "equal": equal})
        log(f"[rank {rank}] bucket {i} ({diff.numel()} elements as one chunk) compressed and "
            f"decoded through the kernels vs the plain codec: {'equal' if equal else 'DIFFERS'}")
        if not equal:
            raise AssertionError(f"[rank {rank}] the kernels' codec of bucket {i}'s diff "
                                 f"differs from the plain codec's")


def _build_run(rank, world, run, device):
    """A run's BERT-Large (or its cut), algorithm, trainer, initial state and
    this rank's batch; returns them with the run's trainer keywords."""
    import bagua_tpu_torch as bt

    name, layers, algo_name, kw = run
    kw = dict(kw)
    lr = kw.pop("lr", 1e-4)
    cfg = bt.bert_large_config(max_seq_len=BERT["s"],
                               **({} if layers is None else {"n_layers": layers}))
    model = bt.TransformerLM(cfg, device=device, seed=0)
    algo = _algorithm(algo_name, lr)
    trainer = bt.BaguaTrainer(bt.lm_loss_fn, _adamw(lr), algo, device=device, **kw)
    state = trainer.init(model)
    # each rank feeds its own slice of one global batch (seed 1)
    g = torch.Generator(device=device).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (world * BERT["b"], cfg.max_seq_len + 1),
                           device=device, generator=g)
    batch = trainer.shard_batch({"tokens": tokens[rank * BERT["b"]:(rank + 1) * BERT["b"]]})
    return cfg, model, algo, trainer, state, batch, kw


def compressed_run(rank, world, run, device, label):
    """One run of a multi-rank slice on this rank; returns its record."""
    from bagua_tpu_torch.ops import codec as cd
    from bagua_tpu_torch.ops import flash_attention as fa

    name, layers, algo_name, kw = run
    kw = dict(kw)
    steps = kw.pop("steps", STEPS)
    cfg, model, algo, trainer, state, batch, kw = _build_run(
        rank, world, (name, layers, algo_name, kw), device)
    gossip = not algo.replicated_params
    trace, after_step = _gossip_trace(trainer, model) if gossip else (None, None)
    param_fps = []
    if name == "zero":   # the features phase holds its leaf-layout run against these
        def after_step(state):
            param_fps.append(param_fingerprints(trainer, model))
    staged0 = trainer.host_staged_bytes
    losses, launches, st, state = train_steps(trainer, state, batch,
                                              BERT["b"] * cfg.max_seq_len, [fa, cd], after_step,
                                              steps)
    staged = trainer.host_staged_bytes - staged0
    n_buckets = len(trainer.plan.buckets)
    ef = (state.algo_state or {}).get("ef")
    ef = None if ef is None else ef["buckets"]
    opt = state.opt_state.optimizer if algo.sharded_opt_state else state.optimizer
    record = {"name": name, "layers": cfg.n_layers, "buckets": n_buckets,
              "padded_numel": sum(b.padded_numel for b in trainer.plan.buckets),
              "opt_state_bytes": None if opt is None else optimizer_state_bytes(opt),
              "params": sum(p.numel() for p in model.parameters()), "losses": losses,
              "launches": launches, "stats": st, "host_staged_bytes": staged,
              "ef_norm": None if ef is None else sum(r.abs().sum().item() for r in ef),
              "ef_finite": ef is None or all(bool(r.isfinite().all()) for r in ef),
              # the gossip families' ranks differ by design: their own gates
              # read the per-step fingerprints instead
              "digests": None if gossip else _flat_digests(trainer, model),
              "fingerprints": trace, "hierarchical": algo.hierarchical,
              "peer_selection_mode": getattr(algo, "peer_selection_mode", None),
              "param_fingerprints": param_fps}
    record["fwd_bwd_ms"] = fwd_bwd_ms(model, batch)
    log(f"[rank {rank}] {label} {name}: {record['params']} params, {cfg.n_layers} layers, "
        f"{n_buckets} buckets; losses {losses}; residual L1 {record['ef_norm']}")
    want = _want_launches(algo_name, kw, cfg.n_layers, n_buckets, steps)
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
    if name == "low_precision":
        _check_lowprec_bucket(rank, trainer, state, model, record)
    return record


def async_run(rank, world, run, device, label):
    """One run of the async phase on this rank; returns its record.  After
    every step (outside the step times) it records the rounds launched and
    applied, the catch-ups, the negotiated status and how long the step's
    apply waited for its round (``async/round_wait_s``); rank 0 aborts and
    rank 1 resumes in the abort run, and ``async.partition`` is armed on
    rank 1 alone in the partition run.  After the window: each bucket's
    digest, the algorithm's ``barrier``, a timed round alone (every
    bucket's sum started at once and waited for, nothing else running), a
    timed ``sync_for_checkpoint`` (one blocking average of every bucket) and
    the digests again; the ranks pass a barrier before each timing.  Each
    catch-up of the staleness bound records the digests right after it."""
    import contextlib

    from bagua_tpu_torch.communication import barrier
    from bagua_tpu_torch.faults.inject import FaultSpec, fault_scope
    from bagua_tpu_torch.ops import codec as cd
    from bagua_tpu_torch.ops import flash_attention as fa
    from bagua_tpu_torch.telemetry import counters

    name, _, algo_name, _ = run
    cfg, model, algo, trainer, state, batch, kw = _build_run(rank, world, run, device)
    per_step = {k: [] for k in ("launched", "applied", "catchups", "status", "wait_s")}
    catchups = []
    catchup_sync = algo._catchup_sync

    def spy(tr, step, reason):
        catchup_sync(tr, step, reason)
        # the checkpoint's catch-up is timed below, and its digests follow it
        catchups.append({"step": step, "reason": reason, "digests": (
            _flat_digests(trainer, model) if reason == "staleness" else None)})

    algo._catchup_sync = spy
    waited = [counters.get("async/round_wait_s")]

    def after_step(state):
        step = len(per_step["status"]) + 1
        per_step["launched"].append(algo._rounds_launched)
        per_step["applied"].append(algo._rounds_applied)
        per_step["catchups"].append(len(catchups))
        per_step["status"].append(algo._status)
        wait = counters.get("async/round_wait_s")
        per_step["wait_s"].append(wait - waited[0])
        waited[0] = wait
        if name == "async_abort" and rank == 0 and step == ASYNC_ABORT_AFTER:
            algo.abort()
        if name == "async_abort" and rank == 1 and step == ASYNC_RESUME_AFTER:
            algo.resume()

    scope = (fault_scope(FaultSpec("async.partition", count=-1))
             if name == "async_partition" and rank == 1 else contextlib.nullcontext())
    staged0 = trainer.host_staged_bytes
    with scope:
        losses, launches, st, state = train_steps(
            trainer, state, batch, BERT["b"] * cfg.max_seq_len, [fa, cd], after_step)
    staged = trainer.host_staged_bytes - staged0
    n_buckets = len(trainer.plan.buckets)
    padded_numel = sum(b.padded_numel for b in trainer.plan.buckets)
    digests_window = _flat_digests(trainer, model)
    algo.barrier(trainer, state)
    # a round alone: the sum of every bucket's copy started at once, as a
    # launch does, and waited for at once, nothing else running
    with torch.no_grad():
        flats = trainer.plan.flatten(trainer._params)
    barrier()   # the ranks start each timed average together
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for work in [algo._avg_comm.allreduce_start(f) for f in flats]:
        work.wait()
    torch.cuda.synchronize(device)
    round_ms = (time.perf_counter() - t0) * 1e3
    del flats
    barrier()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    algo.sync_for_checkpoint(trainer, state)
    torch.cuda.synchronize(device)
    sync_ms = (time.perf_counter() - t0) * 1e3
    record = {"name": name, "layers": cfg.n_layers, "buckets": n_buckets,
              "padded_numel": padded_numel, "params": sum(p.numel() for p in model.parameters()),
              "opt_state_bytes": optimizer_state_bytes(state.optimizer), "losses": losses,
              "launches": launches, "stats": st, "host_staged_bytes": staged,
              "warmup_steps": algo.warmup_steps, "per_step": per_step, "catchups": catchups,
              "period": algo._period, "agreed_dt": algo._agreed_dt,
              "max_staleness_rounds": algo.max_staleness_rounds, "sync_ms": sync_ms,
              "round_ms": round_ms,
              "digests_window": digests_window, "digests": _flat_digests(trainer, model),
              "fingerprints": None, "fwd_bwd_ms": fwd_bwd_ms(model, batch)}
    log(f"[rank {rank}] {label} {name}: {record['params']} params, {cfg.n_layers} layers, "
        f"{n_buckets} buckets; losses {losses}; per step {per_step}")
    want = _want_launches(algo_name, kw, cfg.n_layers, n_buckets)
    if device.type == "cuda" and launches != want:
        raise AssertionError(f"[rank {rank}] {name}: launches {launches}, expected {want}")
    return record


def param_fingerprints(trainer, model, chunk=1 << 22):
    """One 64-bit fingerprint a bucket of the parameters, whatever their
    layout: the sum, wrapping modulo 2^64, over the bucket's tensors of each
    element's f32 bits times an odd pseudo-random weight drawn from the
    tensor's name and the element's index, in chunks of ``chunk`` elements
    (so that it holds no copy of a bucket; computed on the tensors'
    device).  A difference in one element always shows (as in
    :func:`fingerprints`)."""
    import zlib

    params = dict(model.named_parameters())
    out = []
    with torch.no_grad():
        for b in trainer.plan.buckets:
            total = torch.zeros((), dtype=torch.int64, device=params[b.tensors[0].name].device)
            for t in b.tensors:
                flat = params[t.name].detach().reshape(-1).view(torch.int32)
                for c, start in enumerate(range(0, flat.numel(), chunk)):
                    part = flat[start:start + chunk]
                    g = torch.Generator(device=part.device).manual_seed(
                        zlib.crc32(t.name.encode()) * 1009 + c)
                    w = torch.randint(-2 ** 62, 2 ** 62, (part.numel(),), generator=g,
                                      dtype=torch.int64, device=part.device) | 1
                    total += (part.long() * w).sum()
            out.append(total.item())
    return out


def features_run(rank, world, run, device, label):
    """One run of the features phase on this rank (``FEATURES_RUNS``);
    returns its record.  After every step (outside the step times) it takes
    the guard's verdict, the parameters' fingerprints (``zero_leaf``) and
    the rebucket (after step ``REBUCKET_AFTER``).  The cut's runs keep their
    final parameters (and residual) in this process, so that the later runs
    are compared with them here: ``onebit_clean_again`` and
    ``onebit_poison`` with ``onebit_clean``, ``rebucket`` with
    ``no_rebucket``.  ``accum_guard`` times the guard's own work (the
    verdict on the reduced gradient flats and its host read) after the
    run."""
    import contextlib

    from bagua_tpu_torch.bucket import split_bucket_by_bucket_size
    from bagua_tpu_torch.faults.inject import FaultSpec, fault_scope
    from bagua_tpu_torch.ops import codec as cd
    from bagua_tpu_torch.ops import flash_attention as fa
    from bagua_tpu_torch.telemetry import counters

    name, layers, algo_name, kw = run
    kw = dict(kw)
    steps, poison = kw.pop("steps", STEPS), kw.pop("poison", None)
    rebucket = kw.pop("rebucket", False)
    cfg, model, algo, trainer, state, batch, kw = _build_run(
        rank, world, (name, layers, algo_name, kw), device)
    healthy, param_fps, buckets_per_step = [], [], []

    def after_step(state):
        buckets_per_step.append(len(trainer.plan.buckets))
        if trainer.grad_guard != "off":
            healthy.append(trainer.step_metrics["grad_healthy"].item())
        if name == "zero_leaf":
            param_fps.append(param_fingerprints(trainer, model))
        if rebucket and len(buckets_per_step) == REBUCKET_AFTER:
            decls = [t.declaration() for b in trainer.plan.buckets for t in b.tensors]
            trainer.rebucket(split_bucket_by_bucket_size(decls, REBUCKET_BYTES))

    scope = (fault_scope(FaultSpec("grad.poison", step=poison)) if poison is not None
             else contextlib.nullcontext())
    before = counters.snapshot()
    staged0 = trainer.host_staged_bytes
    with scope:
        losses, launches, st, state = train_steps(
            trainer, state, batch, BERT["b"] * cfg.max_seq_len, [fa, cd], after_step, steps)
        trainer.flush_grad_health()
    staged = trainer.host_staged_bytes - staged0
    guard_ms = None
    if name == "accum_guard":
        # the guard's own work on the last step's reduced gradient flats,
        # both ranks at once after a barrier, as in a step
        grads = trainer._stage_grads()
        times = []
        for _ in range(5):
            torch.distributed.barrier()
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            trainer._healthy(trainer._grad_health_vec(grads))
            times.append(time.perf_counter() - t0)
        guard_ms = statistics.median(times) * 1e3
        del grads
    ef = (state.algo_state or {}).get("ef")
    ef = None if ef is None else list(ef["buckets"])
    opt = state.opt_state.optimizer if algo.sharded_opt_state else state.optimizer
    record = {"name": name, "layers": cfg.n_layers, "buckets": len(trainer.plan.buckets),
              "padded_numel": sum(b.padded_numel for b in trainer.plan.buckets),
              "opt_state_bytes": optimizer_state_bytes(opt),
              "params": sum(p.numel() for p in model.parameters()), "losses": losses,
              "launches": launches, "stats": st, "host_staged_bytes": staged,
              "digests": _flat_digests(trainer, model), "fingerprints": None,
              "healthy": healthy, "param_fingerprints": param_fps,
              "counters": {k: counters.get(k) - before.get(k, 0) for k in (
                  "grad_guard/skipped_steps", "grad_guard/unhealthy_steps",
                  "faults/grad.poison/fired")},
              "ef_sizes": None if ef is None else [r.numel() for r in ef],
              "ef_finite": ef is None or all(bool(r.isfinite().all()) for r in ef),
              "ef_norm": None if ef is None else sum(r.abs().sum().item() for r in ef),
              "plan_sizes": [b.padded_numel for b in trainer.plan.buckets],
              "guard_ms": guard_ms}
    if rebucket and trainer._flat_resident:
        # AdamW's state is keyed by the new plan's flats and shaped like them
        group = opt.param_groups[0]["params"]
        record["opt_on_new_plan"] = (
            len(group) == len(trainer._flats)
            and all(a is b for a, b in zip(group, trainer._flats))
            and all(opt.state[f]["exp_avg"].shape == opt.state[f]["exp_avg_sq"].shape
                    == (b.padded_numel,) for f, b in zip(trainer._flats, trainer.plan.buckets)))
    keep = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
    keep_ef = None if ef is None else [r.cpu() for r in ef]
    against = {"onebit_clean_again": "onebit_clean", "onebit_poison": "onebit_clean",
               "rebucket": "no_rebucket"}.get(name)
    if against is not None:
        other, other_ef = _FEATURES_KEPT[against]
        diff = max((keep[n] - other[n]).abs().max().item() for n in keep)
        record["against"] = {
            "run": against, "params_equal": all(torch.equal(keep[n], other[n]) for n in keep),
            "params_max_abs": diff,
            "ef_equal": None if keep_ef is None else all(
                torch.equal(a, b) for a, b in zip(keep_ef, other_ef)),
            "ef_max_abs": None if keep_ef is None else max(
                (a - b).abs().max().item() for a, b in zip(keep_ef, other_ef))}
    _FEATURES_KEPT[name] = (keep, keep_ef)
    record["fwd_bwd_ms"] = fwd_bwd_ms(model, batch)
    log(f"[rank {rank}] {label} {name}: {record['params']} params, {cfg.n_layers} layers, "
        f"{record['buckets']} buckets ({st['layout']} layout); losses {losses}; healthy "
        f"{healthy}; counters {record['counters']}; against {record.get('against')}")
    accum = trainer.accum_steps
    want = {k.__name__: 0 for k in cd.KERNELS}
    want.update({k: cfg.n_layers * steps * accum
                 for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")})
    if kw.get("compress_intra") == "onebit_ef":
        # the error-feedback step and the ring at n = 2: 3 K4 and 3 K5 a
        # bucket and step, on the plan each step ran
        want["sign_compress_chunked"] = want["sign_decompress_chunked"] = 3 * sum(
            buckets_per_step)
    if device.type == "cuda" and launches != want:
        raise AssertionError(f"[rank {rank}] {name}: launches {launches}, expected {want}")
    return record


#: a features run's final parameters and residual on the host, by run name,
#: for the runs after it in the same rank process
_FEATURES_KEPT = {}
#: an overlap run's plan (its buckets' tensor names) by run name, for the
#: serialized run held against it on the same plan
_OVERLAP_PLANS = {}


def _stage_timers(trainer):
    """Host milliseconds of each step's backward (to the end of the main
    stream's work) and of its communication stage: ``process_grads``
    (serialized), or the main thread's wait for the buckets after the
    backward (overlapped), each to the end of the main stream's work, which
    then follows the comm stream's.  Wraps the trainer's own methods."""
    times = {"backward_ms": [], "comm_ms": []}

    def timed(key, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.current_stream().synchronize()
            times[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    trainer._forward_backward = timed("backward_ms", trainer._forward_backward)
    if trainer._ctx.overlap:
        trainer._wait_overlap = timed("comm_ms", trainer._wait_overlap)
    else:
        algo = trainer.algorithm
        algo.process_grads = timed("comm_ms", functools.partial(type(algo).process_grads, algo))
    return times


def _tap_launches(taps):
    """Record every kernel launch as (launcher, stream handle, thread name);
    returns the undo."""
    import threading

    from bagua_tpu_torch.ops import _build

    orig = _build.launch

    def launch(fn, *args):
        taps.append((fn.__name__, torch.cuda.current_stream().cuda_stream,
                     threading.current_thread().name))
        return orig(fn, *args)

    _build.launch = launch
    return lambda: setattr(_build, "launch", orig)


def _capture(obj, attr, armed, store):
    """Wrap ``obj.attr`` so that its first call while ``armed()`` stores
    copies of its tensor arguments and outputs in ``store`` (on the calling
    stream, after the call); returns the undo."""
    orig, own = getattr(obj, attr), attr in vars(obj)

    def wrapper(*args):
        out = orig(*args)
        if armed() and not store:
            outs = out if isinstance(out, tuple) else (out,)
            store["args"] = [a.detach().clone() if torch.is_tensor(a) else a for a in args]
            store["outs"] = [o.detach().clone() for o in outs]
        return out

    setattr(obj, attr, wrapper)
    return lambda: setattr(obj, attr, orig) if own else delattr(obj, attr)


def _captured_against_plain(store, fn, label, rank, scale_rtol=None):
    """The captured kernel call's outputs against ``fn`` on the captured
    inputs moved to the host (the plain version): byte for byte, except a
    first output (K4's scale, a sum in another order) within ``scale_rtol``
    where given."""
    torch.cuda.synchronize()
    if not store:
        raise AssertionError(f"[rank {rank}] {label}: no call was captured in the run")
    args = [a.cpu() if torch.is_tensor(a) else a for a in store["args"]]
    want = fn(*args)
    want = want if isinstance(want, tuple) else (want,)
    got = [g.cpu() for g in store["outs"]]
    checks = [same(g, w) for g, w in zip(got, want)]
    scale_err = None
    if scale_rtol is not None:
        scale_err = ((got[0] - want[0]).abs() / want[0].abs().clamp_min(1e-30)).max().item()
        checks[0] = scale_err <= scale_rtol
    equal = len(want) == len(got) and all(checks)
    numel = store["args"][0].numel()
    log(f"[rank {rank}] {label}: a call of {numel} elements from the run, through the "
        f"kernels vs plain: {'equal' if equal else 'DIFFERS'} (outputs {checks}"
        + (f", scale within {scale_err:.3g} relative)" if scale_err is not None else ")"))
    if not equal:
        raise AssertionError(f"[rank {rank}] {label}: the kernels' output differs from plain")
    return {"numel": numel, "equal": equal, "scale_err": scale_err}


def k1_beside_backward(trainer, state, batch):
    """One more ByteGrad step under a profiler window: K1's launches on the
    comm stream against the flash backward kernels on the main stream, as
    device intervals: how many K1 ran while a K6b or K6c kernel did, and
    while any kernel of another stream did, K1's device ms, and the span of
    the backward's flash kernels.  The step's state is dropped."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        _, loss = trainer.train_step(state, batch)
        loss.item()
        torch.cuda.synchronize()
    k1, bwd, other = [], [], []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.name.startswith("Mem"):
            continue
        span = (e.time_range.start, e.time_range.end)
        if "minmax_compress" in e.name:
            k1.append(span)
            k1_stream = e.device_resource_id
            continue
        other.append((span, e.device_resource_id))
        m = KERNEL_NAMES.search(e.name)
        if m and m.group(1) in ("dkv", "dq"):
            bwd.append(span)
    beside = sum(any(s < be and bs < e for bs, be in bwd) for s, e in k1)
    # any kernel of another stream (the backward's GEMMs and elementwise work)
    beside_any = sum(any(s < be and bs < e for (bs, be), sid in other if sid != k1_stream)
                     for s, e in k1) if k1 else 0
    first_k1 = min(s for s, _ in k1) if k1 else None
    return {"k1_launches": len(k1), "k1_beside_backward": beside,
            "k1_beside_any_other_stream": beside_any,
            "k1_ms": sum(e - s for s, e in k1) / 1e3,
            "k1_median_us": statistics.median(e - s for s, e in k1) if k1 else None,
            "backward_kernels": len(bwd),
            "backward_span_ms": (max(e for _, e in bwd) - min(s for s, _ in bwd)) / 1e3
            if bwd else None,
            "k1_before_backward_end": sum(s < max(e for _, e in bwd) for s, _ in k1)
            if bwd else None,
            "first_k1_after_backward_start_ms": (first_k1 - min(s for s, _ in bwd)) / 1e3
            if bwd and k1 else None}


def _ring_ks(trainer):
    """The sub-rings of each bucket's allreduce under the trainer's plan."""
    ctx = trainer._ctx
    return [ctx._ring_chunks(b.padded_numel, b.dtype.itemsize) for b in trainer.plan.buckets]


def overlap_run(rank, world, run, device, label):
    """One run of the overlap phase on this rank (``OVERLAP_RUNS``);
    returns its record: the losses, launches and statistics, the per-step
    parameter fingerprints, the backward's and the communication's times a
    step (``_stage_timers``), the stream and thread of every codec launch,
    and the checks of the kernels' output from the run against plain."""
    import threading

    from bagua_tpu_torch.bucket import split_bucket_by_bucket_size
    from bagua_tpu_torch.compression import get_codec, minmax_uint8
    from bagua_tpu_torch.ops import codec as cd
    from bagua_tpu_torch.ops import flash_attention as fa

    name, layers, algo_name, kw = run
    if algo_name == "eager":
        return eager_checks(rank, world, device, label)
    kw = dict(kw)
    steps, plan_of = kw.pop("steps", STEPS), kw.pop("plan_of", None)
    cfg, model, algo, trainer, state, batch, kw = _build_run(
        rank, world, (name, layers, algo_name, kw), device)
    times = _stage_timers(trainer)
    param_fps, buckets_per_step, ks_per_step = [], [], [_ring_ks(trainer)]
    plan_names = None if plan_of is None else _OVERLAP_PLANS[plan_of]

    def after_step(state):
        buckets_per_step.append(len(trainer.plan.buckets))
        param_fps.append(param_fingerprints(trainer, model))
        if plan_names is not None and len(buckets_per_step) == 1:
            decls = {p.name: p.declaration() for p in trainer._named_params}
            trainer.rebucket([[decls[n] for n in b] for b in plan_names])
        ks_per_step.append(_ring_ks(trainer))

    last = {"step": False}
    store, undo = {}, []
    if name == "bytegrad_overlap":
        # one real bucket's K1 call of the last step, from the comm stream
        undo.append(_capture(minmax_uint8, "compress_chunked", lambda: last["step"], store))
    codec_name = kw.get("compress_intra")
    if codec_name is not None:
        # the first encode of the last step on the comm worker: a sub-ring's
        # (the error-feedback step encodes whole buckets on the backward's)
        undo.append(_capture(get_codec(codec_name), "encode", lambda: last["step"] and (
            threading.current_thread().name == "bagua-comm-worker"), store))
    taps = []
    undo.append(_tap_launches(taps))

    def arm_last(state):
        after_step(state)
        last["step"] = len(buckets_per_step) == steps - 1

    staged0 = trainer.host_staged_bytes
    try:
        losses, launches, st, state = train_steps(
            trainer, state, batch, BERT["b"] * cfg.max_seq_len, [fa, cd], arm_last, steps)
    finally:
        for u in undo:
            u()
    staged = trainer.host_staged_bytes - staged0
    times = {k: list(v) for k, v in times.items()}   # the run's steps alone
    overlapped = trainer._ctx.overlap
    worker = trainer._worker
    comm_stream = None if worker is None or worker.stream is None else worker.stream.cuda_stream
    codec_taps = {}
    for fn_name, stream, thread in taps:
        if fn_name.startswith(("bagua_minmax", "bagua_absmax", "bagua_sign")):
            where = ("comm stream" if stream == comm_stream else "other stream") + \
                f", {'comm worker' if thread == 'bagua-comm-worker' else 'thread ' + thread}"
            codec_taps.setdefault(fn_name, {}).setdefault(where, 0)
            codec_taps[fn_name][where] += 1
    opt = state.opt_state.optimizer if algo.sharded_opt_state else state.optimizer
    record = {"name": name, "layers": cfg.n_layers, "buckets": len(trainer.plan.buckets),
              "padded_numel": sum(b.padded_numel for b in trainer.plan.buckets),
              "opt_state_bytes": optimizer_state_bytes(opt),
              "params": sum(p.numel() for p in model.parameters()), "losses": losses,
              "launches": launches, "stats": st, "host_staged_bytes": staged,
              "digests": _flat_digests(trainer, model), "fingerprints": None,
              "param_fingerprints": param_fps, "overlap": overlapped,
              "times": times, "codec_launches": codec_taps,
              "plan_sizes": [b.padded_numel for b in trainer.plan.buckets],
              "buckets_per_step": buckets_per_step, "ks_per_step": ks_per_step[:steps],
              "threads": sorted({t.name for t in threading.enumerate()})}
    if overlapped:
        _OVERLAP_PLANS[name] = [[t.name for t in b.tensors] for b in trainer.plan.buckets]
    if name == "bytegrad_overlap":
        record["k1_payload"] = _captured_against_plain(
            store, lambda x, n: cd.compress_chunked(x, n), "ByteGrad's K1 in the overlapped "
            "step", rank)
        record["k1_beside_backward"] = (k1_beside_backward(trainer, state, batch)
                                        if device.type == "cuda" else None)
        log(f"[rank {rank}] {label} {name}: K1 beside the backward: "
            f"{record['k1_beside_backward']}")
    if codec_name is not None:
        record["sub_chunk"] = _captured_against_plain(
            store, get_codec(codec_name).encode, f"the {codec_name} ring's first encode of "
            "the last step on the comm worker (a real sub-chunk)", rank,
            SIGN_RTOL if codec_name == "onebit_ef" else None)
    record["fwd_bwd_ms"] = fwd_bwd_ms(model, batch)
    log(f"[rank {rank}] {label} {name}: {record['params']} params, {cfg.n_layers} layers, "
        f"{record['buckets']} buckets (per step {buckets_per_step}), overlap {overlapped}; "
        f"losses {losses}; backward ms {[round(t, 3) for t in times['backward_ms']]}; "
        f"communication ms {[round(t, 3) for t in times['comm_ms']]}; codec launches "
        f"{codec_taps}")
    accum = trainer.accum_steps
    want = {k.__name__: 0 for k in cd.KERNELS}
    want.update({k: cfg.n_layers * steps * accum
                 for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")})
    # each step on the plan it ran: the first on the initial one, a readiness
    # rebucket after it
    ks = ks_per_step[:steps]
    if algo_name == "bytegrad":
        want["compress_chunked"] = sum(len(k) for k in ks)
        want["decompress_chunked"] = 2 * sum(len(k) for k in ks)
    if codec_name == "int8":
        # one encode on the reduce-scatter hop, one on the gather, a sub-ring
        want["absmax_chunked"] = 2 * sum(sum(k) for k in ks)
    if codec_name == "onebit_ef":
        # the error-feedback step of each bucket, then 2 encodes and 2
        # decodes a sub-ring
        want["sign_compress_chunked"] = want["sign_decompress_chunked"] = sum(
            len(k) + 2 * sum(k) for k in ks)
    if device.type == "cuda" and launches != want:
        raise AssertionError(f"[rank {rank}] {name}: launches {launches}, expected {want}")
    return record


def eager_checks(rank, world, device, label, comm=None):
    """Every eager collective of ``bagua_tpu_torch`` on card tensors, each
    against a plain torch computation on every rank's inputs (drawn from one
    seed on the host, so that each rank knows them all): exact, since two
    ranks' sums take either order exactly.  Then an abort makes a dispatch
    raise, and a reset lets the next one through.  Returns the record."""
    import bagua_tpu_torch as bt
    from bagua_tpu_torch.communication import BaguaAborted

    g = torch.Generator().manual_seed(11)
    xs = torch.randn((world, 4 * world, 6), generator=g)
    mine = xs[rank].to(device)
    blocks = xs.reshape(world, world, 4, 6)   # [src, dst, rows, 6]
    # ragged counts: rank s sends (s + d) % 3 + 1 rows to rank d
    counts = [[(s + d) % 3 + 1 for d in range(world)] for s in range(world)]
    need = max(sum(counts[s][d] for s in range(world)) for d in range(world))
    ragged_want = torch.zeros((need, 6))
    pos = 0
    for s in range(world):
        start = sum(counts[s][:rank])
        ragged_want[pos:pos + counts[s][rank]] = xs[s][start:start + counts[s][rank]]
        pos += counts[s][rank]
    inplace = mine.clone()
    got = {
        "allreduce_avg": (bt.allreduce(mine), xs.sum(0) / world),
        "allreduce_inplace_sum": (bt.allreduce_inplace(inplace, bt.ReduceOp.SUM), xs.sum(0)),
        "allgather": (bt.allgather(mine), xs.reshape(-1, 6)),
        "reduce_scatter_sum": (bt.reduce_scatter(mine, bt.ReduceOp.SUM),
                               xs.sum(0).reshape(world, 4, 6)[rank]),
        "alltoall": (bt.alltoall(mine), blocks[:, rank].reshape(-1, 6)),
        "alltoall_v": (bt.alltoall_v(mine, counts), ragged_want),
        "broadcast": (bt.broadcast(mine, src=world - 1), xs[world - 1]),
        "reduce_max": (bt.reduce(mine, dst=0, op=bt.ReduceOp.MAX),
                       xs.max(0).values if rank == 0 else torch.zeros_like(xs[0])),
        "gather": (bt.gather(mine, dst=world - 1),
                   xs.reshape(-1, 6) if rank == world - 1 else torch.zeros(4 * world * world, 6)),
        "scatter": (bt.scatter(mine, src=0), xs[0].reshape(world, 4, 6)[rank]),
        "send_recv": (bt.send_recv(mine, [(i, (i + 1) % world) for i in range(world)]),
                      xs[(rank - 1) % world]),
    }
    results = {op: bool(g.device.type == device.type and same(g.cpu(), w))
               for op, (g, w) in got.items()}
    results["allreduce_inplace_in_place"] = got["allreduce_inplace_sum"][0] is inplace
    bt.abort("chip smoke: an eager dispatch after an abort")
    try:
        bt.allreduce(mine)
        results["refused_after_abort"] = False
    except BaguaAborted:
        results["refused_after_abort"] = True
    finally:
        bt.reset_abort()
    results["after_reset"] = bool(same(bt.allreduce(mine).cpu(), xs.sum(0) / world))
    backend = torch.distributed.get_backend()
    log(f"[rank {rank}] {label} eager collectives at world {world} over {backend} on card "
        f"tensors against plain torch: {results}")
    if not all(results.values()):
        raise AssertionError(f"[rank {rank}] eager collectives: {results}")
    return {"name": "eager", "kind": "eager", "results": results, "backend": backend}


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
        run_fn = {"async": async_run, "features": features_run,
                  "overlap": overlap_run}.get(phase, compressed_run)
        records.append(run_fn(rank, world, run, device, label))
        if device.type == "cuda":
            release()
    with open(out_path, "w") as f:
        json.dump(records, f)
    torch.distributed.destroy_process_group()


def phase_multi_rank(phase):
    """Start the phase's ranks as processes of this script on the one card and
    check them; fails if any rank fails or the phase outlasts
    ``WORKER_TIMEOUT``.  Returns every rank's record by run name."""
    label, _, world, intra = MULTI_RANK[phase]
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
        if runs[0].get("kind") == "eager":
            continue
        if runs[0]["fingerprints"] is not None:
            check_gossip(label, runs, intra or 1)
        elif any(r["digests"] != runs[0]["digests"] for r in runs):
            raise AssertionError(f"{label} {name}: parameters differ between the ranks")
        if any(r["losses"] != runs[0]["losses"] for r in runs):
            raise AssertionError(f"{label} {name}: losses differ between the ranks")
        for r, rec in enumerate(runs):
            st = rec["stats"]
            log(f"{label} {name} rank {r} (gloo through host memory, {world} ranks on one "
                f"card): step {st['step_ms']:.3f} ms (steps 2-{len(rec['losses'])} as one "
                f"window; median "
                f"{st['median_ms']:.3f} ms; first {st['first_ms']:.3f} ms), "
                f"{st['tokens_s']:.1f} tokens/s, peak memory {st['peak_gb']:.3f} GB "
                f"({st['layout']} layout), host-staged {rec['host_staged_bytes']} bytes in "
                f"{len(rec['losses'])} steps, "
                f"optimizer state {rec['opt_state_bytes']} bytes, "
                f"{rec['buckets']} buckets, launches {rec['launches']}; forward+backward "
                f"alone (no communication) {rec['fwd_bwd_ms']:.3f} ms")
        if runs[0]["digests"] is not None:
            log(f"{label} {name}: parameters bitwise equal on all {world} ranks "
                f"({len(runs[0]['digests'])} bucket digests)")
    return {runs[0]["name"]: list(runs) for runs in zip(*ranks)}


def check_gossip(label, runs, intra):
    """The gossip families' gates on every rank's per-step fingerprints of
    every bucket.  ``all``: the peer weights equal on every rank after every
    step; ``shift_one``: rank r's equal those of ``shift_one_peer(r, world,
    step)``; the low-precision ring: rank r's ``left`` replica equal to its
    left ring neighbour's ``self``, ``right`` to its right neighbour's, its
    parameters to its own ``self`` (the ring runs over the inter-node tier
    where hierarchical: the ranks of r's local index, ``intra`` apart).  In
    each, the parameters of the first and the last rank differ after the
    last step (at 2 x 2 the two ranks of a node hold the same average)."""
    from bagua_tpu_torch.algorithms.decentralized import shift_one_peer

    name, world = runs[0]["name"], len(runs)
    fp = [r["fingerprints"] for r in runs]
    mode = runs[0]["peer_selection_mode"]
    n_buckets, steps = len(fp[0]["params"][0]), len(fp[0]["params"])
    bad = []
    for step in range(steps):
        for r in range(world):
            if mode == "all":
                pairs = [("peer_weights", r, "peer_weights", 0)]
            elif mode == "shift_one":
                pairs = [("peer_weights", r, "peer_weights", shift_one_peer(r, world, step))]
            else:
                ring = intra if runs[0]["hierarchical"] else 1
                n, i, local = world // ring, r // ring, r % ring
                pairs = [("left", r, "self", ((i - 1) % n) * ring + local),
                         ("right", r, "self", ((i + 1) % n) * ring + local),
                         ("params", r, "self", r)]
            bad += [(step, a, p, b, q) for a, p, b, q in pairs
                    if fp[p][a][step] != fp[q][b][step]]
    differ = fp[0]["params"][-1] != fp[-1]["params"][-1]
    what = {"all": "peer weights equal on every rank",
            "shift_one": "peer weights equal to those of the step's shift_one partner"}.get(
        mode, "left == left neighbour's self, right == right neighbour's self, "
        "params == self")
    log(f"{label} {name}: {what} after each of the {steps} steps in all {n_buckets} buckets "
        f"on all {world} ranks: {'yes' if not bad else f'NO at {bad[:5]}'}; parameters of "
        f"ranks 0 and {world - 1} {'differ' if differ else 'EQUAL'} after the last step")
    if bad or not differ:
        raise AssertionError(f"{label} {name}: gossip gate failed: mismatches "
                             f"(step, key, rank, key, rank) {bad[:10]}; ranks differ {differ}")


def check_async(runs, replicated, gossip):
    """The async phase's gates on every rank's record: the same period,
    launches, catch-ups and status after every step on both ranks (applies
    are local: a partitioned rank drops its rounds);
    the ranks' parameters differ after the window and are bitwise equal
    after ``barrier`` and ``sync_for_checkpoint``; the staged bytes exactly
    two copies (to the host and back) of the f32 weights a round, a warmup
    step or a catch-up, plus 8 bytes a step for the loss.  The full run must
    have launched and applied a round inside the window; the partition run
    catches up at the same step on both ranks, bitwise equal right after it,
    its lag within the cap; the abort run's status turns at the same step on
    both ranks.  Logs each run's schedule, step times and waits beside the
    replicated and ``all`` gossip runs of BERT-Large from the same call."""
    for name, recs in runs.items():
        r0 = recs[0]
        ps = [r["per_step"] for r in recs]
        for key in ("launched", "catchups", "status"):
            if any(p[key] != ps[0][key] for p in ps):
                raise AssertionError(f"async {name}: {key} differs between the ranks: "
                                     f"{[p[key] for p in ps]}")
        if any(r["period"] != r0["period"] for r in recs):
            raise AssertionError(f"async {name}: periods {[r['period'] for r in recs]}")
        if r0["digests_window"] == recs[-1]["digests_window"]:
            raise AssertionError(f"async {name}: the ranks' parameters are equal after the "
                                 f"window")
        launched, applied = ps[0]["launched"][-1], ps[0]["applied"][-1]
        warm = min(r0["warmup_steps"], STEPS)
        for r, rec in enumerate(recs):
            want = ((launched + warm + len([c for c in rec["catchups"]
                                             if c["reason"] == "staleness"]))
                    * 2 * 4 * rec["padded_numel"] + STEPS * 8)
            if rec["host_staged_bytes"] != want:
                raise AssertionError(f"async {name} rank {r}: staged {rec['host_staged_bytes']} "
                                     f"bytes, expected {want}")
        waits = [[round(w * 1e3, 3) for w in p["wait_s"]] for p in ps]
        st = r0["stats"]
        log(f"async {name}: period {r0['period']} steps (agreed step time "
            f"{None if r0['agreed_dt'] is None else round(r0['agreed_dt'] * 1e3, 3)} ms), "
            f"{launched} rounds launched and {applied} applied in {STEPS} steps (launched "
            f"after each step {ps[0]['launched']}, status {ps[0]['status']}); step "
            f"{st['step_ms']:.3f} ms (median {st['median_ms']:.3f}), {st['tokens_s']:.1f} "
            f"tokens/s, peak {st['peak_gb']:.3f} GB; staged {r0['host_staged_bytes']} bytes "
            f"(exact); wait in work.wait() after each step (ms, rank by rank) {waits}; "
            f"a round alone {r0['round_ms']:.3f} ms; one blocking average of every bucket "
            f"(sync_for_checkpoint) {r0['sync_ms']:.3f} ms; digests equal on both ranks "
            f"after it")
        if name == "async":
            if not (applied >= 1 and r0["period"] is not None):
                raise AssertionError(f"async: no round applied in the window ({applied})")
            times = [round(t, 3) for t in r0["stats"]["times_ms"]]
            log(f"async: step times (ms) {times}; peak {st['peak_gb']:.3f} GB against the "
                f"replicated run's {replicated['stats']['peak_gb']:.3f} "
                f"({st['peak_gb'] - replicated['stats']['peak_gb']:+.3f}); step "
                f"{st['step_ms']:.3f} ms (median {st['median_ms']:.3f}) against the replicated "
                f"run's {replicated['stats']['step_ms']:.3f} (median "
                f"{replicated['stats']['median_ms']:.3f}) and decentralized all's "
                f"{gossip['stats']['step_ms']:.3f} (median {gossip['stats']['median_ms']:.3f}); "
                f"{st['tokens_s']:.1f} tokens/s against {replicated['stats']['tokens_s']:.1f} "
                f"and {gossip['stats']['tokens_s']:.1f}; forward+backward alone "
                f"{r0['fwd_bwd_ms']:.3f} ms")
        if name == "async_partition":
            steps = [[c["step"] for c in r["catchups"] if c["reason"] == "staleness"]
                     for r in recs]
            lag = max(a - b for a, b in zip(ps[0]["launched"], ps[-1]["applied"]))
            equal = all(c["digests"] == recs[0]["catchups"][i]["digests"]
                        for r in recs for i, c in enumerate(r["catchups"]))
            log(f"async_partition: catch-ups at steps {steps} (rank by rank), digests equal "
                f"right after each: {equal}; largest lag {lag} (cap "
                f"{r0['max_staleness_rounds']})")
            if not (steps[0] and all(s == steps[0] for s in steps) and equal
                    and lag <= r0["max_staleness_rounds"]):
                raise AssertionError(f"async_partition: catch-ups {steps}, equal {equal}, "
                                     f"lag {lag}")
        if name == "async_abort":
            status = ps[0]["status"]
            want = ([0] * ASYNC_ABORT_AFTER + [1] * (ASYNC_RESUME_AFTER - ASYNC_ABORT_AFTER)
                    + [0] * (STEPS - ASYNC_RESUME_AFTER))
            if status != want:
                raise AssertionError(f"async_abort: status {status}, expected {want}")


def check_zero(zero):
    """ZeRO's full BERT-Large run against the replicated one of the same
    call: its optimizer state a rank exactly half (``1 / world``; BERT-Large's
    buckets need no padding at world 2), its peak memory below."""
    sharded, full = zero["zero"], zero["replicated"]
    log(f"zero: optimizer state {sharded['opt_state_bytes']} bytes a rank against the "
        f"replicated run's {full['opt_state_bytes']} (ratio "
        f"{sharded['opt_state_bytes'] / full['opt_state_bytes']:.6f}); peak memory "
        f"{sharded['stats']['peak_gb']:.3f} GB against {full['stats']['peak_gb']:.3f} GB; step "
        f"{sharded['stats']['step_ms']:.3f} ms against {full['stats']['step_ms']:.3f} ms; "
        f"staged {sharded['host_staged_bytes']} bytes against {full['host_staged_bytes']}")
    if not (sharded["padded_numel"] == full["params"]
            and CODEC_WORLD * sharded["opt_state_bytes"] == full["opt_state_bytes"]
            and sharded["stats"]["peak_gb"] < full["stats"]["peak_gb"]):
        raise AssertionError(f"ZeRO's state or peak: {sharded['opt_state_bytes']} bytes, "
                             f"{sharded['stats']['peak_gb']} GB against "
                             f"{full['opt_state_bytes']}, {full['stats']['peak_gb']}")


def check_features(feat, zero):
    """The features phase's gates on every rank's record (see
    ``FEATURES_RUNS``): (a) the leaf-layout ZeRO's per-step fingerprints of
    every bucket equal to the resident ZeRO's of the zero phase over its first
    ``FULL_STEPS`` steps on each rank (one chunk update in either layout), and
    the resident peak at least ``RESIDENT_PEAK_DROP_GB`` below; (b) the
    accumulated, guarded losses within ``ACCUM_LOSS_RTOL`` of the zero phase's
    replicated run at every step, every verdict healthy; (c) the two clean 1-bit runs bitwise equal, and then the
    poisoned run's parameters and residual bitwise equal to the clean run's
    (else within ten times the clean runs' own difference), one skipped step
    and one fire on each rank; (d) the rebucketed run's parameters bitwise
    equal to the run without it, AdamW's state on the new plan, and the 1-bit
    residual carried onto the new plan, finite and nonzero."""
    ranks = range(len(feat["zero_leaf"]))
    leaf, res = feat["zero_leaf"], zero["zero"]
    fp_equal = all(leaf[r]["param_fingerprints"] == res[r]["param_fingerprints"][:FULL_STEPS]
                   for r in ranks)
    drop = [leaf[r]["stats"]["peak_gb"] - res[r]["stats"]["peak_gb"] for r in ranks]
    log(f"features (a): ZeRO on BERT-Large, leaf layout peak "
        f"{[round(r['stats']['peak_gb'], 3) for r in leaf]} GB and step "
        f"{[round(r['stats']['step_ms'], 3) for r in leaf]} ms against the zero phase's "
        f"resident run's {[round(r['stats']['peak_gb'], 3) for r in res]} GB and "
        f"{[round(r['stats']['step_ms'], 3) for r in res]} ms (rank by rank; drop "
        f"{[round(d, 3) for d in drop]} GB); per-step bucket fingerprints "
        f"{'equal' if fp_equal else 'DIFFER'} over {len(leaf[0]['param_fingerprints'])} steps")
    if not (fp_equal and len(leaf[0]["param_fingerprints"]) == FULL_STEPS
            and min(drop) >= RESIDENT_PEAK_DROP_GB):
        raise AssertionError(f"features (a): fingerprints equal {fp_equal}, peak drop {drop}")
    acc, rep = feat["accum_guard"][0], zero["replicated"][0]
    gap = max(abs(a - b) / abs(b) for a, b in zip(acc["losses"], rep["losses"]))
    st = acc["stats"]
    log(f"features (b): GradientAllReduce on BERT-Large, 2 microbatches of 4, guard skip: "
        f"losses within {gap:.3g} of the replicated run's; verdicts {acc['healthy']}; step "
        f"{st['step_ms']:.3f} ms (median {st['median_ms']:.3f}) against the replicated run's "
        f"{rep['stats']['step_ms']:.3f}, peak {st['peak_gb']:.3f} GB ({st['layout']} layout) "
        f"against {rep['stats']['peak_gb']:.3f} GB; the guard's verdict and host read "
        f"{acc['guard_ms']:.3f} ms, {acc['guard_ms'] / st['step_ms']:.3%} of the step")
    if not (gap <= ACCUM_LOSS_RTOL and acc["healthy"] == [1.0] * FULL_STEPS
            and len(acc["losses"]) == FULL_STEPS):
        raise AssertionError(f"features (b): loss gap {gap}, verdicts {acc['healthy']}")
    for r in ranks:
        again, poisoned = feat["onebit_clean_again"][r], feat["onebit_poison"][r]
        exact = again["against"]["params_equal"] and again["against"]["ef_equal"]
        tol = 10 * max(again["against"]["params_max_abs"], again["against"]["ef_max_abs"])
        got = poisoned["against"]
        same = (got["params_equal"] and got["ef_equal"] if exact else
                max(got["params_max_abs"], got["ef_max_abs"]) <= tol)
        log(f"features (c) rank {r}: two clean 1-bit runs "
            f"{'bitwise equal' if exact else 'DIFFER'} "
            f"({again['against']}); the run poisoned at step {POISON_AT} against the clean run "
            f"of {POISON_STEPS - 1} steps: {got}; counters {poisoned['counters']}; verdicts "
            f"{poisoned['healthy']}")
        if not (same and poisoned["counters"]["grad_guard/skipped_steps"] == 1
                and poisoned["counters"]["faults/grad.poison/fired"] == 1
                and poisoned["healthy"][POISON_AT] == 0.0 and poisoned["ef_finite"]):
            raise AssertionError(f"features (c) rank {r}: {got}, {poisoned['counters']}")
        reb, onebit = feat["rebucket"][r], feat["onebit_rebucket"][r]
        log(f"features (d) rank {r}: rebucket after step {REBUCKET_AFTER} to "
            f"{len(reb['plan_sizes'])} buckets: parameters against the run without it "
            f"{reb['against']}; AdamW on the new plan {reb['opt_on_new_plan']}; the 1-bit run's "
            f"residual on {onebit['ef_sizes'] == onebit['plan_sizes']} the new plan "
            f"({len(onebit['plan_sizes'])} buckets), L1 {onebit['ef_norm']}, finite "
            f"{onebit['ef_finite']}; steps {reb['stats']['step_ms']:.3f} ms and "
            f"{onebit['stats']['step_ms']:.3f} ms")
        if not (reb["against"]["params_equal"] and reb["opt_on_new_plan"]
                and len(reb["plan_sizes"]) > len(feat["no_rebucket"][r]["plan_sizes"])
                and onebit["ef_sizes"] == onebit["plan_sizes"] and onebit["ef_finite"]
                and onebit["ef_norm"] > 0):
            raise AssertionError(f"features (d) rank {r}: {reb['against']}, "
                                 f"{reb['opt_on_new_plan']}, {onebit['ef_sizes']}")


def _fp_total(fps):
    """A step's fingerprint of all parameters whatever the plan: the sum of
    its buckets' fingerprints modulo 2^64 (each a wrapping sum over its
    tensors' elements)."""
    return sum(fps) % 2 ** 64


def check_overlap(ov, zero):
    """The overlap phase's gates on every rank's record (``OVERLAP_RUNS``):
    (a) the overlapped GradientAllReduce's parameters bitwise equal to the
    serialized run's after every step; (b) every K1 and K2 launch of the
    overlapped ByteGrad made on the comm stream by the comm worker, its
    parameters bitwise equal to the serialized run on the same plan after
    every step; (c) the overlapped ZeRO's per-step fingerprints equal to the
    zero phase's serialized run's, its state exactly ``1 / world`` of the
    replicated run's, its peak no higher than the serialized run's; (d) the
    chunked ring's losses within ``RING_LOSS_RTOL`` of the fused run's.
    Launches, the captured kernel calls against plain and the eager
    collectives were checked in the ranks.  Logs the step times, the wait
    after the backward and the share of the serialized communication that
    the overlap hides."""
    ranks = range(len(ov["ga_serial"]))
    totals = {name: [[_fp_total(fp) for fp in ov[name][r]["param_fingerprints"]] for r in ranks]
              for name in ov if ov[name][0].get("kind") != "eager"}
    for a, b in (("ga_overlap", "ga_serial"), ("bytegrad_overlap", "bytegrad_serial")):
        equal = totals[a] == totals[b] and len(totals[a][0]) == FULL_STEPS
        log(f"overlap: {a} against {b}: parameters after every step "
            f"{'bitwise equal' if equal else 'DIFFER'} ({totals[a][0]} / {totals[b][0]})")
        if not equal:
            raise AssertionError(f"overlap: {a}'s parameters differ from {b}'s")
    for name in ("ga_serial", "ga_overlap", "bytegrad_overlap", "bytegrad_serial", "zero_overlap",
                 "ring_fused", "ring_chunked", "ring_int8", "ring_onebit"):
        for r in ranks:
            rec = ov[name][r]
            t = rec["times"]
            log(f"overlap {name} rank {r}: step {rec['stats']['step_ms']:.3f} ms (median "
                f"{rec['stats']['median_ms']:.3f}), backward to the end of the main stream "
                f"{statistics.median(t['backward_ms'][1:]):.3f} ms, "
                f"{'wait after the backward' if rec['overlap'] else 'communication'} "
                f"{statistics.median(t['comm_ms'][1:]):.3f} ms (medians of steps 2-"
                f"{len(t['comm_ms'])}), forward+backward alone {rec['fwd_bwd_ms']:.3f} ms, "
                f"peak {rec['stats']['peak_gb']:.3f} GB, staged {rec['host_staged_bytes']} bytes")
    for a, b in (("ga_overlap", "ga_serial"), ("bytegrad_overlap", "bytegrad_serial")):
        for r in ranks:
            wait = statistics.median(ov[a][r]["times"]["comm_ms"][1:])
            comm = statistics.median(ov[b][r]["times"]["comm_ms"][1:])
            log(f"overlap: {a} rank {r}: the wait after the backward {wait:.3f} ms against "
                f"{b}'s communication {comm:.3f} ms: {1 - wait / comm:.2%} of it hidden; step "
                f"{ov[a][r]['stats']['step_ms']:.3f} ms against {ov[b][r]['stats']['step_ms']:.3f}")
    for r in ranks:
        taps = ov["bytegrad_overlap"][r]["codec_launches"]
        n = sum(len(k) for k in ov["bytegrad_overlap"][r]["ks_per_step"])
        log(f"overlap: bytegrad_overlap rank {r}: codec launches by stream and thread {taps}")
        if not (taps.get("bagua_minmax_compress") == {"comm stream, comm worker": n}
                and taps.get("bagua_minmax_decompress") == {"comm stream, comm worker": 2 * n}):
            raise AssertionError(f"overlap: ByteGrad's K1/K2 launches {taps}, expected {n} and "
                                 f"{2 * n} on the comm stream")
    z, ser, rep = ov["zero_overlap"], zero["zero"], zero["replicated"]
    for r in ranks:
        want = [_fp_total(fp) for fp in ser[r]["param_fingerprints"][:FULL_STEPS]]
        ok = (totals["zero_overlap"][r] == want
              and CODEC_WORLD * z[r]["opt_state_bytes"] == rep[r]["opt_state_bytes"]
              and z[r]["padded_numel"] == rep[r]["params"]
              and z[r]["stats"]["peak_gb"] <= ser[r]["stats"]["peak_gb"])
        log(f"overlap: zero_overlap rank {r}: per-step fingerprints "
            f"{'equal' if totals['zero_overlap'][r] == want else 'DIFFER'} to the zero phase's "
            f"serialized run; optimizer state {z[r]['opt_state_bytes']} bytes against the "
            f"replicated {rep[r]['opt_state_bytes']}; peak {z[r]['stats']['peak_gb']:.3f} GB "
            f"against the serialized {ser[r]['stats']['peak_gb']:.3f} GB; step "
            f"{z[r]['stats']['step_ms']:.3f} ms against {ser[r]['stats']['step_ms']:.3f}")
        if not ok:
            raise AssertionError(f"overlap: ZeRO rank {r} fails its gates")
    fused, chunked = ov["ring_fused"][0]["losses"], ov["ring_chunked"][0]["losses"]
    gap = max(abs(a - b) / abs(b) for a, b in zip(chunked, fused))
    log(f"overlap (d): the chunked ring ({OVERLAP_CHUNK_BYTES} bytes a sub-ring; sub-rings a "
        f"bucket {ov['ring_chunked'][0]['ks_per_step'][-1]}) against the fused allreduce: losses "
        f"within {gap:.3g} ({chunked} / {fused}); int8 sub-chunk "
        f"{ov['ring_int8'][0]['sub_chunk']}, 1-bit sub-chunk {ov['ring_onebit'][0]['sub_chunk']}")
    if gap > RING_LOSS_RTOL:
        raise AssertionError(f"overlap: the chunked ring's losses are {gap} from the fused run's")


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
    launches, base = timed("slice 1", phase_slice)
    release()
    launches_moe, _, base_moe = timed("slice 2", phase_slice_moe)
    release()
    timed("remat", phase_remat, {"longctx": base, "moe": base_moe})
    del base, base_moe
    torch.distributed.destroy_process_group()
    release()   # the ranks of slices 3 and 4 share this card
    slice3 = timed("slice 3", phase_multi_rank, "slice3")
    slice4 = timed("slice 4", phase_multi_rank, "slice4")
    timed("slice 4 (2 x 2)", phase_multi_rank, "slice4_2x2")
    zero = timed("zero", phase_multi_rank, "zero")
    check_zero({name: recs[0] for name, recs in zero.items()})
    gossip = timed("decentralized", phase_multi_rank, "decentralized")
    gossip.update(timed("decentralized (2 x 2)", phase_multi_rank, "decentralized_4"))
    full = zero["replicated"][0]
    async_runs = timed("async", phase_multi_rank, "async")
    check_async(async_runs, full, gossip["decentralized_all"][0])
    features = timed("features", phase_multi_rank, "features")
    check_features(features, zero)
    overlap = timed("overlap", phase_multi_rank, "overlap")
    check_overlap(overlap, zero)
    for name, (rec, *_) in gossip.items():
        if rec["params"] != full["params"]:
            continue
        log(f"decentralized {name}: peak {rec['stats']['peak_gb']:.3f} GB ("
            f"{rec['stats']['peak_gb'] - full['stats']['peak_gb']:+.3f} GB against the "
            f"replicated BERT-Large run of the zero phase, {full['stats']['peak_gb']:.3f}), step "
            f"{rec['stats']['step_ms']:.3f} ms against its {full['stats']['step_ms']:.3f}, "
            f"launches K1 {rec['launches']['compress_chunked']} K2 "
            f"{rec['launches']['decompress_chunked']} in {len(rec['losses'])} steps")
    log(f"seconds by phase: {seconds}")
    # each kernel's launches come from its own path: flash from slice 1, gmm
    # from slice 2, K1 and K2 from slice 3's ByteGrad run, K3 from its int8
    # ring, K4 and K5 from slice 4's main path (the other slices checked the
    # flash counts too, and slice 4's 2 x 2 runs K1, K2, K4 and K5)
    own = {"compress_chunked": slice3["bytegrad"][0]["launches"],
           "decompress_chunked": slice3["bytegrad"][0]["launches"],
           "absmax_chunked": slice3["int8"][0]["launches"],
           "sign_compress_chunked": slice4["onebit_ef"][0]["launches"],
           "sign_decompress_chunked": slice4["onebit_ef"][0]["launches"]}
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
