"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. device: a CUDA card is required; prints its name and power limit.
2. build: compiles every ``bagua_tpu_torch/ops/csrc/*.cu`` with ``nvcc``.
3. kernels: each flash-attention kernel against its plain PyTorch version on
   the card (bf16 at both slices' training shapes, a ragged bf16 length,
   f32), and the times of the kernel, the plain version and the PyTorch
   library call at slice 1's shape.
4. gmm kernels: each grouped-matmul kernel against its plain version at the
   MoE path's shapes (both (d, f) pairs; balanced, skewed and empty-group
   sizes) and a small ragged case, their times, and one MoE layer's forward
   and backward under ``torch.cuda.set_sync_debug_mode("error")``, so that a
   host sync on the MoE path fails the run.
5. slice 1: the long-context TransformerLM (``bench_longctx``'s widths,
   random weights from a seed) trained for 10 steps by ``BaguaTrainer`` with
   ``GradientAllReduceAlgorithm`` over NCCL; losses must be finite and
   falling, every flash kernel must have launched ``n_layers * steps`` times,
   and the model's logits on a short input must agree with the plain
   attention.
6. slice 2: the dropless MoE TransformerLM of ``bench_moe_longseq`` (MoE in
   every odd layer, 8 experts, top-2) trained for 10 steps with Adam and the
   load-balancing loss; losses finite and falling, exact launch counts of
   the gmm and flash kernels, and the logits on a short input against the
   plain gmm and plain attention.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  ``build_slice`` holds each
slice's model, trainer and batch; ``scripts/torch_step_profile.py`` profiles
the same ones.
"""

from __future__ import annotations

import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12     # H100 SXM f32 rate outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 rate

MAIN = dict(b=2, s=4096, h=16, d=64)
MOE = dict(b=8, s=4096, h=8, experts=8, k=2, d_model=512, d_ff=2048)
STEPS = 10
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# gmm: the bf16 product is summed in f32 and rounded once on both sides (one
# bf16 ulp, 2^-8); d_rhs is f32 on both sides (summation order only)
GMM_TOL = {"grouped_matmul": 1e-2, "grouped_matmul_drhs": 1e-4}
REPLACES = {
    "flash_fwd": "bagua_tpu/ops/flash_attention.py:119",
    "flash_bwd_dkv": "bagua_tpu/ops/flash_attention.py:274",
    "flash_bwd_dq": "bagua_tpu/ops/flash_attention.py:291",
    "grouped_matmul": "bagua_tpu/ops/gmm.py:95",
    "grouped_matmul_drhs": "bagua_tpu/ops/gmm.py:133",
}
SOURCE = "bagua_tpu_torch/ops/csrc/flash_attention.cu"
GMM_SOURCE = "bagua_tpu_torch/ops/csrc/gmm.cu"


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(got, want) -> float:
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def abs_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


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
        usage = [ln for ln in text.splitlines() if "registers" in ln]
        log(f"  {name}: " + "; ".join(ln.split(":", 1)[-1].strip() for ln in usage))


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
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
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
    # slice 2's shape: b·h = 64 (batch 8 × 8 heads of 64) at its seq
    _, errs_moe = check_kernels(MOE["b"] * MOE["h"], MOE["s"], MOE["d_model"] // MOE["h"],
                                torch.bfloat16, True, seed=6)
    (q, k, v, do, lse, delta), errs = check_kernels(bh, s, d, torch.bfloat16, True)
    errs = {n: max(e, errs_moe[n]) for n, e in errs.items()}

    ms = {
        "flash_fwd": cuda_ms(lambda: fa.flash_fwd(q, k, v, True)),
        "flash_bwd_dkv": cuda_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, True)),
        "flash_bwd_dq": cuda_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, True)),
    }
    plain_ms = {
        "flash_fwd": cuda_ms(lambda: fa.fwd_plain(q, k, v, True), 3),
        "flash_bwd_dkv": cuda_ms(lambda: fa.dkv_plain(q, k, v, do, lse, delta, True), 3),
        "flash_bwd_dq": cuda_ms(lambda: fa.dq_plain(q, k, v, do, lse, delta, True), 3),
    }
    # the library yardstick, timed here only: PyTorch's fused attention on
    # the same [b, h, s, d] inputs (the port never calls it).  Its backward
    # computes dK, dV and dQ in one call, so that one time stands against
    # dK/dV and dQ together, on both rows.
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4, do4 = (x.view(b, h, s, d) for x in (q, k, v, do))
    qg, kg, vg = (x.clone().requires_grad_() for x in (q4, k4, v4))
    sdpa_out = sdpa(qg, kg, vg, is_causal=True)   # one forward, built once
    sdpa_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        sdpa_out, (qg, kg, vg), do4, retain_graph=True))
    library = {"flash_fwd": cuda_ms(lambda: sdpa(q4, k4, v4, is_causal=True)),
               "flash_bwd_dkv": sdpa_bwd_ms, "flash_bwd_dq": sdpa_bwd_ms}

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(qg, kg, vg, is_causal=True), (qg, kg, vg), do4)

    sdpa_train_ms = cuda_ms(sdpa_fwd_bwd)
    flash_train_ms = ms["flash_fwd"] + ms["flash_bwd_dkv"] + ms["flash_bwd_dq"]
    log(f"timing bh={bh} s={s} d={d} bf16 causal: kernels {ms}, plain {plain_ms}, "
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
    kernel, and the step statistics."""
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
    return losses, launches, stats


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

    losses, launches, st = train_steps(trainer, state, batch,
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


def _gmm_inputs(rows, d, f, groups, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    lhs = torch.randn(rows, d, device="cuda", generator=g).bfloat16()
    rhs = (torch.randn(groups, d, f, device="cuda", generator=g) / math.sqrt(d)).bfloat16()
    gout = torch.randn(rows, f, device="cuda", generator=g).bfloat16()
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
    bad = {k: e for k, e in rel.items() if not e <= GMM_TOL[k.replace("_dlhs", "")]}
    if bad:
        raise AssertionError(f"gmm kernel disagrees with its plain version: {bad} "
                             f"(tolerance {GMM_TOL})")
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


def phase_gmm_kernels():
    from bagua_tpu_torch.ops import gmm as gm

    rows, G = MOE["b"] * MOE["s"] * MOE["k"], MOE["experts"]
    d, f = MOE["d_model"], MOE["d_ff"]
    balanced = [rows // G] * G
    skewed = [rows // 2] + [rows // (2 * (G - 1))] * (G - 2)
    skewed.append(rows - sum(skewed))             # one group holds half the rows
    empty = [0, rows // 2, 0, rows // 4, rows // 4, 0, 0, 0]
    check_gmm(*_gmm_inputs(300, 128, 256, 4, seed=9), [1, 0, 170, 100], "ragged 300 rows")
    errs = {}
    for m, n in ((d, f), (f, d)):
        inputs = _gmm_inputs(rows, m, n, G, seed=m)
        for label, sizes in (("skewed", skewed), ("empty groups", empty),
                             ("balanced", balanced)):
            e = check_gmm(*inputs, sizes, f"rows {rows} ({m}, {n}) {label}")
            for k, v in e.items():
                errs[k] = max(errs.get(k, 0.0), v)

    # times at the path's shapes and balanced sizes: the four K7a launches of
    # a MoE layer's step ((d, f) and (f, d), each plain and transposed) and
    # its two K7b launches
    sizes = torch.tensor(balanced, dtype=torch.int32, device="cuda")
    offs = torch.cumsum(sizes, 0, dtype=torch.int32)
    ms, plain_ms, library, bounds, refused = {}, {}, {}, {}, []
    names = ("grouped_matmul", "grouped_matmul_drhs")
    for name in names:
        ms[name], plain_ms[name], library[name], bounds[name] = [], [], [], []
    for m, n in ((d, f), (f, d)):
        lhs, rhs, gout = _gmm_inputs(rows, m, n, G, seed=m)
        rhs_t = rhs.transpose(1, 2).contiguous()   # [G, n, m]: d_lhs of [rows, n]
        variants = {
            "grouped_matmul": [
                (lambda: gm.grouped_matmul(lhs, rhs, sizes),
                 lambda: gm.grouped_matmul_plain(lhs, rhs, sizes),
                 lambda: torch._grouped_mm(lhs, rhs, offs=offs), (m, n)),
                (lambda: gm.grouped_matmul(lhs, rhs_t, sizes, transpose_rhs=True),
                 lambda: gm.grouped_matmul_plain(lhs, rhs_t, sizes, True),
                 lambda: torch._grouped_mm(lhs, rhs_t.transpose(1, 2), offs=offs), (m, n)),
            ],
            "grouped_matmul_drhs": [
                (lambda: gm.grouped_matmul_drhs(lhs, gout, sizes, G),
                 lambda: gm.grouped_matmul_drhs_plain(lhs, gout, sizes, G),
                 lambda: torch._grouped_mm(lhs.t(), gout, offs=offs), (m, n)),
            ],
        }
        for name, runs in variants.items():
            for kernel, plain, lib, shape in runs:
                ms[name].append(cuda_ms(kernel))
                plain_ms[name].append(cuda_ms(plain, 3))
                try:   # the yardstick only: a refusal is recorded, not fatal
                    library[name].append(cuda_ms(lib))
                except (RuntimeError, AttributeError, TypeError) as e:
                    library[name].append(None)
                    refused.append(f"{name} {shape}: {str(e).splitlines()[0]}")
                bounds[name].append(gmm_bound(name, rows, *shape, G))
    # the routing of a fresh model is not balanced: the skewed sizes' times
    lhs, rhs, gout = _gmm_inputs(rows, d, f, G, seed=1)
    sk = torch.tensor(skewed, dtype=torch.int32, device="cuda")
    log(f"gmm timing skewed {skewed} ({d}, {f}): grouped_matmul "
        f"{cuda_ms(lambda: gm.grouped_matmul(lhs, rhs, sk)):.4f} ms, grouped_matmul_drhs "
        f"{cuda_ms(lambda: gm.grouped_matmul_drhs(lhs, gout, sk, G)):.4f} ms")
    log(f"gmm timing rows {rows} G {G} balanced, per variant: kernels {ms}, plain "
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

    losses, launches, st = train_steps(trainer, state, batch,
                                       MOE["b"] * cfg.max_seq_len, [fa, gm])
    log_steps("slice 2", losses, launches, st)
    n_moe = cfg.n_layers // 2
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


def main():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    card = phase_device()
    phase_build()
    rows = phase_kernels()
    rows.update(phase_gmm_kernels())
    launches = phase_slice()
    launches_moe, _ = phase_slice_moe()
    torch.distributed.destroy_process_group()
    # each kernel's launches come from its own path: flash from slice 1,
    # gmm from slice 2 (slice 2 checked the flash counts too)
    for name, row in rows.items():
        row["launches"] = launches[name] if name in launches else launches_moe[name]
    log(card)
    log(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
