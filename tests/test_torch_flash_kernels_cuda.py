"""The port's flash-attention CUDA kernels against their plain versions.

These need an NVIDIA card (sm_90a) and ``nvcc``; without a card they skip.
On the card, where JAX is not installed, skip the JAX conftest:
``python -m pytest --noconftest -m cuda tests/test_torch_flash_kernels_cuda.py``.
Tolerances (max-abs error over the plain version's max-abs): bf16 2e-2 (the
kernel keeps q.k in f32 and rounds P before normalizing; the backward
kernels sum in another order), f16 5e-3 (the same roundings, in f16's ulp,
an eighth of bf16's), f32 1e-4 (another summation order).  Heads above 256
run the wide FMA kernels, held to the same tolerances.
"""

import pytest
import torch

from bagua_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda
TOL = {torch.bfloat16: 2e-2, torch.float16: 5e-3, torch.float32: 1e-4}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _rel(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
# 32, 96 and 136 run widened to 64, 128 and 256; 264, 384 and 512 on the
# wide kernels (one, three and four 128-column slices)
@pytest.mark.parametrize("d", [32, 64, 96, 128, 136, 256, 264, 384, 512])
@pytest.mark.parametrize("s,causal", [(256, True), (1000, True), (77, False)])
def test_kernels_match_plain(card, dtype, d, s, causal):
    g = torch.Generator(device="cuda").manual_seed(s + d)
    q, k, v, do = (torch.randn(3, s, d, device="cuda", dtype=dtype, generator=g)
                   for _ in range(4))
    counts = [f.launches for f in fa.KERNELS]
    o, lse = fa.flash_fwd(q, k, v, causal)
    po, plse = fa.fwd_plain(q, k, v, causal)
    delta = (do.float() * po.float()).sum(-1)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, plse, delta, causal)
    dq = fa.flash_bwd_dq(q, k, v, do, plse, delta, causal)
    pdk, pdv = fa.dkv_plain(q, k, v, do, plse, delta, causal)
    pdq = fa.dq_plain(q, k, v, do, plse, delta, causal)
    torch.cuda.synchronize()
    assert [f.launches for f in fa.KERNELS] == [c + 1 for c in counts]
    for got, want in ((o, po), (lse, plse), (dk, pdk), (dv, pdv), (dq, pdq)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert _rel(got, want) <= TOL[dtype]


def _backward(q, k, v, do, causal):
    """Kernel and plain dK, dV, dQ on one input (lse and delta from the
    plain forward, so that both sides read the same statistics)."""
    po, plse = fa.fwd_plain(q, k, v, causal)
    delta = (do.float() * po.float()).sum(-1)
    got = (*fa.flash_bwd_dkv(q, k, v, do, plse, delta, causal),
           fa.flash_bwd_dq(q, k, v, do, plse, delta, causal))
    want = (*fa.dkv_plain(q, k, v, do, plse, delta, causal),
            fa.dq_plain(q, k, v, do, plse, delta, causal))
    torch.cuda.synchronize()
    return got, want


def _forward(q, k, v, causal):
    """Kernel and plain (o, lse) on one input."""
    got, want = fa.flash_fwd(q, k, v, causal), fa.fwd_plain(q, k, v, causal)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64, 128, 136, 256])
@pytest.mark.parametrize("s", [1, 63, 127, 128, 129, 384, 1000])
def test_forward_at_tile_edges(card, s, d, causal, dtype):
    # the forward owns 128- or 192-query blocks and streams 64- or 128-key
    # tiles: every length around those edges, at three heads
    g = torch.Generator(device="cuda").manual_seed(1000 * s + d + causal + 7)
    q, k, v = (torch.randn(3, s, d, device="cuda", dtype=dtype, generator=g)
               for _ in range(3))
    got, want = _forward(q, k, v, causal)
    for name, a, b in zip(("o", "lse"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert _rel(a, b) <= TOL[dtype], name


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128, 136, 256])
@pytest.mark.parametrize("s", [1, 63, 127, 128, 129, 384, 1000])
def test_backward_at_tile_edges(card, s, d, causal, dtype):
    # the backward kernels own 128-row blocks (64 at D = 256) and stream
    # 64-row tiles: every length around those edges, at three heads
    g = torch.Generator(device="cuda").manual_seed(1000 * s + d + causal)
    q, k, v, do = (torch.randn(3, s, d, device="cuda", dtype=dtype, generator=g)
                   for _ in range(4))
    got, want = _backward(q, k, v, do, causal)
    scales = [w.float().abs().max() for w in want]
    if s == 1:
        # one key: P = 1 and dP = delta, so dS, dK and dQ are 0 in exact
        # arithmetic and both sides give rounding noise; dK and dQ are held
        # to 0 at the scale of the terms that cancel, dV's (dV = dO here)
        scales[0] = scales[2] = scales[1]
    for name, a, b, scale in zip(("dk", "dv", "dq"), got, want, scales):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert ((a.float() - b.float()).abs().max() / scale).item() <= TOL[dtype], name


@pytest.mark.parametrize("d", [64, 128, 256])
def test_backward_reads_no_row_of_the_next_head(card, d):
    # the forward and backward kernels: at a ragged length the last tile of
    # head 0 ends past s; a tensor map
    # over [bh * s, d] would fill it with head 1's rows instead of zeros.
    # Every row of head 1 is about 1e4, so such a read would show in head 0.
    s = 100
    g = torch.Generator(device="cuda").manual_seed(d)
    q, k, v, do = (torch.randn(3, s, d, device="cuda", dtype=torch.bfloat16, generator=g)
                   for _ in range(4))
    for x in (q, k, v, do):
        x[1] = 1e4
    got, want = _backward(q, k, v, do, True)
    fwd_got, fwd_want = _forward(q, k, v, True)
    for name, a, b in zip(("dk", "dv", "dq", "o", "lse"), (*got, *fwd_got),
                          (*want, *fwd_want)):
        assert _rel(a[0], b[0]) <= TOL[torch.bfloat16], name
        assert _rel(a[2], b[2]) <= TOL[torch.bfloat16], name


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [264, 384])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 129, 200])
def test_wide_heads_at_tile_edges(card, s, d, causal, dtype):
    # the wide kernels own 64-row tiles and 128-column slices of the output
    # (264: a slice of 8 columns; 384: three whole slices): lengths around the
    # row tile's edges, forward and backward, at three heads
    g = torch.Generator(device="cuda").manual_seed(1000 * s + d + causal + 3)
    q, k, v, do = (torch.randn(3, s, d, device="cuda", dtype=dtype, generator=g)
                   for _ in range(4))
    (got_o, got_lse), (want_o, want_lse) = _forward(q, k, v, causal)
    assert _rel(got_o, want_o) <= TOL[dtype] and _rel(got_lse, want_lse) <= TOL[dtype]
    got, want = _backward(q, k, v, do, causal)
    scales = [w.float().abs().max() for w in want]
    if s == 1:   # as in test_backward_at_tile_edges: dK and dQ are rounding noise
        scales[0] = scales[2] = scales[1]
    for name, a, b, scale in zip(("dk", "dv", "dq"), got, want, scales):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert ((a.float() - b.float()).abs().max() / scale).item() <= TOL[dtype], name


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_head_of_1024(card, dtype):
    # the widest head tested: d 1024 at s 1024 (eight output slices), every
    # kernel against its plain version
    g = torch.Generator(device="cuda").manual_seed(1024)
    q, k, v, do = (torch.randn(2, 1024, 1024, device="cuda", dtype=dtype, generator=g)
                   for _ in range(4))
    (fwd_got, fwd_want), (bwd_got, bwd_want) = _forward(q, k, v, True), _backward(
        q, k, v, do, True)
    for got, want in zip((*fwd_got, *bwd_got), (*fwd_want, *bwd_want)):
        assert got.shape == want.shape and _rel(got, want) <= TOL[dtype]


@pytest.mark.parametrize("d", [64, 256, 384])
def test_backward_is_deterministic(card, d):
    # each output tile is written by one block in a fixed order: two
    # launches on the same inputs agree bit for bit, backward and forward
    # (at D = 256 too, where two warpgroups split dK and dV, and on the wide
    # kernels, whose column slices each recompute the scores)
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (torch.randn(8, 1000, d, device="cuda", dtype=torch.bfloat16, generator=g)
                   for _ in range(4))
    first, _ = _backward(q, k, v, do, True)
    second, _ = _backward(q, k, v, do, True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    # the forward too: o and lse
    (o1, lse1), _ = _forward(q, k, v, True)
    (o2, lse2), _ = _forward(q, k, v, True)
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    q = torch.randn(2, 64, 36, device="cuda")   # flash_attention pads it; the wrappers refuse
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.flash_fwd(q, q, q, True)
    # a head wider than 256 is taken (the wide kernels): 264 by the wrapper,
    # 260 through flash_attention, which pads it to 264
    q = torch.randn(2, 64, 264, device="cuda")
    counts = [f.launches for f in fa.KERNELS]
    assert fa.flash_fwd(q, q, q, True)[0].shape == q.shape
    wide = fa.flash_attention(*(torch.randn(1, 64, 2, 260, device="cuda") for _ in range(3)))
    assert wide.shape == (1, 64, 2, 260) and torch.isfinite(wide).all()
    assert [f.launches for f in fa.KERNELS] == [counts[0] + 2, *counts[1:]]
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd(q[..., :0], q[..., :0], q[..., :0], True)
    q = torch.randn(2, 64, 64, device="cuda")
    with pytest.raises(ValueError, match="within the stored"):
        fa.flash_fwd(q, q, q, True, head_dim=72)
    q = torch.randn(2, 64, 64, device="cuda", dtype=torch.float64)
    with pytest.raises(ValueError, match="float16, bfloat16 or float32"):
        fa.flash_fwd(q, q, q, True)
    q = torch.randn(2, 64, 64, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd(q.transpose(0, 1), q.transpose(0, 1), q.transpose(0, 1), True)
    q = torch.randn(2 * 64 * 64 + 1, device="cuda", dtype=torch.bfloat16)[1:].view(2, 64, 64)
    with pytest.raises(ValueError, match="16-byte boundary"):
        fa.flash_fwd(q, q, q, True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_dim_32_model_matches_the_cpu(card, dtype):
    # examples/squad_finetune.py's --tiny model has head_dim 32: its
    # attention runs the kernels (widened to 64) on the card, one launch of
    # each a layer, and agrees with the same model on the CPU, whose
    # attention is the kernels' plain versions.  f32: loss and gradients
    # within 1e-4; bf16: logits within 5e-2, the tolerance of the slices'
    # whole-model checks.
    from bagua_tpu_torch.models.transformer import TransformerConfig, TransformerLM, lm_loss_fn

    cfg = TransformerConfig(vocab_size=1024, d_model=128, n_heads=4, n_layers=4, d_ff=512,
                            max_seq_len=128, dtype=dtype)
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (2, cfg.max_seq_len + 1), generator=g)
    weights = TransformerLM(cfg, device="cpu", seed=0).state_dict()
    runs = {}
    for device in ("cuda", "cpu"):
        model = TransformerLM(cfg, device=device)
        model.load_state_dict(weights)
        fa.reset_launch_counts()
        loss = lm_loss_fn(model, {"tokens": tokens.to(device)})
        loss.backward()
        with torch.no_grad():
            logits = model(tokens[:1, :cfg.max_seq_len].to(device))
        runs[device] = (loss, logits, [p.grad for p in model.parameters()],
                        [f.launches for f in fa.KERNELS])
    (loss, logits, grads, launches), (cpu_loss, cpu_logits, cpu_grads, cpu_launches) = (
        runs["cuda"], runs["cpu"])
    assert launches == [2 * cfg.n_layers, cfg.n_layers, cfg.n_layers]   # loss, then logits
    assert cpu_launches == [0, 0, 0]
    assert torch.isfinite(loss) and all(torch.isfinite(p).all() for p in grads)
    if dtype == torch.float32:
        assert _rel(loss.cpu().reshape(1), cpu_loss.reshape(1)) <= 1e-4
        for a, b in zip(grads, cpu_grads):
            assert _rel(a.cpu(), b) <= 1e-4
    else:
        assert _rel(logits.cpu(), cpu_logits) <= 5e-2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("d", [100, 20, 250])
def test_entry_point_pads_a_head(card, d, dtype):
    # a head that is not a multiple of 8 goes through flash_attention padded
    # to one (104, 24, 256) and cut back: the kernels run (one launch each),
    # with the scale of the real head, and the output and gradients equal
    # the same call on the CPU, whose wrappers run the plain versions on the
    # unpadded head, within the dtype's tolerance (gradients, two products
    # deep, within twice it)
    g = torch.Generator(device="cuda").manual_seed(d)
    q, k, v, do = (torch.randn(2, 300, 2, d, device="cuda", dtype=dtype, generator=g)
                   for _ in range(4))
    runs = []
    for device in ("cuda", "cpu"):
        leaves = [x.detach().to(device).requires_grad_() for x in (q, k, v)]
        fa.reset_launch_counts()
        out = fa.flash_attention(*leaves)
        out.backward(do.to(device))
        torch.cuda.synchronize()
        runs.append((out.cpu(), [x.grad.cpu() for x in leaves],
                     [f.launches for f in fa.KERNELS]))
    (out, grads, launches), (ref, ref_grads, ref_launches) = runs
    assert launches == [1, 1, 1] and ref_launches == [0, 0, 0]
    assert out.shape == q.shape and out.dtype == dtype
    assert _rel(out, ref) <= TOL[dtype]
    for a, b in zip(grads, ref_grads):
        assert a.shape == q.shape and _rel(a, b) <= 2 * TOL[dtype]
