"""The port's flash-attention CUDA kernels against their plain versions.

These need an NVIDIA card (sm_90a) and ``nvcc``; without a card they skip.
On the card, where JAX is not installed, skip the JAX conftest:
``python -m pytest --noconftest -m cuda tests/test_torch_flash_kernels_cuda.py``.
Tolerances (max-abs error over the plain version's max-abs): bf16 2e-2 (the
kernel keeps q.k in f32 and rounds P before normalizing; the backward
kernels sum in another order), f32 1e-4 (another summation order).
"""

import pytest
import torch

from bagua_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _rel(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 128])
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


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [1, 63, 127, 128, 129, 384, 1000])
def test_backward_at_tile_edges(card, s, d, causal):
    # the backward kernels own 128-row blocks and stream 64-row tiles: every
    # length around those edges, at three heads
    g = torch.Generator(device="cuda").manual_seed(1000 * s + d + causal)
    q, k, v, do = (torch.randn(3, s, d, device="cuda", dtype=torch.bfloat16, generator=g)
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
        assert ((a.float() - b.float()).abs().max() / scale).item() <= TOL[torch.bfloat16], name


@pytest.mark.parametrize("d", [64, 128])
def test_backward_reads_no_row_of_the_next_head(card, d):
    # at a ragged length the last tile of head 0 ends past s; a tensor map
    # over [bh * s, d] would fill it with head 1's rows instead of zeros.
    # Every row of head 1 is about 1e4, so such a read would show in head 0.
    s = 100
    g = torch.Generator(device="cuda").manual_seed(d)
    q, k, v, do = (torch.randn(3, s, d, device="cuda", dtype=torch.bfloat16, generator=g)
                   for _ in range(4))
    for x in (q, k, v, do):
        x[1] = 1e4
    got, want = _backward(q, k, v, do, True)
    for name, a, b in zip(("dk", "dv", "dq"), got, want):
        assert _rel(a[0], b[0]) <= TOL[torch.bfloat16], name
        assert _rel(a[2], b[2]) <= TOL[torch.bfloat16], name


def test_backward_is_deterministic(card):
    # each output tile is written by one block in a fixed order: two
    # launches on the same inputs agree bit for bit
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (torch.randn(8, 1000, 64, device="cuda", dtype=torch.bfloat16, generator=g)
                   for _ in range(4))
    first, _ = _backward(q, k, v, do, True)
    second, _ = _backward(q, k, v, do, True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    q = torch.randn(2, 64, 32, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd(q, q, q, True)
    q = torch.randn(2, 64, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_fwd(q, q, q, True)
    q = torch.randn(2, 64, 64, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd(q.transpose(0, 1), q.transpose(0, 1), q.transpose(0, 1), True)
    q = torch.randn(2 * 64 * 64 + 1, device="cuda", dtype=torch.bfloat16)[1:].view(2, 64, 64)
    with pytest.raises(ValueError, match="16-byte boundary"):
        fa.flash_fwd(q, q, q, True)
