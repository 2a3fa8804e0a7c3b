"""The port's grouped-matmul CUDA kernels (K7) against their plain versions.

These need an NVIDIA card (sm_90a) and ``nvcc``; without a card they skip.
On the card, where JAX is not installed, skip the JAX conftest:
``python -m pytest --noconftest -m cuda tests/test_torch_gmm_kernels_cuda.py``.
Tolerances (max-abs error over the plain version's max-abs): the bf16
product 1e-2 (kernel and plain version both sum in f32 and round once to
bf16, so they differ by at most one bf16 ulp, 2^-8 of an element); the f32
d_rhs 1e-4 (another summation order of exact bf16 products).
"""

import pytest
import torch

from bagua_tpu_torch.ops import gmm as gm

pytestmark = pytest.mark.cuda
TOL_BF16, TOL_F32 = 1e-2, 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _rel(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def _case(rows, d, f, n_groups, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    lhs = torch.randn(rows, d, device="cuda", generator=g).bfloat16()
    rhs = torch.randn(n_groups, d, f, device="cuda", generator=g).bfloat16()
    gout = torch.randn(rows, f, device="cuda", generator=g).bfloat16()
    return lhs, rhs, gout


SIZES = {
    "balanced": [64, 64, 64, 64],
    "skewed": [5, 200, 3, 48],        # one group holds 78% of the rows
    "empty": [0, 130, 0, 126],        # empty groups at both ends and between
    "ragged": [1, 127, 129, 0],       # smaller and larger than one tile
    "short": [50, 0, 60, 20],         # 130 of 256 rows grouped; the rest zero
}


@pytest.mark.parametrize("d,f", [(128, 256), (256, 128)])
@pytest.mark.parametrize("kind", sorted(SIZES))
def test_kernels_match_plain(card, kind, d, f):
    rows = 256
    lhs, rhs, gout = _case(rows, d, f, 4, seed=d + len(kind))
    sizes = torch.tensor(SIZES[kind], dtype=torch.int32, device="cuda")
    counts = [k.launches for k in gm.KERNELS]
    out = gm.grouped_matmul(lhs, rhs, sizes)
    d_lhs = gm.grouped_matmul(gout, rhs, sizes, transpose_rhs=True)
    d_rhs = gm.grouped_matmul_drhs(lhs, gout, sizes, 4)
    torch.cuda.synchronize()
    assert [k.launches for k in gm.KERNELS] == [counts[0] + 2, counts[1] + 1]
    want = gm.grouped_matmul_plain(lhs, rhs, sizes)
    want_dl = gm.grouped_matmul_plain(gout, rhs, sizes, transpose_rhs=True)
    want_dr = gm.grouped_matmul_drhs_plain(lhs, gout, sizes, 4)
    for got, ref, tol in ((out, want, TOL_BF16), (d_lhs, want_dl, TOL_BF16),
                          (d_rhs, want_dr, TOL_F32)):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert _rel(got, ref) <= tol
    grouped = int(sum(SIZES[kind]))
    assert torch.all(out[grouped:] == 0) and torch.all(d_lhs[grouped:] == 0)
    for gi, n in enumerate(SIZES[kind]):
        if n == 0:
            assert torch.all(d_rhs[gi] == 0)


def test_gmm_autograd_uses_both_kernels(card):
    lhs, rhs, gout = _case(300, 128, 256, 3, seed=7)
    sizes = torch.tensor([100, 0, 200], device="cuda")   # int64: gmm casts it
    lhs.requires_grad_()
    w = rhs.float().requires_grad_()
    counts = [k.launches for k in gm.KERNELS]
    out = gm.gmm(lhs, w.bfloat16(), sizes)
    out.backward(gout)
    assert [k.launches for k in gm.KERNELS] == [counts[0] + 2, counts[1] + 1]
    lr, wr = lhs.detach().clone().requires_grad_(), w.detach().clone().requires_grad_()
    ref = gm.grouped_matmul_plain(lr, wr.bfloat16(), sizes)
    ref.backward(gout)
    assert w.grad.dtype == torch.float32 and torch.all(w.grad[1] == 0)
    assert _rel(out, ref) <= TOL_BF16
    assert _rel(lhs.grad, lr.grad) <= TOL_BF16
    assert _rel(w.grad, wr.grad) <= TOL_BF16   # d_rhs rounded to rhs's bf16


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    lhs, rhs, gout = _case(64, 128, 128, 2, seed=1)
    sizes = torch.tensor([32, 32], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="bfloat16"):
        gm.grouped_matmul(lhs.float(), rhs.float(), sizes)
    with pytest.raises(ValueError, match="multiple of 128"):
        gm.grouped_matmul(lhs[:, :64].contiguous(), rhs[:, :64].contiguous(), sizes)
    with pytest.raises(ValueError, match="int32"):
        gm.grouped_matmul(lhs, rhs, sizes.long())
    with pytest.raises(ValueError, match="contiguous"):
        gm.grouped_matmul_drhs(lhs, gout.t().contiguous().t(), sizes, 2)
    with pytest.raises(ValueError, match="do not match"):
        gm.grouped_matmul(lhs, rhs, sizes[:1])
