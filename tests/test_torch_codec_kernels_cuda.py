"""The port's codec CUDA kernels (K1-K5) against their plain versions.

These need an NVIDIA card (sm_90a) and ``nvcc``; without a card they skip.
On the card, where JAX is not installed, skip the JAX conftest:
``python -m pytest --noconftest -m cuda tests/test_torch_codec_kernels_cuda.py``.
The kernels and the plain versions do the same IEEE-rounded f32 operations,
so sidecars, payload bytes and decoded values must be exactly equal (any NaN
equal to any NaN); a chunk holding a NaN or an inf has a NaN grid, where the
u8 payload is undefined, so its payload is not compared.  The sign kernels:
K4's payload exactly equal, its scale (a sum taken in another order) within
1e-6 relative; K5 on the same parts exactly equal.
"""

import pytest
import torch

from bagua_tpu_torch.ops import codec as cd

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _same(a, b):
    nan = a.isnan()
    return torch.equal(nan, b.isnan()) and torch.equal(a.view(torch.int32)[~nan],
                                                       b.view(torch.int32)[~nan])


def _input(kind, n, m, dtype):
    g = torch.Generator(device="cuda").manual_seed(n * 7919 + m)
    x = torch.randn(n * m, device="cuda", generator=g)
    if kind == "constant":
        x = torch.ones_like(x)
    elif kind == "inf":
        x[m // 2] = float("inf")
    elif kind == "nan":
        x[m - 1] = float("nan")
    return x.to(dtype)


CASES = [("normal", 2, 32768), ("normal", 2, 1310720), ("normal", 4, 100003),
         ("normal", 1, 5), ("normal", 3, 4_194_307), ("constant", 2, 4099),
         ("inf", 2, 50001), ("nan", 2, 50001)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind,n,m", CASES)
def test_codec_kernels_match_plain(card, kind, n, m, dtype):
    x = _input(kind, n, m, dtype)
    mn, mx, p = cd.compress_chunked(x, n)
    pmn, pmx, pp = cd.compress_chunked_plain(x, n)
    finite = torch.isfinite(x.view(n, m).float()).all(dim=1)
    assert _same(mn, pmn) and _same(mx, pmx)
    assert torch.equal(p[finite], pp[finite])
    assert _same(cd.decompress_chunked(mn, mx, p), cd.decompress_chunked_plain(pmn, pmx, pp))
    assert _same(cd.absmax_chunked(x, n), cd.absmax_chunked_plain(x, n))
    if kind == "nan":
        assert mn[0].isnan() and cd.decompress_chunked(mn, mx, p)[:m].isnan().all()


SIGN_CASES = [("normal", 2, 32768), ("normal", 2, 1310720), ("normal", 3, 100003),
              ("normal", 1, 3), ("normal", 2, 4_194_307), ("zero", 2, 5000),
              ("inf", 2, 50001), ("nan", 2, 50001)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind,n,m", SIGN_CASES)
def test_sign_kernels_match_plain(card, kind, n, m, dtype):
    x = _input("normal" if kind == "zero" else kind, n, m, dtype)
    if kind == "zero":
        x.zero_()
    scale, p = cd.sign_compress_chunked(x, n)
    pscale, pp = cd.sign_compress_chunked_plain(x, n)
    assert torch.equal(p, pp)
    finite = torch.isfinite(pscale)
    assert torch.equal(finite, torch.isfinite(scale))
    assert torch.equal(scale.isnan(), pscale.isnan())
    torch.testing.assert_close(scale[finite], pscale[finite], rtol=1e-6, atol=0)
    assert _same(cd.sign_decompress_chunked(scale, p), cd.sign_decompress_chunked_plain(scale, p))
    if kind == "zero":
        assert (scale == 0).all() and (p == 255).all()
    if kind in ("nan", "inf"):
        assert not finite[0] and not torch.isfinite(cd.sign_decompress_chunked(scale, p)[0]).any()


def test_codec_kernels_count_launches_and_reject_bad_input(card):
    cd.reset_launch_counts()
    x = torch.randn(8, device="cuda")
    mn, mx, p = cd.compress_chunked(x, 2)
    cd.decompress_chunked(mn, mx, p)
    cd.absmax_chunked(x, 4)
    scale, sp = cd.sign_compress_chunked(x, 2)
    cd.sign_decompress_chunked(scale, sp)
    assert [k.launches for k in cd.KERNELS] == [1, 1, 1, 1, 1]
    with pytest.raises(ValueError):
        cd.sign_decompress_chunked(scale, sp[:, :100].contiguous())
    with pytest.raises(ValueError):
        cd.compress_chunked(x, 3)
    with pytest.raises(ValueError):
        cd.absmax_chunked(x.half(), 2)
    with pytest.raises(ValueError):
        cd.compress_chunked(torch.randn(4, 4, device="cuda").t(), 2)
