"""The port's flash-attention CUDA kernels against their plain versions.

These need an NVIDIA card (sm_90a) and ``nvcc``; without a card they skip.
On the card, where JAX is not installed, skip the JAX conftest:
``python -m pytest --noconftest -m cuda tests/test_torch_flash_kernels_cuda.py``.
Tolerances (max-abs error over the plain version's max-abs): bf16 2e-2 (the
kernel keeps q.k in f32 and rounds P before normalizing), f32 1e-4 (another
summation order).
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
