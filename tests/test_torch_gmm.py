"""Port's grouped matmul against the JAX package's, on the same inputs.

The JAX side runs its Pallas kernels in interpret mode (``interpret=True,
force=True``, as ``tests/test_gmm.py`` does) and its dense
``gmm_reference``; the port runs its wrappers' plain versions (CPU tensors).
Inputs are made with numpy from a seed.  Forward, d_lhs and d_rhs are held
with ragged group sizes and empty groups.  Tolerances: f32 1e-5 of the
largest magnitude (summation order only); bf16 1e-2 of it (both sides sum in
f32 and round once to bf16, so they differ by at most one bf16 ulp, 2^-8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bagua_tpu.ops.gmm import gmm as jgmm
from bagua_tpu.ops.gmm import gmm_reference as jgmm_reference
from bagua_tpu_torch.ops import gmm as tgmm

# one intra-op thread: these tests share the CPU with the other test workers
torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 1e-2)}
SIZES = [[100, 156], [0, 256, 0], [37, 1, 218], [60, 0, 196]]


def _case(sizes, d, f, seed):
    rng = np.random.default_rng(seed)
    rows = int(np.sum(sizes))
    lhs = rng.standard_normal((rows, d)).astype(np.float32)
    rhs = rng.standard_normal((len(sizes), d, f)).astype(np.float32)
    gout = rng.standard_normal((rows, f)).astype(np.float32)
    return lhs, rhs, gout, np.asarray(sizes, np.int32)


def _close(got, want, tol, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max(),
                               err_msg=what)


@pytest.mark.parametrize("kind", sorted(DTYPES))
@pytest.mark.parametrize("sizes", SIZES, ids=lambda s: "-".join(map(str, s)))
def test_gmm_and_grads_match_pallas_interpret(kind, sizes):
    jdt, tdt, tol = DTYPES[kind]
    lhs, rhs, gout, gs = _case(sizes, 128, 256, seed=len(sizes) + sizes[0])
    jl, jr, jg = (jnp.asarray(a, jdt) for a in (lhs, rhs, gout))
    out, vjp = jax.vjp(lambda a, b: jgmm(a, b, jnp.asarray(gs), interpret=True,
                                         force=True), jl, jr)
    d_lhs, d_rhs = vjp(jg)

    tl = torch.tensor(lhs).to(tdt).requires_grad_()
    tr = torch.tensor(rhs).to(tdt).requires_grad_()
    got = tgmm.gmm(tl, tr, torch.from_numpy(gs))
    got.backward(torch.tensor(gout).to(tdt))
    assert got.dtype == tdt and tl.grad.dtype == tdt and tr.grad.dtype == tdt
    _close(got.detach(), out, tol, "out")
    _close(tl.grad, d_lhs, tol, "d_lhs")
    _close(tr.grad, d_rhs, tol, "d_rhs")
    # an empty group's d_rhs is exactly zero on both sides
    for g, n in enumerate(sizes):
        if n == 0:
            assert torch.all(tr.grad[g] == 0)
    # and the golden agrees too
    _close(tgmm.gmm_reference(tl.detach(), tr.detach(), torch.from_numpy(gs)),
           jgmm_reference(jl, jr, jnp.asarray(gs)), tol, "gmm_reference")


def test_rows_past_the_last_group_are_zero():
    # the JAX golden gives rows past sum(group_sizes) no group (zero); the
    # port's kernels and plain versions write zeros there
    lhs, rhs, gout, _ = _case([16, 16], 8, 8, seed=3)
    gs = np.asarray([10, 12], np.int32)
    want = jgmm_reference(jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(gs))
    got = tgmm.gmm(torch.tensor(lhs), torch.tensor(rhs), torch.from_numpy(gs))
    _close(got, want, 1e-6, "out")
    assert torch.all(got[22:] == 0)
    d_rhs = tgmm.grouped_matmul_drhs(torch.tensor(lhs), torch.tensor(gout),
                                     torch.from_numpy(gs), 2)
    np.testing.assert_allclose(d_rhs[1].numpy(), lhs[10:22].T @ gout[10:22],
                               rtol=1e-5, atol=1e-5)


def test_transposed_rhs_is_the_d_lhs_product():
    lhs, rhs, gout, gs = _case([5, 0, 11], 8, 12, seed=4)
    got = tgmm.grouped_matmul(torch.tensor(gout), torch.tensor(rhs),
                              torch.from_numpy(gs), transpose_rhs=True)
    want = np.concatenate([gout[:5] @ rhs[0].T, gout[5:] @ rhs[2].T])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_gmm_rejects_mismatched_shapes():
    with pytest.raises(ValueError, match="expected lhs"):
        tgmm.gmm(torch.zeros(4, 8), torch.zeros(2, 6, 3), torch.tensor([2, 2]))
