"""Port's grouped matmul against the JAX package's, on the same inputs.

The JAX side runs its Pallas kernels in interpret mode (``interpret=True,
force=True``, as ``tests/test_gmm.py`` does) and its dense
``gmm_reference``; the port runs its wrappers' plain versions (CPU tensors).
Inputs are made with numpy from a seed.  Forward, d_lhs and d_rhs are held
with ragged group sizes and empty groups.  Tolerances: f32 1e-5 of the
largest magnitude (summation order only); bf16 1e-2 of it (both sides sum in
f32 and round once to bf16, so they differ by at most one bf16 ulp, 2^-8);
f16 2e-3 of it (the same in f16, whose ulp is 2^-11 of an element, with the
f32 sums of the products in another order).
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
          "bf16": (jnp.bfloat16, torch.bfloat16, 1e-2),
          "f16": (jnp.float16, torch.float16, 2e-3)}
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


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.float32,
                                   torch.float64])
@pytest.mark.parametrize("d,f", [(64, 128), (128, 64), (128, 256), (192, 128), (0, 128),
                                 (100, 30), (7, 1), (64, 0)])
def test_kernels_take_rule(d, f, dtype):
    # any positive d and f in a 16-bit type or f32; gmm pads widths that
    # are not multiples of 8 for the kernels
    want = dtype != torch.float64 and d > 0 and f > 0
    assert tgmm.kernels_take(d, f, dtype) is want


def test_non_cpu_tensor_takes_the_kernel_or_the_counted_reference():
    # on meta tensors (not the CPU) gmm has no fallback: d 64 and 128, in
    # bf16 or f32, all reach the kernel wrapper, which refuses a tensor that
    # is not on a CUDA card
    tgmm.reset_launch_counts()
    sizes = torch.tensor([3, 0, 7])
    for d, dtype in ((64, torch.bfloat16), (128, torch.float32), (128, torch.bfloat16)):
        lhs = torch.empty(10, d, device="meta", dtype=dtype)
        rhs = torch.empty(3, d, 128, device="meta", dtype=dtype)
        with pytest.raises(ValueError, match="CUDA tensors"):
            tgmm.gmm(lhs, rhs, sizes)
    assert [k.launches for k in tgmm.KERNELS] == [0, 0]


def test_cpu_tensors_are_not_counted():
    tgmm.reset_launch_counts()
    lhs, rhs, _, gs = _case([4, 6], 8, 12, seed=5)
    got = tgmm.gmm(torch.tensor(lhs), torch.tensor(rhs), torch.from_numpy(gs))
    want = np.concatenate([lhs[:4] @ rhs[0], lhs[4:] @ rhs[1]])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert [k.launches for k in tgmm.KERNELS] == [0, 0]


@pytest.mark.parametrize("kind", sorted(DTYPES))
def test_odd_widths_match_jax(monkeypatch, kind):
    # d 100 and f 30, not multiples of 8: JAX runs its gmm_reference there
    # (only multiples of 128 take its kernel); the port's gmm on the kernel
    # path pads lhs to [rows, 104] and rhs to [G, 104, 32] and cuts the
    # output to f.  Sent down that path on the CPU (the wrappers' plain
    # versions take the padded operands), output and gradients match JAX's,
    # within the kind's tolerance, and have the unpadded shapes.
    jdt, tdt, tol = DTYPES[kind]
    sizes = [37, 0, 90]
    lhs, rhs, gout, gs = _case(sizes, 100, 30, seed=21)
    jl, jr, jg = (jnp.asarray(a, jdt) for a in (lhs, rhs, gout))
    out, vjp = jax.vjp(lambda a, b: jgmm(a, b, jnp.asarray(gs)), jl, jr)
    d_lhs, d_rhs = vjp(jg)
    monkeypatch.setattr(tgmm, "_kernel_path", lambda x: True)
    tl = torch.tensor(lhs).to(tdt).requires_grad_()
    tr = torch.tensor(rhs).to(tdt).requires_grad_()
    got = tgmm.gmm(tl, tr, torch.from_numpy(gs))
    got.backward(torch.tensor(gout).to(tdt))
    assert got.shape == (127, 30) and tl.grad.shape == tl.shape and tr.grad.shape == tr.shape
    _close(got.detach(), out, tol, "out")
    _close(tl.grad, d_lhs, tol, "d_lhs")
    _close(tr.grad, d_rhs, tol, "d_rhs")
    assert torch.all(tr.grad[1] == 0)
