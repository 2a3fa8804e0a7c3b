"""Port's flash attention against the JAX package's, on the CPU.

The same numpy inputs go through the JAX ``flash_attention`` (its Pallas
kernels in interpret mode, as tests/test_flash_attention.py runs them) and
through the port's ``flash_attention``, whose wrappers take the kernels'
plain versions for CPU tensors.  Tolerances are the JAX tests' own: f32
2e-5 for the forward and 5e-5 for the gradients (another summation order),
bf16 2e-2 (P and the products rounded to bf16 at other places); f16 5e-3 of
the largest magnitude (the same roundings in f16, whose ulp is 2^-10 below
2: five of them).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bagua_tpu_torch.ops import flash_attention as tfa

# one intra-op thread: these tests share the CPU with the other test workers
torch.set_num_threads(1)

# the module, not the function that bagua_tpu.ops re-exports under its name
jfa = importlib.import_module("bagua_tpu.ops.flash_attention")


def _inputs(seed, b=1, s=256, h=2, d=64, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(n)]


def _jax_out_and_grads(fn, q, k, v, g):
    out, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    return out, vjp(jnp.asarray(g))


def _torch_grads(fn, q, k, v, g):
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = fn(*leaves)
    (out * torch.tensor(g)).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in leaves]


@pytest.mark.parametrize("s", [128, 256, 384, 512])
@pytest.mark.parametrize("causal", [True, False])
def test_forward_and_grads_match_jax(causal, s):
    q, k, v, g = _inputs(s + causal, s=s)
    jfn = lambda q, k, v: jfa.flash_attention(
        q, k, v, jnp.float32, causal=causal, interpret=True, force=True)
    want, want_grads = _jax_out_and_grads(jfn, q, k, v, g)
    got, grads = _torch_grads(
        lambda q, k, v: tfa.flash_attention(q, k, v, causal=causal), q, k, v, g)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    for w, o, name in zip(want_grads, grads, "qkv"):
        np.testing.assert_allclose(o, w, atol=5e-5, rtol=5e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("block_q,block_k", [(128, 256), (256, 128)])
def test_mismatched_jax_blocks(block_q, block_k):
    q, k, v, g = _inputs(7, s=512, h=1)
    jfn = lambda q, k, v: jfa.flash_attention(
        q, k, v, jnp.float32, block_q=block_q, block_k=block_k,
        interpret=True, force=True)
    want, want_grads = _jax_out_and_grads(jfn, q, k, v, g)
    got, grads = _torch_grads(tfa.flash_attention, q, k, v, g)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    for w, o, name in zip(want_grads, grads, "qkv"):
        np.testing.assert_allclose(o, w, atol=5e-5, rtol=5e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
def test_with_lse_matches_jax(causal):
    # the lse output and its cotangent (the dlse path of the backward)
    q, k, v, g = _inputs(11, s=256)
    g_lse = np.random.default_rng(12).standard_normal((1, 2, 256)).astype(np.float32)

    def jloss(q, k, v):
        o, lse = jfa.flash_attention_with_lse(q, k, v, causal=causal, interpret=True)
        return (o * g).sum() + (lse * g_lse).sum(), (o, lse)

    jq, jk, jv = map(jnp.asarray, (q, k, v))
    (_, (jo, jlse)), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(jq, jk, jv)
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    o, lse = tfa.flash_attention_with_lse(*leaves, causal=causal)
    ((o * torch.tensor(g)).sum() + (lse * torch.tensor(g_lse)).sum()).backward()
    assert o.dtype == torch.float32 and lse.shape == (1, 2, 256)
    np.testing.assert_allclose(o.detach().numpy(), jo, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.detach().numpy(), jlse, atol=2e-5, rtol=2e-5)
    for w, x, name in zip(jgrads, leaves, "qkv"):
        np.testing.assert_allclose(x.grad.numpy(), w, atol=5e-5, rtol=5e-5,
                                   err_msg=f"d{name}")


def test_bf16_forward_close():
    q, k, v = _inputs(4, b=2, s=256, n=3)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = jfa.flash_attention(jq, jk, jv, jnp.bfloat16, interpret=True, force=True)
    tq, tk, tv = (torch.tensor(x).to(torch.bfloat16) for x in (q, k, v))
    got = tfa.flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("causal", [True, False])
def test_reference_attention_matches_jax(causal):
    q, k, v = _inputs(5, s=96, n=3)
    want = jfa.reference_attention(*map(jnp.asarray, (q, k, v)), jnp.float32,
                                   causal=causal)
    got = tfa.reference_attention(*map(torch.tensor, (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("s", [1, 100, 127, 128, 129])
def test_plain_kernels_match_autograd_on_ragged_length(s):
    # the kernels' plain versions (what the chip smoke holds the kernels to)
    # against autograd through the plain forward, at lengths around the
    # kernels' 64-row tiles and 128-row blocks
    q, k, v, do = (torch.tensor(x[0].transpose(1, 0, 2))
                   for x in _inputs(6, s=s, h=3))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o, lse = tfa.fwd_plain(*leaves, True)
    o.backward(do)
    delta = (do * o.detach()).sum(-1)
    dk, dv = tfa.dkv_plain(q, k, v, do, lse.detach(), delta, True)
    dq = tfa.dq_plain(q, k, v, do, lse.detach(), delta, True)
    for got, x in zip((dq, dk, dv), leaves):
        torch.testing.assert_close(got, x.grad, atol=1e-5, rtol=1e-5)


def test_cpu_wrappers_do_not_count_launches():
    tfa.reset_launch_counts()
    q, k, v, g = _inputs(8, s=128)
    _torch_grads(tfa.flash_attention, q, k, v, g)
    assert [f.launches for f in tfa.KERNELS] == [0, 0, 0]


def test_non_cpu_tensor_takes_the_kernel_or_raises():
    # a tensor that is not on the CPU never takes the plain version: here
    # (a meta tensor) the kernel wrapper refuses it instead of falling back
    q = torch.empty(2, 128, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.flash_fwd(q, q, q, True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.flash_bwd_dq(q, q, q, q, None, None, True)
    # the entry point has no fallback off the CPU: a narrow head_dim reaches
    # the wrappers like any other, which refuse a tensor not on a CUDA card
    tfa.reset_launch_counts()
    for d in (32, 64):
        q = torch.empty(2, 128, 4, d, device="meta")
        with pytest.raises(ValueError, match="CUDA tensors"):
            tfa.flash_attention(q, q, q)
    assert [f.launches for f in tfa.KERNELS] == [0, 0, 0]


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.float32,
                                   torch.float64])
@pytest.mark.parametrize("head_dim", [0, 32, 64, 100, 128, 136, 256, 257])
def test_kernels_take_rule(head_dim, dtype):
    # any head up to 256 in a 16-bit type or f32; flash_attention pads a
    # head that is not a multiple of 8 (100) for the kernels
    want = 0 < head_dim <= 256 and dtype != torch.float64
    assert tfa.kernels_take(head_dim, dtype) is want


def test_cpu_reference_shapes_are_not_counted():
    # CPU tensors take the kernels' plain versions whatever the head_dim,
    # and no launch is counted
    tfa.reset_launch_counts()
    q, k, v = (torch.tensor(x) for x in _inputs(9, s=64, d=32, n=3))
    got = tfa.flash_attention(q, k, v)
    want = tfa.reference_attention(q, k, v)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    assert [f.launches for f in tfa.KERNELS] == [0, 0, 0]


def test_cuda_request_without_a_card_raises(monkeypatch):
    from bagua_tpu_torch.device import resolve_device
    from bagua_tpu_torch.models.transformer import TransformerConfig, TransformerLM

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformerLM(TransformerConfig(vocab_size=16, d_model=64, n_heads=1,
                                        n_layers=1, d_ff=64, max_seq_len=8))
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    from bagua_tpu_torch.ops import _build

    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build.os, "access", lambda path, mode: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


JAX_DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5, 5e-5),
              "f16": (jnp.float16, torch.float16, 5e-3, 5e-3)}


@pytest.mark.parametrize("kind,d", [("f32", 100), ("f32", 256), ("f16", 64), ("f16", 100),
                                    ("f16", 256)])
def test_f16_and_wide_heads_match_jax(kind, d):
    # f16, head_dim 256 and a head of 100 (not a multiple of 8): the
    # forward and the gradients against JAX's kernels in interpret mode; the
    # f16 tolerances are of the largest magnitude
    jdt, tdt, tol, gtol = JAX_DTYPES[kind]
    q, k, v, g = _inputs(d + len(kind), s=128, d=d)
    jfn = lambda q, k, v: jfa.flash_attention(q, k, v, jdt, causal=True,
                                              interpret=True, force=True)
    want, vjp = jax.vjp(jfn, *(jnp.asarray(x, jdt) for x in (q, k, v)))
    want_grads = vjp(jnp.asarray(g, jdt))
    leaves = [torch.tensor(x).to(tdt).requires_grad_() for x in (q, k, v)]
    got = tfa.flash_attention(*leaves)
    (got.float() * torch.tensor(g).to(tdt).float()).sum().backward()
    assert got.dtype == tdt and got.shape == (1, 128, 2, d)
    for name, a, b, t in (("o", got.detach(), want, tol),
                          *((f"d{n}", x.grad, w, gtol)
                            for n, x, w in zip("qkv", leaves, want_grads))):
        b = np.asarray(jnp.asarray(b, jnp.float32))
        np.testing.assert_allclose(a.float().numpy(), b, rtol=0,
                                   atol=t * np.abs(b).max(), err_msg=name)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float16, 2e-3)])
def test_padding_keeps_the_real_heads_scale(monkeypatch, dtype, tol):
    # On the kernel path flash_attention pads a head of 100 to 104 zero
    # columns and passes 100 beside it: the scale stays 1/sqrt(100).  Sent
    # down that path on the CPU (the wrappers' plain versions take the
    # padded tensors and the head_dim), output and gradients equal the
    # unpadded plain result: f32 within 1e-5, f16 within 2e-3 of the largest
    # magnitude (the f32 sums before each rounding to f16 run in another
    # order: two f16 ulps); a scale of 1/sqrt(104) would move the logits by
    # 2%.
    q, k, v, g = (torch.tensor(x).to(dtype) for x in _inputs(13, s=96, d=100))
    grads = []
    for padded in (False, True):
        monkeypatch.setattr(tfa, "_kernel_path", lambda x: padded)
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out, lse = tfa.flash_attention_with_lse(*leaves, causal=True)
        ((out * g.float()).sum() + lse.sum()).backward()
        grads.append((out.detach(), lse.detach(), *(x.grad for x in leaves)))
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), *grads):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        err = ((a.float() - b.float()).abs().max() / a.float().abs().max()).item()
        assert err <= tol, (name, err)
