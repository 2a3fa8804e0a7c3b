"""The port's KV-cache generation against the JAX package's
(tests/test_generate.py, case for case).

The same f32 params (flax's, carried over with ``models.convert``) and the
same prompts go through ``bagua_tpu.models.generate`` and
``bagua_tpu_torch.models.generate``:

- greedy tokens equal JAX's (and the full-forward argmax chain), and the
  decode logits of every step within 2e-5 of JAX's decode-mode logits;
- prompt length 1 and the whole budget;
- temperature draws: the same generator state gives the same tokens (a
  torch draw cannot reproduce ``jax.random``'s, so it is held to
  determinism, as the JAX test holds its key);
- the validations, in JAX's words;
- ``decode_model`` shares the parameters, its one-token logits equal the
  training forward's within JAX's 1e-5, and its cache after the step equals
  JAX's ``"cache"`` collection (``convert.cache_from_jax``);
- ``generate_tp`` at tp 2 and tp 4 over gloo ranks (one spawn of 4 ranks of
  ``tests/workers/torch_tensor_pipeline_worker.py``): the dense greedy
  tokens, the same logits and tokens on every rank, logits within 2e-5 of
  JAX's dense decode.

The JAX package's compiled-program caches (``_GEN_CACHE``, ``_TP_GEN_CACHE``
and their tests) have no counterpart: eager torch compiles nothing to keep.
"""

import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bagua_tpu_torch as bt
from bagua_tpu.models.generate import decode_model as jdecode_model
from bagua_tpu.models.generate import generate as jgenerate
from bagua_tpu.models.transformer import TransformerConfig as JConfig
from bagua_tpu.models.transformer import TransformerLM as JLM
from bagua_tpu.models.transformer import tp_param_dim as jtp_param_dim
from bagua_tpu.parallel.tensor_parallel import globalize_tp_params as jglobalize_tp
from bagua_tpu_torch.models.convert import cache_from_jax, params_from_jax, params_to_jax

sys.path.insert(0, str(Path(__file__).resolve().parent / "workers"))
import torch_tensor_pipeline_worker as worker  # noqa: E402

torch.set_num_threads(1)

DIMS = dict(vocab_size=61, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq_len=24)
CFG = JConfig(**DIMS, dtype=jnp.float32)
#: decode logits against JAX's (f32, summation order)
LOGITS_ATOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def process_group():
    bt.init_process_group(device="cpu")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _model_and_params(key=0):
    """tests/test_generate.py's model, params and prompt."""
    model = JLM(CFG)
    prompt = jax.random.randint(jax.random.PRNGKey(key), (2, 5), 0, 61)
    params = model.init(jax.random.PRNGKey(key + 1), prompt)["params"]
    return model, params, prompt


def _port(params, **cfg):
    model = bt.TransformerLM(bt.TransformerConfig(**DIMS, dtype=torch.float32, **cfg),
                             device="cpu")
    model.load_state_dict(params_from_jax(_np(params), model))
    return model


def _jax_decode_logits(model, params, fed):
    """JAX's decode-mode logits of each token of ``fed`` ``[b, n]`` in turn
    (the flax cache collection carried by hand)."""
    dm = jdecode_model(model)
    cache = dm.init(jax.random.PRNGKey(0), jnp.zeros((fed.shape[0], 1), jnp.int32))["cache"]
    out = []
    for i in range(fed.shape[1]):
        logits, mutated = dm.apply({"params": params, "cache": cache}, jnp.asarray(fed[:, i:i + 1]),
                                   mutable=["cache"])
        cache = mutated["cache"]
        out.append(np.asarray(logits[:, 0]))
    return np.stack(out, axis=1)


def _greedy_reference(model, prompt, n):
    """The port's full-forward argmax continuation (no cache)."""
    seq = torch.tensor(np.asarray(prompt)).long()
    with torch.no_grad():
        for _ in range(n):
            seq = torch.cat([seq, model(seq)[:, -1].argmax(-1)[:, None]], dim=1)
    return seq[:, prompt.shape[1]:].numpy()


def test_greedy_matches_jax():
    jm, params, prompt = _model_and_params()
    n = 8
    want = np.asarray(jgenerate(jm, params, prompt, n))
    model = _port(params)
    got, logits = bt.generate(model, np.asarray(prompt), n, return_logits=True)
    assert got.shape == (2, n) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), _greedy_reference(model, prompt, n))
    fed = np.concatenate([np.asarray(prompt), want[:, :-1]], axis=1)
    np.testing.assert_allclose(logits.numpy(), _jax_decode_logits(jm, params, fed),
                               rtol=0, atol=LOGITS_ATOL)


def test_prompt_len_one_and_full_budget():
    jm, params, _ = _model_and_params(key=4)
    prompt = jax.random.randint(jax.random.PRNGKey(9), (3, 1), 0, 61)
    n = CFG.max_seq_len - 1
    want = np.asarray(jgenerate(jm, params, prompt, n))
    model = _port(params)
    got = bt.generate(model, np.asarray(prompt), n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), _greedy_reference(model, prompt, n))


def test_temperature_sampling_is_deterministic_per_generator():
    _, params, prompt = _model_and_params(key=2)
    model = _port(params)
    draw = lambda seed: bt.generate(model, np.asarray(prompt), 6, temperature=0.8,
                                    generator=torch.Generator().manual_seed(seed)).numpy()
    a, b, c = draw(3), draw(3), draw(4)
    np.testing.assert_array_equal(a, b)
    assert (a != c).any()
    assert ((a >= 0) & (a < CFG.vocab_size)).all()


def test_budget_validation():
    jm, params, prompt = _model_and_params(key=6)
    model = _port(params)
    for call in (lambda: jgenerate(jm, params, prompt, CFG.max_seq_len),
                 lambda: bt.generate(model, np.asarray(prompt), CFG.max_seq_len)):
        with pytest.raises(ValueError, match="max_seq_len"):
            call()
    for call in (lambda: jgenerate(jm, params, prompt, 2, temperature=1.0),
                 lambda: bt.generate(model, np.asarray(prompt), 2, temperature=1.0)):
        with pytest.raises(ValueError, match="rng"):
            call()
    # a paged twin whose pool cannot hold the rows' pages
    paged = bt.decode_model(model, page_size=4, num_pages=3)
    with pytest.raises(ValueError, match="num_pages 3"):
        bt.generate(paged, np.asarray(prompt), 2)


def test_decode_model_shares_params():
    """Training-mode params apply unchanged in decode mode; the cache after
    one step is JAX's."""
    jm, params, prompt = _model_and_params(key=8)
    model = _port(params)
    dm = bt.decode_model(model)
    assert dm.cfg.decode and not model.cfg.decode
    assert all(a is b for a, b in zip(dm.parameters(), model.parameters()))
    # decode adds no parameter: the converters take its params unchanged
    for name, t in params_from_jax(_np(params), dm).items():
        torch.testing.assert_close(t, dict(model.named_parameters())[name].detach(),
                                   rtol=0, atol=0)
    back = params_to_jax(dict(dm.named_parameters()), _np(params))
    for (path, a), (_, w) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                                 jax.tree_util.tree_flatten_with_path(_np(params))[0]):
        np.testing.assert_array_equal(a, w, err_msg=jax.tree_util.keystr(path))
    cache = dm.init_cache(2)
    tok = torch.tensor(np.asarray(prompt[:, :1])).long()
    with torch.no_grad():
        logits = dm(tok, cache=cache)
        full = model(tok)
    np.testing.assert_allclose(logits.numpy(), full.numpy(), atol=1e-5)
    jdm = jdecode_model(jm)
    jcache = jdm.init(jax.random.PRNGKey(0), prompt[:, :1])["cache"]
    jlogits, mutated = jdm.apply({"params": params, "cache": jcache}, prompt[:, :1],
                                 mutable=["cache"])
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=LOGITS_ATOL)
    want = cache_from_jax(_np(mutated["cache"]), dm)
    assert want.index == cache.index == 1
    for got_t, want_t in zip(cache.keys + cache.values, want.keys + want.values):
        np.testing.assert_allclose(got_t.numpy(), want_t.numpy(), rtol=0, atol=LOGITS_ATOL)
    with pytest.raises(ValueError, match="decode"):
        model(tok, cache=cache)
    with pytest.raises(ValueError, match="decode"):
        model.init_cache(2)


# ---------------------------------------------------------------------------
# generate_tp over gloo ranks
# ---------------------------------------------------------------------------

TP_CASES = {"tp2": {"rep": 2, "tp": 2}, "tp4": {"tp": 4}}


def _tp_params(tp):
    """tests/test_generate.py:103's: a tp model's init, redrawn global."""
    cfg_tp = dataclasses.replace(CFG, tp_axis="tp", tp_size=tp)
    prompt = jax.random.randint(jax.random.PRNGKey(11), (2, 5), 0, 61)
    params = jglobalize_tp(JLM(cfg_tp).init(jax.random.PRNGKey(12), prompt)["params"],
                           jax.random.PRNGKey(13), tp, jtp_param_dim)
    return params, prompt


_TP_RUNS = {}


def _tp_runs(tmp_path_factory):
    if not _TP_RUNS:
        data = {}
        for case, mesh in TP_CASES.items():
            params, prompt = _tp_params(mesh["tp"])
            for name, extra in (("", {}), ("_temp", {"temperature": 0.7, "seed": 5})):
                spec = {"kind": "generate", "model": "lm", "cfg": DIMS, "mesh": mesh, "n": 8,
                        **extra}
                data[f"{case}{name}/spec"] = np.array(json.dumps(spec))
                data[f"{case}{name}/tokens"] = np.asarray(prompt)
                data.update({f"{case}{name}/params/{k}": v
                             for k, v in _flat(_np(params)).items()})
        cases = [c for c in TP_CASES] + [f"{c}_temp" for c in TP_CASES]
        _TP_RUNS["outs"] = worker.spawn(4, cases, data, tmp_path_factory.mktemp("gen_tp"))
    return _TP_RUNS["outs"]


@pytest.mark.parametrize("case", list(TP_CASES))
def test_tp_generation_matches_dense(case, tmp_path_factory):
    """Tensor-parallel decode gives the exact greedy continuation of the
    dense model on the same global params, the same on every rank."""
    outs = _tp_runs(tmp_path_factory)
    params, prompt = _tp_params(TP_CASES[case]["tp"])
    dense = JLM(CFG)
    want = np.asarray(jgenerate(dense, params, prompt, 8))
    port_dense = bt.generate(_port(params), np.asarray(prompt), 8).numpy()
    np.testing.assert_array_equal(port_dense, want)
    fed = np.concatenate([np.asarray(prompt), want[:, :-1]], axis=1)
    jlogits = _jax_decode_logits(dense, params, fed)
    for o in outs:
        np.testing.assert_array_equal(o[f"{case}/tokens0"], want)
        np.testing.assert_array_equal(o[f"{case}/logits0"], outs[0][f"{case}/logits0"])
        np.testing.assert_allclose(o[f"{case}/logits0"], jlogits, rtol=0, atol=LOGITS_ATOL)
        # temperature draws: the same generator state, the same tokens, on
        # every rank
        np.testing.assert_array_equal(o[f"{case}_temp/tokens0"], o[f"{case}_temp/tokens1"])
        np.testing.assert_array_equal(o[f"{case}_temp/tokens0"],
                                      outs[0][f"{case}_temp/tokens0"])


def test_tp_generation_validation():
    _, params, prompt = _model_and_params(key=14)
    model = _port(params)
    mesh = bt.parallel.mesh.Mesh({"tp": 2}, 0)
    with pytest.raises(ValueError, match="tp_axis"):
        bt.generate_tp(model, model.state_dict(), np.asarray(prompt), 4, mesh)  # no tp in cfg
    tp_model = bt.TransformerLM(bt.TransformerConfig(**DIMS, dtype=torch.float32, tp_axis="tp",
                                                     tp_size=4), device="cpu")
    with pytest.raises(ValueError, match="tp_size=4"):
        bt.generate_tp(tp_model, model.state_dict(), np.asarray(prompt), 4, mesh)
