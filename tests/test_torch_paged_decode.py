"""The port's paged decode against the JAX package's
(``bagua_tpu/models/transformer.py:220-293``, ``tests/test_serve.py:69``).

A decode config with ``page_size > 0`` keeps one page pool a layer; each
call carries ``slots`` (``block_table``, ``lengths``, ``active``).  On the
same f32 params, the same pools and the same slots:

- the pools after the writes equal JAX's (the written rows within 2e-5, the
  f32 projections' summation order; every other row bitwise);
- the outputs equal JAX's ``model.apply(..., slots=...)`` within 2e-5, one
  token a slot and a prefill chunk of 3;
- an inactive slot writes the trash page and nothing else;
- greedy ``generate`` of a paged twin (``decode_model(model, page_size=,
  num_pages=)``, as the card's ``generate`` phase runs it) is bitwise equal
  to the dense twin's, tokens and logits (the invariant
  tests/test_serve.py:69 pins for the JAX package); a pool too small for
  the budget is refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bagua_tpu_torch as bt
from bagua_tpu.models.generate import decode_model as jdecode_model
from bagua_tpu.models.transformer import TransformerConfig as JConfig
from bagua_tpu.models.transformer import TransformerLM as JLM
from bagua_tpu_torch.models.convert import cache_from_jax, params_from_jax
from bagua_tpu_torch.models.transformer import RESERVED_PAGES, TRASH_PAGE, ZERO_PAGE

torch.set_num_threads(1)

DIMS = dict(vocab_size=61, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq_len=24)
PAGE, SLOTS = 4, 3
PAGES_PER_SLOT = DIMS["max_seq_len"] // PAGE
NUM_PAGES = RESERVED_PAGES + SLOTS * PAGES_PER_SLOT
ATOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def process_group():
    bt.init_process_group(device="cpu")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _params():
    cfg = JConfig(**DIMS, dtype=jnp.float32)
    prompt = jax.random.randint(jax.random.PRNGKey(0), (2, 5), 0, 61)
    return JLM(cfg).init(jax.random.PRNGKey(1), prompt)["params"]


def _port(params, **cfg):
    model = bt.TransformerLM(bt.TransformerConfig(**DIMS, dtype=torch.float32, **cfg),
                             device="cpu")
    model.load_state_dict(params_from_jax(_np(params), model))
    return model


def _jpaged():
    return JLM(JConfig(**DIMS, dtype=jnp.float32, decode=True, page_size=PAGE,
                       num_pages=NUM_PAGES))


def _slots(lengths, active, allocated):
    """Slot ``j`` owns pages ``RESERVED + j * PAGES_PER_SLOT + p`` for its
    first ``allocated[j]`` logical pages; the rest point at the zero page."""
    table = np.full((SLOTS, PAGES_PER_SLOT), ZERO_PAGE, np.int32)
    for j, n in enumerate(allocated):
        table[j, :n] = RESERVED_PAGES + j * PAGES_PER_SLOT + np.arange(n)
    return {"block_table": np.asarray(table), "lengths": np.asarray(lengths, np.int32),
            "active": np.asarray(active)}


def _random_pools(seed):
    """A JAX cache collection whose pools hold seeded values (the zero page
    zero, as it is never written)."""
    model = jdecode_model(_jpaged())
    cache = _np(model.init(jax.random.PRNGKey(0), jnp.zeros((SLOTS, 1), jnp.int32))["cache"])
    rng = np.random.default_rng(seed)
    out = {}
    for blk, sub in cache.items():
        attn = {}
        for name, pool in sub["attn"].items():
            pool = rng.standard_normal(pool.shape).astype(np.float32)
            pool[ZERO_PAGE] = 0.0
            attn[name] = pool
        out[blk] = {"attn": attn}
    return out


def _both(tokens, slots, seed=0):
    """JAX's and the port's paged call on the same pools: outputs, the JAX
    pools after, the port's pools before and after."""
    params = _params()
    pools = _random_pools(seed)
    jl, mutated = _jpaged().apply({"params": params, "cache": jax.tree.map(jnp.asarray, pools)},
                                  jnp.asarray(tokens),
                                  slots={k: jnp.asarray(v) for k, v in slots.items()},
                                  mutable=["cache"])
    model = bt.decode_model(_port(params, page_size=PAGE, num_pages=NUM_PAGES))
    cache = cache_from_jax(pools, model)
    before = [t.clone() for t in cache.keys + cache.values]
    with torch.no_grad():
        out = model(torch.tensor(tokens).long(), cache=cache,
                    slots={k: torch.tensor(v) for k, v in slots.items()})
    want = cache_from_jax(_np(mutated["cache"]), model)
    return (out.numpy(), np.asarray(jl), before, cache.keys + cache.values,
            want.keys + want.values)


@pytest.mark.parametrize("s", [1, 3])
def test_pool_writes_and_outputs_match_jax(s):
    tokens = np.random.default_rng(1).integers(0, 61, (SLOTS, s))
    slots = _slots(lengths=[0, 5, 11], active=[True, True, True], allocated=[1, 2, 4])
    got, want, _, pools, jpools = _both(tokens, slots)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    for p, jp in zip(pools, jpools):
        np.testing.assert_allclose(p.numpy(), jp.numpy(), rtol=0, atol=ATOL)


def test_inactive_slot_writes_only_the_trash_page():
    tokens = np.random.default_rng(2).integers(0, 61, (SLOTS, 1))
    slots = _slots(lengths=[2, 5, 9], active=[True, False, True], allocated=[1, 2, 3])
    got, want, before, pools, jpools = _both(tokens, slots, seed=3)
    np.testing.assert_allclose(got[[0, 2]], want[[0, 2]], rtol=0, atol=ATOL)
    written = {(int(slots["block_table"][j, pos // PAGE]), pos % PAGE)
               for j, pos in ((0, 2), (2, 9))}
    for b, p, jp in zip(before, pools, jpools):
        np.testing.assert_allclose(p.numpy(), jp.numpy(), rtol=0, atol=ATOL)
        changed = {(int(pg), int(off)) for pg, off in
                   zip(*np.nonzero((b != p).reshape(NUM_PAGES, PAGE, -1).any(-1).numpy()))}
        assert changed - written == {(TRASH_PAGE, 5 % PAGE)}, changed
        # the inactive slot's own pages are untouched
        for page in slots["block_table"][1, :2]:
            assert torch.equal(b[page], p[page])


def test_paged_greedy_is_bitwise_dense():
    params = _params()
    dense = _port(params)
    prompt = torch.tensor(np.random.default_rng(4).integers(0, 61, (SLOTS, 5))).long()
    n = DIMS["max_seq_len"] - 5
    want, want_logits = bt.generate(dense, prompt, n, return_logits=True)
    paged = bt.decode_model(dense, page_size=PAGE, num_pages=NUM_PAGES)
    assert paged.embed is dense.embed
    got, logits = bt.generate(paged, prompt, n, return_logits=True)
    assert torch.equal(got, want)
    assert torch.equal(logits, want_logits)
    small = bt.decode_model(dense, page_size=PAGE, num_pages=NUM_PAGES - 1)
    with pytest.raises(ValueError, match="num_pages"):
        bt.generate(small, prompt, n)


def test_paged_errors_match_jax():
    params = _params()
    model = _port(params)
    tokens = torch.zeros((SLOTS, 1), dtype=torch.long)
    slots = {k: torch.tensor(v) for k, v in _slots([0] * 3, [True] * 3, [1] * 3).items()}
    with pytest.raises(ValueError, match="only meaningful for paged decode"):
        model(tokens, slots=slots)
    with pytest.raises(ValueError, match="only meaningful for paged decode"):
        JLM(JConfig(**DIMS, dtype=jnp.float32)).apply({"params": params}, jnp.asarray(tokens),
                                                      slots=slots)
    paged = bt.decode_model(_port(params, page_size=PAGE, num_pages=NUM_PAGES))
    with pytest.raises(ValueError, match="needs the `slots`"):
        paged(tokens, cache=paged.init_cache(SLOTS))
    bad = bt.decode_model(_port(params, page_size=5, num_pages=NUM_PAGES))
    with pytest.raises(ValueError, match="does not divide"):
        bad.init_cache(SLOTS)
    few = bt.decode_model(_port(params, page_size=PAGE, num_pages=RESERVED_PAGES))
    with pytest.raises(ValueError, match="reserved"):
        few.init_cache(SLOTS)
