"""The port's serving plane against the JAX package's (``tests/test_serve.py``).

The same f32 weights (made by the JAX model from a seed, converted with
``models.convert.params_from_jax``) serve in both packages:

- JAX's ``ServeEngine`` and the port's, on one mixed trace with joins
  mid-batch, chunked prefill and preemption under an undersized pool, give
  equal greedy tokens for every request and preempt the same requests.
- The port's engine against the port's ``generate()``: over the same rows
  in lockstep (every slot at the same position each tick, the GEMMs of the
  same shapes) tokens and logits are bitwise equal; on the mixed trace,
  where a tick's ``max_slots`` rows, a chunk's ``prefill_chunk`` tokens and
  ``generate()``'s one row run products of different shapes, the tokens are
  equal and the logits within 1e-4 (f32 on the CPU).
- Backpressure and validation: queue depth, pool exhaustion, deferred
  arrivals, a pool too small for one request, bad submissions, static
  batching.  No flash kernel runs in a tick.
- The artifact round trip through the digest chain; a corrupted ``rank0.pt``
  of the newest step falls back to step 1 (``ckpt/fallback_restores`` + 1),
  an explicit step raises; an artifact of another model is refused.
- The serving ledger classes are fed and conserve.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bagua_tpu_torch as bt
from bagua_tpu.models.transformer import TransformerConfig as JConfig
from bagua_tpu.models.transformer import TransformerLM as JLM
from bagua_tpu.serve import ServeConfig as JServeConfig
from bagua_tpu.serve import ServeEngine as JServeEngine
from bagua_tpu_torch.checkpoint import CheckpointIntegrityError
from bagua_tpu_torch.models.convert import params_from_jax
from bagua_tpu_torch.models.generate import generate
from bagua_tpu_torch.obs import ledger as obs_ledger
from bagua_tpu_torch.obs import spans as obs_spans
from bagua_tpu_torch.serve import (PagePool, Request, ServeConfig, ServeEngine,
                                   ServeQueueFull, load_serving_params,
                                   save_serving_artifact)
from bagua_tpu_torch.telemetry import counters

torch.set_num_threads(1)

DIMS = dict(vocab_size=61, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq_len=32)
LOGIT_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def process_group():
    bt.init_process_group(device="cpu")


@pytest.fixture(scope="module")
def jax_params():
    model = JLM(JConfig(**DIMS, dtype=jnp.float32))
    probe = jax.random.randint(jax.random.PRNGKey(0), (1, 5), 0, 61)
    return model, model.init(jax.random.PRNGKey(1), probe)["params"]


def _port_model(jax_params):
    model = bt.TransformerLM(bt.TransformerConfig(**DIMS, dtype=torch.float32), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jax_params[1]), model))
    return model


@pytest.fixture()
def model(jax_params):
    return _port_model(jax_params)


def _cfg(**kw):
    base = dict(max_slots=3, page_size=4, num_pages=2 + 3 * 8, queue_depth=64,
                prefill_chunk=1, tick_idle_s=0.001)
    base.update(kw)
    return base


def _drain(engine, cap=5000):
    steps = done = 0
    while not engine.idle:
        done += engine.step()
        steps += 1
        assert steps < cap, "engine failed to drain"
    return done


def _ref(model, prompt, n, logits=False):
    out = generate(model, np.asarray(prompt)[None], n, return_logits=logits)
    if logits:
        return out[0][0].tolist(), out[1][0]
    return out[0].tolist()


def _mixed_trace(engine):
    """Requests of mixed lengths, a second wave joining mid-batch."""
    rng = np.random.RandomState(7)
    specs = [(rng.randint(0, 61, size=rng.randint(2, 14)), int(rng.randint(2, 12)))
             for _ in range(9)]
    reqs = [engine.submit(p, n) for p, n in specs[:5]]
    for _ in range(6):
        engine.step()
    reqs += [engine.submit(p, n) for p, n in specs[5:]]
    _drain(engine)
    return reqs, specs


def test_engine_matches_the_jax_engine(jax_params, model):
    kw = _cfg(max_slots=4, num_pages=2 + 10, prefill_chunk=4)
    jengine = JServeEngine(jax_params[0], jax_params[1], JServeConfig(**kw))
    engine = ServeEngine(model, None, ServeConfig(**kw))
    before = counters.get("serve/requests_preempted")
    jreqs, _ = _mixed_trace(jengine)
    reqs, _ = _mixed_trace(engine)
    assert counters.get("serve/requests_preempted") > before
    for a, b in zip(reqs, jreqs):
        assert a.output == list(b.output), a.rid
        assert a.preemptions == b.preemptions
    assert any(r.preemptions for r in reqs)
    assert engine.pool.pages_in_use == 0


def test_lockstep_rows_bitwise_equal_generate(model):
    """Three requests of one prompt length and budget, admitted together:
    each tick runs the rows generate() runs, at the same positions."""
    rng = np.random.RandomState(3)
    prompts = rng.randint(0, 61, size=(3, 5))
    engine = ServeEngine(model, None, ServeConfig(**_cfg()), record_logits=True)
    reqs = [engine.submit(p, 7) for p in prompts]
    _drain(engine)
    toks, logits = generate(model, prompts, 7, return_logits=True)
    for j, r in enumerate(reqs):
        assert r.output == toks[j].tolist()
        # logits of the steps that sampled the outputs (step i predicts i + 1)
        assert torch.equal(torch.stack(r.logits), logits[j, 4:])


def test_mixed_trace_against_generate(model):
    engine = ServeEngine(model, None, ServeConfig(**_cfg(max_slots=4, num_pages=2 + 10,
                                                         prefill_chunk=4)),
                         record_logits=True)
    reqs, specs = _mixed_trace(engine)
    assert any(r.preemptions for r in reqs)
    assert counters.get("serve/prefill_chunks") > 0
    for r, (prompt, n) in zip(reqs, specs):
        toks, logits = _ref(model, prompt, n, logits=True)
        assert r.output == toks
        got = torch.stack(r.logits)
        assert got.shape == (n, DIMS["vocab_size"])
        assert torch.allclose(got, logits[len(prompt) - 1:], atol=LOGIT_ATOL, rtol=0)


def test_no_flash_kernel_in_a_tick(model, monkeypatch):
    from bagua_tpu_torch.ops import flash_attention as fa

    monkeypatch.setattr(fa, "_flash_lse", lambda *a, **k: pytest.fail("flash in a tick"))
    engine = ServeEngine(model, None, ServeConfig(**_cfg(prefill_chunk=4)))
    engine.submit(np.arange(9), 4)
    _drain(engine)


def test_pool_exhaustion_backpressure(model):
    engine = ServeEngine(model, None, ServeConfig(**_cfg(max_slots=4, num_pages=2 + 10)))
    rng = np.random.RandomState(7)
    specs = [(rng.randint(0, 61, size=rng.randint(2, 12)), int(rng.randint(2, 14)))
             for _ in range(8)]
    before = counters.get("serve/pool_exhausted")
    reqs = [engine.submit(p, n) for p, n in specs]
    _drain(engine)
    for r, (p, n) in zip(reqs, specs):
        assert r.output == _ref(model, p, n)
    assert counters.get("serve/pool_exhausted") > before
    assert any(r.preemptions for r in reqs)
    assert engine.pool.pages_in_use == 0


def test_queue_depth_and_validation(model):
    engine = ServeEngine(model, None, ServeConfig(**_cfg(queue_depth=2)))
    engine.submit([1, 2], 2)
    engine.submit([3, 4], 2)
    with pytest.raises(ServeQueueFull):
        engine.submit([5, 6], 2)
    _drain(engine)
    with pytest.raises(ValueError, match="max_seq_len"):
        engine.submit(np.arange(10), DIMS["max_seq_len"])
    with pytest.raises(ValueError, match="at least one token"):
        engine.submit(np.array([], np.int32), 4)
    with pytest.raises(ValueError, match="max_new_tokens"):
        engine.submit(np.arange(3), 0)
    with pytest.raises(ValueError, match="full-length"):
        ServeEngine(model, None, ServeConfig(**_cfg(num_pages=4)))


def test_run_defers_arrivals_and_replays_a_trace(model):
    engine = ServeEngine(model, None, ServeConfig(**_cfg(max_slots=1, queue_depth=2)))
    trace = [(0.0, np.array([i + 1, i + 2]), 3) for i in range(6)]
    done = engine.run(trace)
    assert len(done) == 6
    for r, (_, p, n) in zip(sorted(done, key=lambda r: r.rid), trace):
        assert r.output == _ref(model, p, n)
        assert r.ttft_s is not None and r.ttft_s >= 0


def test_static_batching_holds_admissions(model):
    engine = ServeEngine(model, None, ServeConfig(**_cfg(max_slots=2)), continuous=False)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, 61, size=4) for _ in range(3)]
    reqs = [engine.submit(p, n) for p, n in zip(prompts, (2, 9, 3))]
    while reqs[1].t_done is None:
        engine.step()
        assert reqs[2].t_first_token is None
    _drain(engine)
    for r, p, n in zip(reqs, prompts, (2, 9, 3)):
        assert r.output == _ref(model, p, n)


def test_page_pool_alloc_free():
    pool = PagePool(6)
    pages = [pool.alloc() for _ in range(4)]
    assert None not in pages and len(set(pages)) == 4 and all(p >= 2 for p in pages)
    assert pool.alloc() is None
    pool.free(pages[:2])
    assert pool.free_pages == 2
    with pytest.raises(AssertionError, match="double free"):
        pool.free(pages[:1] + pages[:1])


def test_serving_artifact_round_trip(model, tmp_path):
    d = str(tmp_path / "artifact")
    save_serving_artifact(d, model, step=3)
    other = bt.TransformerLM(bt.TransformerConfig(**DIMS, dtype=torch.float32), device="cpu",
                             seed=9)
    before = counters.get("serve/weight_loads")
    step, loaded = load_serving_params(d, other)
    assert step == 3 and counters.get("serve/weight_loads") == before + 1
    for n, p in model.named_parameters():
        assert torch.equal(loaded[n], p), n
    engine = ServeEngine(other, loaded, ServeConfig(**_cfg()))
    r = engine.submit(np.array([5, 6, 7]), 5)
    _drain(engine)
    assert r.output == _ref(model, [5, 6, 7], 5)


def test_corrupt_rank0_falls_back_to_step_1(model, tmp_path):
    d = str(tmp_path / "artifact")
    save_serving_artifact(d, model, step=1)
    mutated = {n: p.detach() + 1.0 for n, p in model.named_parameters()}
    save_serving_artifact(d, mutated, step=2)
    path = os.path.join(d, "2", "rank0.pt")
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        f.write(b"\xff" * 64)
    before = counters.get("ckpt/fallback_restores")
    step, loaded = load_serving_params(d, model)
    assert step == 1
    assert counters.get("ckpt/fallback_restores") == before + 1
    for n, p in model.named_parameters():
        assert torch.equal(loaded[n], p), n
    with pytest.raises(CheckpointIntegrityError):
        load_serving_params(d, model, step=2)


def test_artifact_of_another_model_is_refused(model, tmp_path):
    d = str(tmp_path / "artifact")
    save_serving_artifact(d, model, step=0)
    other = bt.TransformerLM(bt.TransformerConfig(**{**DIMS, "d_model": 48},
                                                  dtype=torch.float32), device="cpu")
    with pytest.raises(ValueError, match="shapes|cover"):
        load_serving_params(d, other)


def test_serving_ledger_classes_and_spans(model):
    obs_spans.set_enabled(True)
    obs_spans.recorder.clear()
    obs_ledger.ledger.reset()
    try:
        engine = ServeEngine(model, None, ServeConfig(**_cfg(prefill_chunk=4)))
        # the engine waits for the first arrival: batch-formation idle
        engine.run([(0.05, np.arange(9), 6), (0.06, np.arange(3), 4)])
        rep = obs_ledger.ledger.report()
        assert rep["classes"]["prefill"] > 0 and rep["classes"]["decode"] > 0
        assert rep["classes"]["batch_formation_idle"] > 0
        assert sum(rep["classes"].values()) <= rep["wall_s"] * 1.01 + 1e-6
        names = {s["name"] for s in obs_spans.recorder.snapshot()}
        assert {"serve/admit", "serve/prefill", "serve/decode", "serve/detokenize"} <= names
    finally:
        obs_ledger.ledger.reset()
        obs_spans.recorder.clear()
        obs_spans.set_enabled(None)


def test_serve_config_from_env_and_request_fields(monkeypatch):
    monkeypatch.setenv("BAGUA_SERVE_MAX_SLOTS", "5")
    monkeypatch.setenv("BAGUA_SERVE_PAGE_SIZE", "8")
    monkeypatch.setenv("BAGUA_SERVE_QUEUE_DEPTH", "17")
    cfg = ServeConfig.from_env(max_seq_len=64)
    assert (cfg.max_slots, cfg.page_size, cfg.queue_depth) == (5, 8, 17)
    assert cfg.num_pages == 2 + 5 * (64 // 8)
    assert cfg == ServeConfig(**{k: getattr(cfg, k) for k in
                                 ("max_slots", "page_size", "num_pages", "queue_depth",
                                  "prefill_chunk", "tick_idle_s")})
    req = Request(rid=0, prompt=np.array([1]), max_new_tokens=3)
    assert req.ttft_s is None and req.tpot_s is None
    req.t_submit, req.t_first_token, req.t_done = 1.0, 1.5, 2.5
    req.output = [1, 2, 3]
    assert req.ttft_s == pytest.approx(0.5) and req.tpot_s == pytest.approx(0.5)
