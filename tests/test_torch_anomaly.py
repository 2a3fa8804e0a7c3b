"""The port's step-time anomaly detector against the JAX package's
(``tests/test_anomaly.py``).

The same seeded step-time series (numpy, with phases) into both detectors
gives the same suspects: every field but the wall-clock stamp
``detected_at_unix``, exactly (both run the same float arithmetic on the
same inputs).  The perf hints queued and the fleet's straggler naming agree
as well; the trainer feeds its detector from the step cadence, skipping the
build window.
"""

import functools

import numpy as np
import pytest
import torch

import bagua_tpu_torch as bt
from bagua_tpu.obs import anomaly as jan
from bagua_tpu.obs import export as jexport
from bagua_tpu_torch.models.transformer import lm_loss_fn
from bagua_tpu_torch.obs import anomaly as an
from bagua_tpu_torch.obs import export as obs_export

torch.set_num_threads(1)


@pytest.fixture()
def clean():
    for mod, exp in ((an, obs_export), (jan, jexport)):
        exp.reset_local_summary()
        mod.drain_perf_hints()
    yield
    for mod, exp in ((an, obs_export), (jan, jexport)):
        exp.reset_local_summary()
        mod.drain_perf_hints()


def _series(seed=0, n=200):
    """A steady 10 ms cadence with jitter, a straggle episode (collective
    waits), a slow-host spike (dispatch) and a late slow window."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        dispatch = 0.009 + rng.normal(0, 0.0002)
        collective = abs(rng.normal(0, 0.0001))
        if 60 <= i < 66:
            collective += 0.09
        if i == 100:
            dispatch += 0.05
        if i in (150, 151, 170):
            dispatch += 0.2
        other = 0.001 + abs(rng.normal(0, 0.0001))
        phases = {"dispatch": float(dispatch), "collective": float(collective)}
        if i % 7 == 0:
            phases["optimizer"] = 0.0005
        out.append((i, float(dispatch + collective + other + phases.get("optimizer", 0.0)),
                    phases))
    return out


def _run(mod, series):
    d = mod.StepAnomalyDetector(window=32, warmup=8, threshold=5.0, rank=0,
                                dump_min_interval_s=1e9)
    flagged = []
    for step, dt, phases in series:
        s = d.observe(step, dt, phases)
        if s is not None:
            flagged.append({k: v for k, v in s.items() if k != "detected_at_unix"})
    return flagged, mod.drain_perf_hints()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_series_same_suspects(clean, seed):
    series = _series(seed)
    port, port_hints = _run(an, series)
    jax_side, jax_hints = _run(jan, series)
    assert port == jax_side
    assert port_hints == jax_hints
    steps = [s["step"] for s in port]
    assert {60, 100, 150, 170} <= set(steps)
    by_step = {s["step"]: s for s in port}
    assert by_step[60]["dominant_phase"] == "collective"
    assert by_step[100]["dominant_phase"] == "dispatch"


def test_warmup_and_zero_mad_guard(clean):
    for mod in (an, jan):
        d = mod.StepAnomalyDetector(window=32, warmup=6, threshold=5.0, rank=0)
        for i in range(5):
            assert d.observe(i, 5.0 if i == 2 else 0.01) is None
        steady = mod.StepAnomalyDetector(window=32, warmup=6, threshold=5.0, rank=0)
        for i in range(20):
            steady.observe(i, 0.01)
        # microsecond jitter over a perfectly steady cadence is no anomaly
        assert steady.observe(20, 0.0101) is None


def test_fleet_straggler_naming_matches(clean):
    def suspect(rank, phase, ratio):
        return {"rank": rank, "dominant_phase": phase, "ratio": ratio}

    fleet = {"ranks": {
        "0": {"obs": {"0": {"straggler_suspect": suspect(0, "collective", 3.0)}}},
        "1": {"obs": {"1": {"straggler_suspect": suspect(1, "dispatch", 9.0)},
                      "2": {"straggler_suspect": suspect(2, "other", 4.0)}}},
        "2": {"obs": {"3": {"step": 5}}},
    }}
    port = an.fleet_straggler_suspects(fleet)
    assert port == jan.fleet_straggler_suspects(fleet)
    assert [s["rank"] for s in port["stragglers"]] == [1, 2]
    assert [s["rank"] for s in port["victims"]] == [0]


def test_suspect_rides_the_obs_summary(clean):
    d = an.StepAnomalyDetector(window=32, warmup=6, threshold=5.0, rank=0,
                               dump_min_interval_s=1e9)
    obs_export.note_step(1, 0.01)
    for i in range(10):
        d.observe(i, 0.01, {"dispatch": 0.009})
    s = d.observe(10, 0.2, {"dispatch": 0.19})
    assert obs_export.local_obs_summary()["straggler_suspect"] == s
    assert an.peek_perf_hints()[-1]["kind"] == "step_time_anomaly"


def test_trainer_observes_the_cadence_and_skips_the_build(clean, monkeypatch):
    """Every step window but the build's reaches the detector, with the
    step's dispatch phase."""
    from bagua_tpu_torch.obs import spans as obs_spans

    bt.init_process_group(device="cpu")
    obs_spans.set_enabled(True)
    try:
        seen = []
        orig = an.StepAnomalyDetector.observe

        def spy(self, step, raw_dt, phases=None):
            seen.append((step, dict(phases or {})))
            return orig(self, step, raw_dt, phases)

        monkeypatch.setattr(an.StepAnomalyDetector, "observe", spy)
        cfg = bt.TransformerConfig(vocab_size=61, d_model=32, n_heads=4, n_layers=1, d_ff=64,
                                   max_seq_len=16, dtype=torch.float32)
        trainer = bt.BaguaTrainer(lm_loss_fn, functools.partial(torch.optim.SGD, lr=0.1),
                                  bt.algorithms.GradientAllReduceAlgorithm(), device="cpu")
        assert trainer.anomaly_detector is not None
        state = trainer.init(bt.TransformerLM(cfg, device="cpu", seed=0))
        batch = {"tokens": torch.randint(0, 61, (2, 9), generator=torch.Generator().manual_seed(0))}
        for _ in range(5):
            state, _ = trainer.train_step(state, batch)
        # windows close at steps 2..5: the first (the build's) is skipped
        assert [s for s, _ in seen] == [2, 3, 4]
        assert all(p.get("dispatch", 0) > 0 for _, p in seen)
    finally:
        obs_spans.set_enabled(None)


def test_anomaly_off_knob(monkeypatch):
    monkeypatch.setenv("BAGUA_OBS_ANOMALY", "off")
    bt.init_process_group(device="cpu")
    trainer = bt.BaguaTrainer(lm_loss_fn, functools.partial(torch.optim.SGD, lr=0.1),
                              bt.algorithms.GradientAllReduceAlgorithm(), device="cpu")
    assert trainer.anomaly_detector is None
