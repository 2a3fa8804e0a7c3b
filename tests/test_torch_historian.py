"""The port's fleet telemetry historian (``bagua_tpu_torch/obs/historian.py``).

Mirrors ``tests/test_historian.py`` case for case (bounded per-(rank,
metric) rings, windowed rate/percentile/least-squares-slope queries, the
derived trend gauges published back into the snapshot, deterministic
ingestion, restart-store persistence), and adds parity with the JAX
package: one record stream (healthy, degrading HBM headroom, a sustained
DCN share, a stalled series that ages out) ingested by both packages'
``Historian``, whose trend summaries, annotated records, ``history_report``
and persisted JSON must be equal.
"""

import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bagua_tpu_torch.obs.historian import (  # noqa: E402
    FLEET_RANK,
    MIN_TREND_SAMPLES,
    STORE_KEY,
    Historian,
    least_squares_slope,
)

NOW = 1_754_000_000.0


def _snapshot(t, rank=1, node=2, **fields):
    obs = {"rank": rank, "step": 100, "goodput_fraction": 0.9}
    obs.update(fields)
    return {
        "schema": "bagua-obs-fleet-v1", "time_unix": t, "epoch": 0,
        "nnodes": 1,
        "ranks": {str(node): {"health": {}, "obs": {str(rank): obs}}},
        "efficiency": {"ranks": {}, "goodput_fraction_min": 0.9,
                       "goodput_fraction_mean": 0.9},
    }


# ---- math primitives -------------------------------------------------------


def test_least_squares_slope_exact_line():
    samples = [(NOW + i, 5.0 - 2.0 * i) for i in range(8)]
    assert least_squares_slope(samples) == pytest.approx(-2.0)


def test_least_squares_slope_guards():
    # under the minimum sample count: no slope (2 points fit any line)
    assert least_squares_slope([(NOW, 1.0), (NOW + 1, 2.0)]) is None
    # degenerate time spread: undefined
    same_t = [(NOW, float(v)) for v in range(MIN_TREND_SAMPLES)]
    assert least_squares_slope(same_t) is None


# ---- rings + windowed queries ---------------------------------------------


def test_ring_capacity_bounds_series():
    h = Historian(capacity=4, window_s=1e9)
    for i in range(10):
        h.ingest(_snapshot(NOW + i, step=i))
    samples = h.window(1, "step")
    assert len(samples) == 4
    assert [v for _, v in samples] == [6.0, 7.0, 8.0, 9.0]


def test_duplicate_or_older_time_is_not_new_evidence():
    """The policy core's duplicate-snapshot guard, mirrored: a re-read
    (same or older time_unix) must not bend any slope."""
    h = Historian(capacity=16, window_s=1e9)
    h.ingest(_snapshot(NOW, step=1))
    h.ingest(_snapshot(NOW + 1, step=2))
    h.ingest(_snapshot(NOW + 1, step=99))   # duplicate
    h.ingest(_snapshot(NOW - 5, step=77))   # older
    assert [v for _, v in h.window(1, "step")] == [1.0, 2.0]


def test_window_anchors_on_newest_sample_not_wall_clock():
    """Replays of recorded streams must see the same windows regardless
    of when they run: the trailing window hangs off the series' newest
    sample."""
    h = Historian(capacity=64, window_s=3.0)
    for i in range(10):
        h.ingest(_snapshot(NOW + i, step=i))
    samples = h.window(1, "step")
    assert [v for _, v in samples] == [6.0, 7.0, 8.0, 9.0]


def test_rate_percentile_mean_queries():
    h = Historian(capacity=64, window_s=1e9)
    for i in range(6):
        h.ingest(_snapshot(NOW + i, step=100 + 2 * i, step_dt_p50=0.1 * (i + 1)))
    assert h.rate(1, "step") == pytest.approx(2.0)  # 2 steps/second
    assert h.percentile(1, "step_dt_p50", 0.5) == pytest.approx(0.3)
    assert h.mean(1, "step_dt_p50") == pytest.approx(0.35)
    assert h.latest(1, "step") == 110.0
    # unknown series: None everywhere, empty window
    assert h.rate(1, "nope") is None
    assert h.percentile(9, "step", 0.5) is None
    assert h.window(1, "nope") == []


def test_non_numeric_and_bool_fields_skipped():
    h = Historian(capacity=16, window_s=1e9)
    h.ingest(_snapshot(NOW, worst_badput_class="compile", healthy=True,
                       badput={"compile": 1.0}))
    metrics = {m for _, m in h.metrics()}
    assert "worst_badput_class" not in metrics
    assert "healthy" not in metrics
    assert "badput" not in metrics
    assert "goodput_fraction" in metrics


def test_fleet_efficiency_aggregates_ride_pseudo_rank():
    h = Historian(capacity=16, window_s=1e9)
    for i in range(4):
        h.ingest(_snapshot(NOW + i))
    assert h.latest(FLEET_RANK, "goodput_fraction_min") == 0.9


# ---- derived trends --------------------------------------------------------


def test_trends_absent_until_min_samples():
    h = Historian(capacity=64, window_s=1e9)
    rec = None
    for i in range(MIN_TREND_SAMPLES - 1):
        rec = h.ingest(_snapshot(NOW + i, hbm_headroom_bytes=1e9 - i * 1e8))
    assert "trends" not in rec["ranks"]["2"]["obs"]["1"]
    rec = h.ingest(_snapshot(NOW + MIN_TREND_SAMPLES - 1,
                             hbm_headroom_bytes=1e9 - 3e8))
    trends = rec["ranks"]["2"]["obs"]["1"]["trends"]
    assert trends["hbm_headroom_slope"] == pytest.approx(-1e8)


def test_shrinking_headroom_projects_exhaustion_eta():
    h = Historian(capacity=64, window_s=1e9)
    rec = None
    for i in range(6):
        rec = h.ingest(_snapshot(NOW + i, hbm_headroom_bytes=4e9 - i * 2e8))
    trends = rec["ranks"]["2"]["obs"]["1"]["trends"]
    assert trends["hbm_headroom_slope"] == pytest.approx(-2e8)
    # latest headroom 3e9 at -2e8 B/s -> exhaustion ~15 s out
    assert trends["hbm_headroom_eta_s"] == pytest.approx(15.0)
    # growing headroom: slope positive, no eta
    h2 = Historian(capacity=64, window_s=1e9)
    for i in range(6):
        rec = h2.ingest(_snapshot(NOW + i, hbm_headroom_bytes=1e9 + i * 1e8))
    trends = rec["ranks"]["2"]["obs"]["1"]["trends"]
    assert trends["hbm_headroom_slope"] > 0
    assert "hbm_headroom_eta_s" not in trends


def test_dcn_comm_share_over_step_wall_and_comm_fallback():
    h = Historian(capacity=64, window_s=1e9)
    rec = None
    for i in range(5):
        rec = h.ingest(_snapshot(NOW + i, step_dt_p50=0.1,
                                 device_comm_dcn_s_per_step=0.06,
                                 device_comm_ici_s_per_step=0.01))
    assert rec["ranks"]["2"]["obs"]["1"]["trends"]["dcn_comm_share"] == \
        pytest.approx(0.6)
    # no step cadence on the summary: fall back to the share of total comm
    h2 = Historian(capacity=64, window_s=1e9)
    for i in range(5):
        snap = _snapshot(NOW + i, device_comm_dcn_s_per_step=0.03,
                         device_comm_ici_s_per_step=0.01)
        del snap["ranks"]["2"]["obs"]["1"]["goodput_fraction"]
        rec = h2.ingest(snap)
    assert rec["ranks"]["2"]["obs"]["1"]["trends"]["dcn_comm_share"] == \
        pytest.approx(0.75)


def test_fleet_worst_trends_and_gauges_published():
    from bagua_tpu_torch.telemetry import counters

    h = Historian(capacity=64, window_s=1e9)
    rec = None
    for i in range(6):
        snap = _snapshot(NOW + i, hbm_headroom_bytes=4e9 - i * 2e8,
                         step_dt_p50=0.1, device_comm_dcn_s_per_step=0.07,
                         device_comm_ici_s_per_step=0.01)
        # a second, healthier rank on another node
        snap["ranks"]["3"] = {"health": {}, "obs": {"3": {
            "rank": 3, "step": 100, "goodput_fraction": 0.9,
            "hbm_headroom_bytes": 8e9, "step_dt_p50": 0.1,
            "device_comm_dcn_s_per_step": 0.01,
            "device_comm_ici_s_per_step": 0.01}}}
        rec = h.ingest(snap)
    fleet = rec["trends"]
    assert fleet["hbm_headroom_slope_worst"] == pytest.approx(-2e8)
    assert fleet["dcn_comm_share_worst"] == pytest.approx(0.7)
    assert counters.get("obs/hbm_headroom_slope") == pytest.approx(-2e8)
    assert counters.get("obs/dcn_comm_share") == pytest.approx(0.7)


def test_history_report_shape():
    h = Historian(capacity=64, window_s=600.0)
    for i in range(6):
        h.ingest(_snapshot(NOW + i, hbm_headroom_bytes=4e9 - i * 2e8))
    report = h.history_report("hbm_headroom_bytes")
    assert report["metric"] == "hbm_headroom_bytes"
    assert report["window_s"] == 600.0
    entry = report["ranks"]["1"]
    assert len(entry["samples"]) == 6
    assert entry["latest"] == pytest.approx(3e9)
    assert entry["slope_per_s"] == pytest.approx(-2e8)
    assert entry["rate_per_s"] == pytest.approx(-2e8)
    assert entry["p50"] <= entry["p90"]
    # rank filter + unknown metric
    assert h.history_report("hbm_headroom_bytes", rank=1)["ranks"]
    assert h.history_report("nope")["ranks"] == {}


def test_stale_series_ages_out_of_trend_window():
    """A series that STOPPED updating (dead memory poll) must not keep
    republishing its final slope: trend windows anchor on the last
    ingest time, so once the dead series' samples age beyond the window
    the trend — and the autopilot evidence it feeds — disappears."""
    h = Historian(capacity=256, window_s=10.0)
    for i in range(6):
        rec = h.ingest(_snapshot(NOW + i, hbm_headroom_bytes=4e9 - i * 2e8))
    assert "hbm_headroom_slope" in rec["ranks"]["2"]["obs"]["1"]["trends"]
    # the headroom field vanishes from later summaries; other metrics
    # keep flowing, moving the ingest clock past the window
    for i in range(6, 30):
        rec = h.ingest(_snapshot(NOW + i))
    trends = rec["ranks"]["2"]["obs"]["1"].get("trends") or {}
    assert "hbm_headroom_slope" not in trends
    assert "hbm_headroom_eta_s" not in trends
    # the raw series is still queryable in its own (series-anchored)
    # /history window — only the TREND evidence expires
    assert h.slope(1, "hbm_headroom_bytes") is not None


# ---- restart persistence ---------------------------------------------------


def test_persistence_round_trip_through_store():
    from bagua_tpu_torch.contrib.utils.store import InMemoryStore

    store = InMemoryStore()
    h = Historian(capacity=16, window_s=600.0, store=store, persist_every=1)
    for i in range(5):
        h.ingest(_snapshot(NOW + i, hbm_headroom_bytes=4e9 - i * 2e8))
    # a relaunched coordinator resumes the rings (and the dedup watermark)
    h2 = Historian(capacity=16, window_s=600.0, store=store)
    assert h2.latest(1, "hbm_headroom_bytes") == pytest.approx(4e9 - 4 * 2e8)
    assert h2.slope(1, "hbm_headroom_bytes") == pytest.approx(-2e8)
    h2.ingest(_snapshot(NOW + 2, step=999))  # pre-crash duplicate: ignored
    assert h2.latest(1, "step") == 100.0


def test_persist_throttling_and_corrupt_state():
    from bagua_tpu_torch.contrib.utils.store import InMemoryStore

    store = InMemoryStore()
    h = Historian(capacity=16, window_s=600.0, store=store, persist_every=3)
    h.ingest(_snapshot(NOW))
    h.ingest(_snapshot(NOW + 1))
    assert store.get(STORE_KEY) is None  # below the persist cadence
    h.ingest(_snapshot(NOW + 2))
    assert store.get(STORE_KEY) is not None
    # corrupt persisted state: start fresh instead of crashing bring-up
    store.set(STORE_KEY, b"{not json")
    h3 = Historian(capacity=16, window_s=600.0, store=store)
    assert h3.metrics() == []


def test_to_json_round_trip_without_store():
    h = Historian(capacity=8, window_s=600.0)
    for i in range(4):
        h.ingest(_snapshot(NOW + i, step=i))
    h2 = Historian(capacity=8, window_s=600.0)
    h2.load_json(h.to_json())
    assert h2.window(1, "step") == h.window(1, "step")
    assert json.loads(h.to_json())["capacity"] == 8


def test_invalid_capacity_rejected():
    with pytest.raises(ValueError):
        Historian(capacity=0)


def test_env_knobs_drive_defaults(monkeypatch):
    monkeypatch.setenv("BAGUA_OBS_HISTORIAN_CAPACITY", "7")
    monkeypatch.setenv("BAGUA_OBS_HISTORIAN_WINDOW_S", "123")
    h = Historian()
    assert h.capacity == 7 and h.window_s == 123.0


def test_maybe_build_historian_tolerates_bad_knobs(monkeypatch):
    """The launcher factory: off -> None, on -> an instance, on with a
    broken capacity -> None with a warning — an observability knob must
    never kill the coordinator at bring-up."""
    from bagua_tpu_torch.obs.historian import maybe_build_historian

    monkeypatch.delenv("BAGUA_OBS_HISTORIAN", raising=False)
    assert maybe_build_historian() is None
    monkeypatch.setenv("BAGUA_OBS_HISTORIAN", "on")
    assert isinstance(maybe_build_historian(), Historian)
    monkeypatch.setenv("BAGUA_OBS_HISTORIAN_CAPACITY", "0")
    assert maybe_build_historian() is None  # degraded, not dead


def test_trend_gauges_reset_when_evidence_expires():
    """The fleet-worst gauges are refreshed every publish: once a dead
    series ages out of its window the gauge reads 0 (no evidence), not
    the last alarming slope."""
    from bagua_tpu_torch.telemetry import counters

    h = Historian(capacity=256, window_s=10.0)
    for i in range(6):
        h.ingest(_snapshot(NOW + i, hbm_headroom_bytes=4e9 - i * 2e8))
    assert counters.get("obs/hbm_headroom_slope") == pytest.approx(-2e8)
    for i in range(6, 30):  # the headroom poll dies; other metrics flow
        h.ingest(_snapshot(NOW + i))
    assert counters.get("obs/hbm_headroom_slope") == 0.0


# ---- parity with the JAX package -------------------------------------------


def _stream():
    """A seeded stream of two ranks: rank 1's HBM headroom shrinks, rank 0
    carries a DCN-dominated step, rank 1's DCN series stalls at sample 20
    and ages out."""
    import numpy as np

    rng = np.random.default_rng(7)
    out = []
    for i in range(40):
        obs0 = {"rank": 0, "step": 10 * i, "goodput_fraction": float(0.9 - 0.004 * i),
                "step_dt_p50": float(0.1 + 0.01 * rng.random()),
                "device_comm_dcn_s_per_step": float(0.07 + 0.005 * rng.random()),
                "hbm_headroom_bytes": float(8e9)}
        obs1 = {"rank": 1, "step": 10 * i, "goodput_fraction": float(0.85 + 0.01 * rng.random()),
                "step_dt_p50": float(0.12), "mfu": float(0.3 + 0.01 * rng.random()),
                "hbm_headroom_bytes": float(6e9 - 1.2e8 * i)}
        if i < 20:
            obs1["device_comm_dcn_s_per_step"] = 0.01
        out.append({
            "schema": "bagua-obs-fleet-v1", "time_unix": NOW + 7.0 * i, "epoch": 0,
            "nnodes": 2,
            "ranks": {"0": {"health": {}, "obs": {"0": obs0}},
                      "1": {"health": {"grad_unhealthy": i // 10}, "obs": {"1": obs1}}},
            "efficiency": {"ranks": {}, "goodput_fraction_min": 0.85,
                           "goodput_fraction_mean": 0.87},
        })
    return out


@pytest.mark.parametrize("window_s", [60.0, 600.0])
def test_trends_equal_the_jax_historians(window_s):
    from bagua_tpu.obs.historian import Historian as JHistorian

    port, ref = Historian(capacity=32, window_s=window_s), JHistorian(capacity=32,
                                                                      window_s=window_s)
    for rec in _stream():
        got, want = port.ingest(json.loads(json.dumps(rec))), ref.ingest(
            json.loads(json.dumps(rec)))
        assert got == want
        for rank in ("0", "1", FLEET_RANK):
            assert port.trend_summary(rank) == ref.trend_summary(rank)
    assert port.metrics() == ref.metrics()
    for rank, metric in ref.metrics():
        assert port.window(rank, metric) == ref.window(rank, metric)
        assert port.slope(rank, metric) == ref.slope(rank, metric)
        assert port.percentile(rank, metric, 0.9) == ref.percentile(rank, metric, 0.9)
    for metric in ("hbm_headroom_bytes", "goodput_fraction", "device_comm_dcn_s_per_step",
                   "nope"):
        for rank in (None, "1"):
            assert port.history_report(metric, rank=rank) == ref.history_report(metric,
                                                                               rank=rank)
    assert json.loads(port.to_json()) == json.loads(ref.to_json())


def test_least_squares_slope_equals_jax():
    import numpy as np

    from bagua_tpu.obs.historian import least_squares_slope as jslope

    rng = np.random.default_rng(3)
    for n in (1, 2, 3, 5, 17):
        samples = [(float(NOW + t), float(v)) for t, v in
                   zip(np.sort(rng.random(n) * 100), rng.normal(size=n))]
        assert least_squares_slope(samples) == jslope(samples)


def test_state_round_trips_between_the_packages():
    """A coordinator of either package resumes the other's persisted rings."""
    from bagua_tpu.contrib.utils.store import InMemoryStore as JStore
    from bagua_tpu.obs.historian import Historian as JHistorian

    from bagua_tpu_torch.contrib.utils.store import InMemoryStore

    ref = JHistorian(capacity=16, window_s=600.0, store=JStore(), persist_every=1)
    for rec in _stream()[:12]:
        ref.ingest(rec)
    store = InMemoryStore()
    store.set(STORE_KEY, ref.to_json())
    port = Historian(capacity=16, window_s=600.0, store=store)
    assert port.metrics() == ref.metrics()
    assert json.loads(port.to_json()) == json.loads(ref.to_json())
