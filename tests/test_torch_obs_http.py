"""The port's HTTP status plane (``bagua_tpu_torch/obs/http.py``).

Mirrors ``tests/test_obs_http.py``: per-process pull endpoints — /metrics
identical series-for-series with the exporter's metrics.prom, registered
HELP/TYPE on every series, /healthz, /ledger, and the coordinator's
/fleet + /history — the bind fallbacks (a taken port to an ephemeral one,
an unbindable address to loopback), the launcher's per-worker port offsets,
and the "still free" guards: concurrent scrapes during a live training run
(the port's trainer at world 1 on the CPU), the parameters bitwise with the
plane and the historian on (where the JAX package pins its traced program),
and the span-overhead budget with both on.  The trainer starts the plane at
construction when ``BAGUA_OBS_HTTP_PORT`` is set.  The port brings its own
free-port helper (the JAX test takes podsim's, not ported yet).
"""

import functools
import json
import os
import re
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from bagua_tpu_torch import telemetry
from bagua_tpu_torch.algorithms import GradientAllReduceAlgorithm
from bagua_tpu_torch.core.backend import BaguaTrainer
from bagua_tpu_torch.models.mlp import MLP
from bagua_tpu_torch.obs import export as obs_export
from bagua_tpu_torch.obs import http as obs_http
from bagua_tpu_torch.obs import spans as obs_spans
from bagua_tpu_torch.obs.historian import Historian
from bagua_tpu_torch.obs.http import ObsHTTPServer

_HANDED_OUT = set()


def reserve_port() -> int:
    """A free loopback port this process has not handed out before."""
    while True:
        with socket.socket() as s:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        if port not in _HANDED_OUT:
            _HANDED_OUT.add(port)
            return port


@pytest.fixture(scope="module", autouse=True)
def process_group():
    import bagua_tpu_torch as bt

    bt.init_process_group(device="cpu")


NOW = 1_754_000_000.0


@pytest.fixture()
def server():
    srv = ObsHTTPServer(port=0).start()
    yield srv
    srv.stop()


def _get(srv, path):
    with urllib.request.urlopen(srv.url + path, timeout=10) as rsp:
        return rsp.status, rsp.headers.get("Content-Type", ""), \
            rsp.read().decode()


def _series(prom_text):
    """Sample-line metric names of a Prometheus exposition text."""
    return {line.split(" ", 1)[0] for line in prom_text.splitlines()
            if line and not line.startswith("#")}


def _golden_trainer(width=64, **kw):
    """A world-1 trainer on the CPU over an MLP of the golden task's shape
    (4 inputs, 8 classes) and its batch."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(64, 4, generator=g)
    batch = {"x": x, "y": (x @ torch.randn(4, 8, generator=g)).argmax(-1)}

    def loss_fn(m, b):
        return torch.nn.functional.cross_entropy(m(b["x"]), b["y"])

    t = BaguaTrainer(loss_fn, functools.partial(torch.optim.SGD, lr=0.1),
                     GradientAllReduceAlgorithm(), device="cpu", autotune=False, **kw)
    s = t.init(MLP(4, (width, width, 8), device="cpu"))
    return t, s, t.shard_batch(batch)


# ---- /metrics: the Prometheus surface -------------------------------------


def test_metrics_scrape_parses_with_help_and_type(server):
    """Satellite gate: every exposed series carries the registry's
    # HELP/# TYPE lines, is a registered metric, and none export as
    untyped — the table cannot drift from the live endpoint."""
    telemetry.counters.incr("comm/abort_resets")
    status, ctype, text = _get(server, "/metrics")
    assert status == 200
    assert ctype.startswith("text/plain")
    assert "untyped" not in text
    helped = set()
    typed = set()
    for line in text.splitlines():
        m = re.match(r"# (HELP|TYPE) (\S+)", line)
        if m:
            (helped if m.group(1) == "HELP" else typed).add(m.group(2))
            continue
        if not line:
            continue
        name, _, value = line.partition(" ")
        float(value)  # sample lines parse
        assert name in helped, f"{name} has no # HELP"
        assert name in typed, f"{name} has no # TYPE"
    # reverse-map: every sample series is a registered metric
    prom_names = {obs_export.prometheus_name(n)
                  for n in obs_export.METRIC_REGISTRY}
    for name in _series(text):
        assert name in prom_names, f"{name} not in METRIC_REGISTRY"


def test_metrics_scrape_matches_prom_file_series_for_series(server,
                                                           tmp_path):
    """Acceptance pin: a live /metrics scrape exposes the identical
    series set as the concurrent metrics.prom snapshot (both render the
    same prepared snapshot)."""
    exporter = obs_export.MetricsExporter(str(tmp_path), interval_s=3600)
    os.makedirs(str(tmp_path), exist_ok=True)
    # warm the self-accounting counters so their first appearance is
    # behind us (obs/http_requests via a scrape, obs/export_snapshots via
    # an export), then compare steady state
    _get(server, "/metrics")
    exporter.export_once()
    exporter.export_once()
    _, _, scraped = _get(server, "/metrics")
    on_disk = open(tmp_path / "metrics.prom").read()
    assert _series(scraped) == _series(on_disk)
    # and both carry the typed header block for each series
    for text in (scraped, on_disk):
        assert "# TYPE bagua_obs_export_snapshots counter" in text
        assert "# TYPE bagua_obs_http_requests counter" in text


def test_scrapes_count_requests(server):
    before = telemetry.counters.get("obs/http_requests")
    _get(server, "/metrics")
    _get(server, "/healthz")
    assert telemetry.counters.get("obs/http_requests") == before + 2


# ---- the JSON routes -------------------------------------------------------


def test_healthz_and_ledger_routes(server):
    status, ctype, body = _get(server, "/healthz")
    assert status == 200 and ctype.startswith("application/json")
    payload = json.loads(body)
    assert payload["status"] == "ok"
    assert isinstance(payload["rank"], int)
    status, _, body = _get(server, "/ledger")
    assert status == 200
    json.loads(body)  # report or null-with-rationale, always JSON


def test_unknown_route_404(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(server, "/nope")
    assert e.value.code == 404


def test_fleet_and_history_absent_on_worker_processes(server):
    """A worker's server has no fleet provider / historian: the
    coordinator-only routes answer 404, not garbage."""
    for path in ("/fleet", "/history?metric=step"):
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(server, path)
        assert e.value.code == 404


def test_fleet_and_history_routes_on_coordinator():
    h = Historian(capacity=32, window_s=600.0)
    holder = {}

    def snap(i):
        return {
            "schema": "bagua-obs-fleet-v1", "time_unix": NOW + i,
            "epoch": 1, "nnodes": 1,
            "ranks": {"1": {"health": {}, "obs": {"1": {
                "rank": 1, "step": 50 + i, "goodput_fraction": 0.9,
                "hbm_headroom_bytes": 4e9 - i * 2e8}}}},
            "efficiency": {"ranks": {}, "goodput_fraction_min": 0.9,
                           "goodput_fraction_mean": 0.9},
        }

    for i in range(6):
        holder["record"] = h.ingest(snap(i))
    srv = ObsHTTPServer(port=0, fleet_provider=lambda: holder.get("record"),
                        historian=h).start()
    try:
        _, _, body = _get(srv, "/fleet")
        fleet = json.loads(body)
        assert obs_export.validate_fleet_snapshot(fleet) == []
        # the served record carries the historian's trend augmentation
        assert "trends" in fleet["ranks"]["1"]["obs"]["1"]
        _, _, body = _get(srv, "/history?metric=hbm_headroom_bytes")
        report = json.loads(body)
        assert report["ranks"]["1"]["slope_per_s"] == pytest.approx(-2e8)
        _, _, body = _get(srv,
                          "/history?metric=step&rank=1&window=2.5")
        report = json.loads(body)
        assert len(report["ranks"]["1"]["samples"]) == 3
        # missing metric= -> 400 listing the series
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(srv, "/history")
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(srv, "/history?metric=step&window=abc")
        assert e.value.code == 400
    finally:
        srv.stop()


def test_fleet_render_cache_tracks_record_identity():
    """/fleet serializes once per record OBJECT, not once per request —
    and a new record object (the monitor builds one per tick) must bust
    the cache.  cache_fleet_json=False restores the per-request path
    (used by scale_drill's before/after bench) with identical bodies."""
    rec_a = {"schema": "bagua-obs-fleet-v1", "time_unix": NOW, "marker": "a"}
    rec_b = {"schema": "bagua-obs-fleet-v1", "time_unix": NOW + 1,
             "marker": "b"}
    holder = {"record": rec_a}
    for cached in (True, False):
        srv = ObsHTTPServer(port=0, fleet_provider=lambda: holder["record"],
                            cache_fleet_json=cached).start()
        try:
            holder["record"] = rec_a
            _, _, body1 = _get(srv, "/fleet")
            _, _, body2 = _get(srv, "/fleet")
            assert body1 == body2
            assert json.loads(body1)["marker"] == "a"
            holder["record"] = rec_b  # fresh object -> fresh render
            _, _, body3 = _get(srv, "/fleet")
            assert json.loads(body3)["marker"] == "b"
        finally:
            srv.stop()


# ---- bring-up / gating -----------------------------------------------------


def test_disabled_by_default(monkeypatch):
    monkeypatch.delenv("BAGUA_OBS_HTTP_PORT", raising=False)
    monkeypatch.setattr(obs_http, "_GLOBAL_SERVER", None)
    assert obs_http.maybe_start_global_http_server() is None


def test_global_server_starts_once_and_attaches_hooks(monkeypatch):
    monkeypatch.setenv("BAGUA_OBS_HTTP_PORT", "0")
    assert obs_http.maybe_start_global_http_server() is None  # 0 = off
    # an ephemeral-but-on port, reserved so parallel tests can't steal it
    free_port = reserve_port()
    monkeypatch.setenv("BAGUA_OBS_HTTP_PORT", str(free_port))
    monkeypatch.setattr(obs_http, "_GLOBAL_SERVER", None)
    try:
        srv = obs_http.maybe_start_global_http_server()
        assert srv is not None and srv.port == free_port
        again = obs_http.maybe_start_global_http_server(
            fleet_provider=lambda: {"schema": "bagua-obs-fleet-v1"})
        assert again is srv  # one server per process; hooks attach late
        _, _, body = _get(srv, "/fleet")
        assert json.loads(body)["schema"] == "bagua-obs-fleet-v1"
        assert telemetry.counters.get("obs/http_port") == free_port
    finally:
        if obs_http._GLOBAL_SERVER is not None:
            obs_http._GLOBAL_SERVER.stop()
        monkeypatch.setattr(obs_http, "_GLOBAL_SERVER", None)


def test_unbindable_addr_falls_back_to_loopback():
    """A mistyped BAGUA_OBS_HTTP_ADDR must degrade to loopback-ephemeral,
    never kill bring-up (the trainer constructs servers unconditionally
    when the port knob is set)."""
    srv = ObsHTTPServer(port=0, addr="203.0.113.254").start()  # TEST-NET-3
    try:
        assert srv.addr == "127.0.0.1"
        status, _, _ = _get(srv, "/healthz")
        assert status == 200
    finally:
        srv.stop()


def test_stop_clears_global_server_slot(monkeypatch):
    """run_elastic's teardown stops the global server; a later bring-up
    in the same process must get a LIVE server, not the dead socket."""
    free_port = reserve_port()
    monkeypatch.setenv("BAGUA_OBS_HTTP_PORT", str(free_port))
    monkeypatch.setattr(obs_http, "_GLOBAL_SERVER", None)
    try:
        first = obs_http.maybe_start_global_http_server()
        first.stop()
        assert obs_http._GLOBAL_SERVER is None
        second = obs_http.maybe_start_global_http_server()
        assert second is not None and second is not first
        status, _, _ = _get(second, "/healthz")
        assert status == 200
    finally:
        if obs_http._GLOBAL_SERVER is not None:
            obs_http._GLOBAL_SERVER.stop()
        monkeypatch.setattr(obs_http, "_GLOBAL_SERVER", None)


def test_taken_port_falls_back_to_ephemeral():
    first = ObsHTTPServer(port=0).start()
    try:
        second = ObsHTTPServer(port=first.port).start()
        try:
            assert second.port != first.port
            status, _, _ = _get(second, "/healthz")
            assert status == 200
        finally:
            second.stop()
    finally:
        first.stop()


def test_launcher_offsets_worker_ports(monkeypatch):
    from bagua_tpu_torch.distributed.run import build_env, parse_args

    args = parse_args(["--nnodes", "1", "script.py"])
    monkeypatch.delenv("BAGUA_OBS_HTTP_PORT", raising=False)
    assert "BAGUA_OBS_HTTP_PORT" not in build_env(args, 0)
    monkeypatch.setenv("BAGUA_OBS_HTTP_PORT", "9300")
    assert build_env(args, 0)["BAGUA_OBS_HTTP_PORT"] == "9301"
    assert build_env(args, 3)["BAGUA_OBS_HTTP_PORT"] == "9304"


# ---- load + "still free" guards -------------------------------------------


def test_concurrent_scrapes_during_live_training(server):
    """The load satellite: N scraper threads hammer /metrics and
    /healthz while a real cpu-sim training run steps; every scrape
    parses, the run's losses stay finite, and nothing deadlocks."""
    import numpy as np

    t, s, b = _golden_trainer()
    errors = []
    stop = threading.Event()
    counts = [0] * 4

    def scraper(i):
        while not stop.is_set():
            try:
                _, _, text = _get(server, "/metrics")
                assert "# TYPE" in text
                _get(server, "/healthz")
                counts[i] += 1
            except Exception as e:  # noqa: BLE001 - collected for assert
                errors.append(e)
                return

    threads = [threading.Thread(target=scraper, args=(i,), daemon=True)
               for i in range(4)]
    for th in threads:
        th.start()
    try:
        for _ in range(12):
            s, loss = t.train_step(s, b)
        assert np.isfinite(float(loss))
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=10)
    assert not errors, errors
    assert sum(counts) >= 4  # every scraper made progress


def test_step_program_identical_with_http_and_historian(monkeypatch):
    """The HTTP plane and the historian are host-side by construction: with
    the plane serving (a live server scraped between the steps) and the
    historian on, the parameters after 4 steps are bitwise those of the
    default-off run (the JAX package pins its traced program)."""
    def run(on):
        if on:
            monkeypatch.setenv("BAGUA_OBS_HTTP_PORT", "0")
            monkeypatch.setenv("BAGUA_OBS_HISTORIAN", "on")
        else:
            monkeypatch.delenv("BAGUA_OBS_HTTP_PORT", raising=False)
            monkeypatch.delenv("BAGUA_OBS_HISTORIAN", raising=False)
        t, s, b = _golden_trainer()
        for _ in range(4):
            s, loss = t.train_step(s, b)
            if on:
                _get(srv, "/metrics")
                _get(srv, "/healthz")
        return {n: p.detach().clone() for n, p in s.model.named_parameters()}, float(loss)

    srv = ObsHTTPServer(port=0).start()
    try:
        (p_on, l_on), (p_off, l_off) = run(True), run(False)
    finally:
        srv.stop()
    assert l_on == l_off
    assert all(torch.equal(p_on[n], p_off[n]) for n in p_off)


def test_span_overhead_budget_with_http_and_historian(monkeypatch):
    """The <2% span-overhead budget re-asserted with the HTTP server
    serving and the historian ingesting in-process (the plane's gate must
    survive both)."""
    obs_spans.set_enabled(True)
    srv = ObsHTTPServer(port=0).start()
    historian = Historian(capacity=64, window_s=600.0)
    try:
        # a step long enough that the host clock resolves 2% of it
        t, s, b = _golden_trainer(width=1024)
        before = len(obs_spans.recorder.snapshot())
        for i in range(5):
            s, loss = t.train_step(s, b)
            historian.ingest({
                "schema": "bagua-obs-fleet-v1", "time_unix": NOW + i,
                "epoch": 0, "nnodes": 1,
                "ranks": {"0": {"health": {}, "obs": {"0": {
                    "rank": 0, "step": i, "goodput_fraction": 0.9}}}},
                "efficiency": {"ranks": {}},
            })
        float(loss)
        step_dt = t.measured_step_dt()
        assert step_dt and step_dt > 0
        spans = obs_spans.recorder.snapshot()[before:]
        per_step = [sp for sp in spans if sp.get("step") == t._step_counter
                    and not sp["name"].startswith(("trace/", "step/build"))]
        n_spans = max(1, len(per_step))
        reps = 2000
        batches = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(reps):
                with obs_spans.trace_span("overhead_probe"):
                    pass
            batches.append((time.perf_counter() - t0) / reps)
        per_span = min(batches)
        overhead = n_spans * per_span
        assert overhead < 0.02 * step_dt, (
            f"{n_spans} spans x {per_span * 1e6:.2f}us = "
            f"{overhead * 1e6:.1f}us >= 2% of step_dt {step_dt * 1e3:.2f}ms"
        )
    finally:
        srv.stop()
        obs_spans.recorder.clear()
        obs_spans.set_enabled(None)


def test_trainer_starts_the_plane_at_construction(monkeypatch):
    """With ``BAGUA_OBS_HTTP_PORT`` set the trainer brings the process's
    plane up (``backend.py:583-594``); a live scrape mid-run parses and
    /healthz carries the step."""
    port = reserve_port()
    monkeypatch.setenv("BAGUA_OBS_HTTP_PORT", str(port))
    monkeypatch.setattr(obs_http, "_GLOBAL_SERVER", None)
    obs_spans.set_enabled(True)
    try:
        t, s, b = _golden_trainer()
        srv = obs_http._GLOBAL_SERVER
        assert srv is not None and srv.port == port
        for _ in range(3):
            s, _ = t.train_step(s, b)
        _, _, text = _get(srv, "/metrics")
        assert "# TYPE" in text and "untyped" not in text
        _, _, body = _get(srv, "/healthz")
        assert json.loads(body)["step"] == 3
    finally:
        if obs_http._GLOBAL_SERVER is not None:
            obs_http._GLOBAL_SERVER.stop()
        monkeypatch.setattr(obs_http, "_GLOBAL_SERVER", None)
        obs_spans.set_enabled(None)


def test_routes_serve_what_the_jax_plane_serves():
    """Both packages' planes over the same fleet record and historian
    stream answer /fleet and /history alike."""
    from bagua_tpu.obs.historian import Historian as JHistorian
    from bagua_tpu.obs.http import ObsHTTPServer as JServer

    recs = [{"schema": "bagua-obs-fleet-v1", "time_unix": NOW + i, "epoch": 1, "nnodes": 1,
             "ranks": {"1": {"health": {}, "obs": {"1": {
                 "rank": 1, "step": 50 + i, "goodput_fraction": 0.9 - 0.01 * i,
                 "hbm_headroom_bytes": 4e9 - i * 2e8}}}},
             "efficiency": {"ranks": {}, "goodput_fraction_min": 0.9,
                            "goodput_fraction_mean": 0.9}} for i in range(8)]
    bodies = []
    for hist_cls, srv_cls in ((Historian, ObsHTTPServer), (JHistorian, JServer)):
        h = hist_cls(capacity=32, window_s=600.0)
        holder = {}
        for r in recs:
            holder["record"] = h.ingest(json.loads(json.dumps(r)))
        srv = srv_cls(port=0, fleet_provider=lambda holder=holder: holder.get("record"),
                      historian=h).start()
        try:
            bodies.append([json.loads(_get(srv, path)[2]) for path in (
                "/fleet", "/history?metric=hbm_headroom_bytes",
                "/history?metric=goodput_fraction&rank=1&window=3")])
        finally:
            srv.stop()
    assert bodies[0] == bodies[1]
