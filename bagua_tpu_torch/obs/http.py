"""HTTP status plane: a stdlib-threaded pull endpoint per process.

Port of ``bagua_tpu/obs/http.py``; the same routes and payloads.

The obs plane's push half (the :class:`~bagua_tpu_torch.obs.export
.MetricsExporter` writing ``metrics.jsonl``/``metrics.prom``) needs a
filesystem an operator can reach; a fleet of pods does not have one.
This module is the pull half — the reference Bagua runs a Flask autotune
sidecar every rank talks to; here every process can serve its own
read-only status over ``http.server`` (no new dependency, no app
framework):

* ``GET /metrics`` — Prometheus text rendered from the SAME prepared
  counters snapshot ``metrics.prom`` is written from
  (:func:`bagua_tpu_torch.obs.export.prepared_snapshot`), so a live scrape and
  the on-disk file expose the identical series set, each with the
  registry's ``# HELP``/``# TYPE`` lines.
* ``GET /healthz`` — liveness JSON (rank, latest step, goodput fraction
  when the ledger has one).
* ``GET /ledger`` — the goodput ledger report
  (:meth:`bagua_tpu_torch.obs.ledger.GoodputLedger.report`).
* Coordinator only (the process hosting the fleet merge): ``GET /fleet``
  — the latest ``bagua-obs-fleet-v1`` record — and
  ``GET /history?metric=&rank=&window=`` — windowed samples + stats from
  the telemetry historian (:mod:`bagua_tpu_torch.obs.historian`).

Gated by ``BAGUA_OBS_HTTP_PORT`` (0 = off, the default) and bound to
``BAGUA_OBS_HTTP_ADDR`` (loopback by default — the endpoints are
read-only but unauthenticated).  A taken port falls back to an ephemeral
one: on a single host the elastic launcher offsets each worker's port,
but ad-hoc runs must never die on a bind race.  The bound port is logged
and published as the ``obs/http_port`` gauge.

Host-side only by construction — handlers read counters, the span ring,
and pre-read-back summaries; they never touch a device array — so the
training step is the same with the server on or off (the parameters are
bitwise equal, ``tests/test_torch_obs_http.py``).
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Optional
from urllib.parse import parse_qs, urlsplit

from .. import env as _env
from ..telemetry import counters
from . import export as _export

logger = logging.getLogger(__name__)

__all__ = ["ObsHTTPServer", "maybe_start_global_http_server"]

#: Prometheus exposition-format content type (text version 0.0.4)
_PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _ledger_report() -> Optional[dict]:
    from .ledger import ledger

    return ledger.report()


class _Handler(BaseHTTPRequestHandler):
    """One request handler; the owning :class:`ObsHTTPServer` hangs its
    hooks off the server object (``self.server``)."""

    server_version = "bagua-obs/1"

    # ---- plumbing -------------------------------------------------------

    def log_message(self, fmt, *args):  # noqa: A003 - stdlib signature
        logger.debug("obs http: " + fmt, *args)

    def _respond(self, code: int, body: str, content_type: str) -> None:
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _json(self, payload: Any, code: int = 200) -> None:
        self._respond(code, json.dumps(payload, indent=1, sort_keys=True),
                      "application/json")

    def _not_found(self, why: str) -> None:
        self._json({"error": why}, code=404)

    # ---- routes ---------------------------------------------------------

    def do_GET(self):  # noqa: N802 - stdlib handler name
        counters.incr("obs/http_requests")
        url = urlsplit(self.path)
        try:
            if url.path == "/metrics":
                self._respond(
                    200,
                    _export.render_prometheus(_export.prepared_snapshot()),
                    _PROM_CONTENT_TYPE,
                )
            elif url.path == "/healthz":
                self._healthz()
            elif url.path == "/ledger":
                report = _ledger_report()
                self._json(report if report is not None
                           else {"available": False,
                                 "rationale": "no step window noted yet"})
            elif url.path == "/fleet":
                self._fleet()
            elif url.path == "/history":
                self._history(parse_qs(url.query))
            else:
                self._not_found(f"no route {url.path}; have /metrics "
                                "/healthz /ledger /fleet /history")
        except BrokenPipeError:  # client went away mid-write
            pass
        except Exception as e:  # noqa: BLE001 - a scrape must not kill
            logger.warning("obs http: %s failed: %s", url.path, e)
            try:
                self._json({"error": f"{type(e).__name__}: {e}"}, code=500)
            except OSError:
                pass

    def _healthz(self) -> None:
        import time

        summary = _export.local_obs_summary()
        payload: dict = {
            "status": "ok",
            "rank": int(_env.get_rank()),
            "time_unix": time.time(),
        }
        if summary:
            payload["step"] = summary.get("step")
            if "goodput_fraction" in summary:
                payload["goodput_fraction"] = summary["goodput_fraction"]
        self._json(payload)

    def _fleet(self) -> None:
        provider = getattr(self.server, "fleet_provider", None)
        record = provider() if provider is not None else None
        if record is None:
            self._not_found("no fleet record (not the coordinator, or no "
                            "snapshot merged yet)")
            return
        self._respond(200, self._fleet_body(record), "application/json")

    def _fleet_body(self, record: dict) -> str:
        # /fleet is the one route whose payload is identical between
        # monitor ticks but whose serialization grows with world size
        # (O(nnodes) record, sorted keys, indentation) — under a many-
        # scraper load at pod scale the coordinator burned its single
        # monitor core re-rendering the same record per request.  Cache
        # the rendered body keyed on record object IDENTITY: the monitor
        # loop builds a fresh record object per tick, so `is` is exactly
        # "same tick's record" with no hashing or deep comparison.
        if not getattr(self.server, "cache_fleet_json", True):
            return json.dumps(record, indent=1, sort_keys=True)
        lock = getattr(self.server, "fleet_cache_lock", None)
        if lock is None:
            lock = self.server.fleet_cache_lock = threading.Lock()
            self.server.fleet_json_cache = [None, ""]
        with lock:
            cache = self.server.fleet_json_cache
            if cache[0] is not record:
                cache[0] = record
                cache[1] = json.dumps(record, indent=1, sort_keys=True)
            return cache[1]

    def _history(self, query) -> None:
        historian = getattr(self.server, "historian", None)
        if historian is None:
            self._not_found("no historian on this process "
                            "(BAGUA_OBS_HISTORIAN=on, coordinator only)")
            return
        metric = (query.get("metric") or [None])[0]
        if not metric:
            self._json({"error": "metric= is required",
                        "series": historian.metrics()}, code=400)
            return
        rank = (query.get("rank") or [None])[0]
        window_raw = (query.get("window") or [None])[0]
        try:
            window_s = float(window_raw) if window_raw is not None else None
        except ValueError:
            self._json({"error": f"window={window_raw!r} is not a number"},
                       code=400)
            return
        self._json(historian.history_report(metric, rank=rank,
                                            window_s=window_s))


class ObsHTTPServer:
    """One status server per process.  ``fleet_provider`` (a callable
    returning the latest fleet record, or None) and ``historian`` are the
    coordinator-only hooks; worker processes leave them unset and serve
    the per-process routes only."""

    def __init__(self, port: Optional[int] = None, addr: Optional[str] = None,
                 fleet_provider: Optional[Callable[[], Optional[dict]]] = None,
                 historian=None, cache_fleet_json: bool = True):
        self._requested_port = int(
            _env.get_obs_http_port() if port is None else port
        )
        self.addr = str(_env.get_obs_http_addr() if addr is None else addr)
        self._fleet_provider = fleet_provider
        self._historian = historian
        # cache_fleet_json=False restores per-request /fleet rendering —
        # the scale drill's before/after benchmark knob
        self._cache_fleet_json = bool(cache_fleet_json)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "ObsHTTPServer":
        # bind fallback chain: the configured (addr, port), then an
        # ephemeral port on the same addr (bind race with another local
        # process), then loopback-ephemeral (a mistyped/unassigned
        # BAGUA_OBS_HTTP_ADDR) — status must degrade to "different
        # port/addr", never to "process died on bring-up"
        for addr, port in ((self.addr, self._requested_port),
                           (self.addr, 0), ("127.0.0.1", 0)):
            try:
                self._httpd = ThreadingHTTPServer((addr, port), _Handler)
                self.addr = addr
                break
            except OSError as e:
                logger.warning(
                    "obs http: cannot bind %s:%d (%s); falling back",
                    addr, port, e,
                )
        else:  # pragma: no cover - loopback-ephemeral essentially binds
            logger.error("obs http: no bindable address; server disabled")
            return self
        self._httpd.daemon_threads = True
        self._httpd.fleet_provider = self._fleet_provider
        self._httpd.historian = self._historian
        self._httpd.cache_fleet_json = self._cache_fleet_json
        self._httpd.fleet_cache_lock = threading.Lock()
        self._httpd.fleet_json_cache = [None, ""]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="bagua-obs-http",
            daemon=True,
        )
        self._thread.start()
        counters.set_gauge("obs/http_port", self.port)
        logger.info("obs http: serving on %s:%d", self.addr, self.port)
        return self

    @property
    def port(self) -> int:
        """The port actually bound (differs from the requested one after
        an ephemeral fallback)."""
        if self._httpd is None:
            return self._requested_port
        return int(self._httpd.server_address[1])

    @property
    def url(self) -> str:
        return f"http://{self.addr}:{self.port}"

    def set_fleet_provider(self, provider) -> None:
        self._fleet_provider = provider
        if self._httpd is not None:
            self._httpd.fleet_provider = provider

    def set_historian(self, historian) -> None:
        self._historian = historian
        if self._httpd is not None:
            self._httpd.historian = historian

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        # a stopped server must not shadow the process-wide slot: the
        # next maybe_start_global_http_server() brings up a live one
        # instead of handing back a dead socket
        global _GLOBAL_SERVER
        with _GLOBAL_SERVER_LOCK:
            if _GLOBAL_SERVER is self:
                _GLOBAL_SERVER = None


_GLOBAL_SERVER: Optional[ObsHTTPServer] = None
_GLOBAL_SERVER_LOCK = threading.Lock()


def maybe_start_global_http_server(fleet_provider=None, historian=None
                                   ) -> Optional[ObsHTTPServer]:
    """Process-wide status server, started once when
    ``BAGUA_OBS_HTTP_PORT`` is set (> 0) — the global-exporter pattern.
    Later callers may attach the coordinator hooks (fleet provider /
    historian) to the already-running server."""
    port = _env.get_obs_http_port()
    if port <= 0:
        return None
    global _GLOBAL_SERVER
    with _GLOBAL_SERVER_LOCK:
        if _GLOBAL_SERVER is None:
            try:
                _GLOBAL_SERVER = ObsHTTPServer(
                    port=port, fleet_provider=fleet_provider,
                    historian=historian,
                ).start()
            except Exception as e:  # noqa: BLE001 - a status knob must
                # never kill training bring-up
                logger.warning("obs http: server not started: %s", e)
                return None
        else:
            if fleet_provider is not None:
                _GLOBAL_SERVER.set_fleet_provider(fleet_provider)
            if historian is not None:
                _GLOBAL_SERVER.set_historian(historian)
        return _GLOBAL_SERVER
