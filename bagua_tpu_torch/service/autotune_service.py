"""Autotune sidecar: HTTP service + client.

Port of ``bagua_tpu/service/autotune_service.py``, the counterpart of the
reference's bagua/service/autotune_service.py (Flask app with 4 routes
:155-294, warmup/sampling state machine :78-152, AutotuneClient :302-384).
Flask is not a dependency; the service is a stdlib
``ThreadingHTTPServer`` speaking the same JSON protocol on the same paths, so
reference-style clients port over.

State machine per model (as in the reference):
  warmup  — serve the default recommendation, ignore scores, until
            ``warmup_time_s`` after the first ask;
  sampling — every ``sampling_confidence_time_s`` (and only once every rank
            has checked in at the sampled iteration) record the aggregate
            speed as the current point's score, then ask the optimizer for
            the next (bucket_size, hierarchical) point;
  completed — after ``max_samples`` points, pin the best point forever.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional
from urllib import error, request

from ..define import BaguaHyperparameter, TensorDeclaration
from .autotune_task_manager import AutotuneTaskManager

logger = logging.getLogger(__name__)

API = "/api/v1"


class _TaskState:
    def __init__(self, model_name: str, service: "AutotuneService"):
        self.model_name = model_name
        self.lock = threading.Lock()
        self.manager = AutotuneTaskManager(
            model_name, service.is_output_autotune_log,
            tune_algorithm=service.tune_algorithm,
        )
        self.tensor_list: List[TensorDeclaration] = []
        self.recommended = BaguaHyperparameter(
            bucket_size=service.default_bucket_size
        )
        #: trainer-reported capabilities (mesh tiers, EF/flat legality,
        #: switchable families) — presence selects the v2 knob space
        self.capabilities: Optional[dict] = None
        #: per-rank efficiency observations riding the check-in (windowed
        #: goodput_fraction / mfu / dcn share / hbm headroom; replace
        #: semantics like ``speed_by_rank``) — the v2 scoring input
        self.obs_by_rank: Dict[int, dict] = {}
        #: last HBM headroom per rank, for the shrinking-headroom trend
        #: weighting; one flat-residency prior max per search
        self.hbm_prev: Dict[int, float] = {}
        self.flat_primed = False
        self.first_ask_time: Optional[float] = None
        self.sample_start_time: Optional[float] = None
        self.sample_start_iter = 0
        self.speed_by_rank: Dict[int, float] = {}
        self.iter_by_rank: Dict[int, int] = {}
        self.n_samples = 0
        self.completed = False
        # perf hints from the workers' anomaly detectors (newest last,
        # bounded): environmental slowness context for the scorer — a
        # sample whose window carried a straggler_suspect hint scores the
        # environment, not the hyperparameter point.  The watermark below
        # is the MONOTONIC received count, never len(perf_hints): once the
        # bounded list saturates, its length stops moving exactly when
        # hints are most frequent
        self.perf_hints: List[dict] = []
        self.perf_hints_total = 0
        self.sample_hint_mark = 0
        self.sample_retried = False
        #: scoring mode the task's FIRST scored window established (True =
        #: fleet-min goodput, False = summed speed).  Goodput lives in
        #: [0, 1]; speed is steps/s-scaled — one sample scored on the
        #: other scale would dominate (or vanish under) every honest one
        #: in the optimizer's best(), so a window whose mode disagrees is
        #: re-measured once and then discarded from the tell
        self.goodput_mode: Optional[bool] = None
        # fleet-autopilot controller state (docs/autopilot.md): a pinned
        # algorithm family overrides every recommendation until cleared
        # (the ladder's switch rung must survive later BO points), and
        # extra_samples re-opens a completed search for a bounded retune
        self.pinned_algorithm: Optional[str] = None
        self.extra_samples = 0
        # per-round decision cache: every rank asking at the same train_iter
        # must receive the SAME recommendation, or the ranks' compiled SPMD
        # programs diverge and their collectives deadlock (trainers check in
        # at deterministic iterations, so train_iter identifies the round)
        self.decisions: Dict[int, dict] = {}


class AutotuneService:
    def __init__(
        self,
        world_size: int,
        autotune_level: int = 1,
        max_samples: int = 60,
        sampling_confidence_time_s: float = 5.0,
        warmup_time_s: float = 30.0,
        is_output_autotune_log: bool = False,
        default_bucket_size: int = 10 * 1024 ** 2,
        tune_algorithm: bool = False,
    ):
        self.world_size = world_size
        self.autotune_level = autotune_level
        self.max_samples = max_samples
        self.sampling_confidence_time_s = sampling_confidence_time_s
        self.warmup_time_s = warmup_time_s
        self.is_output_autotune_log = is_output_autotune_log
        self.default_bucket_size = default_bucket_size
        self.tune_algorithm = tune_algorithm
        self._tasks: Dict[str, _TaskState] = {}
        self._tasks_lock = threading.Lock()

    def _task(self, model_name: str) -> _TaskState:
        with self._tasks_lock:
            if model_name not in self._tasks:
                self._tasks[model_name] = _TaskState(model_name, self)
            return self._tasks[model_name]

    # ---- route handlers --------------------------------------------------

    def register_tensors(self, req: dict) -> dict:
        task = self._task(req["model_name"])
        decls = [TensorDeclaration(**t) for t in req["tensor_list"]]
        with task.lock:
            if not task.tensor_list:
                task.tensor_list = decls
                caps = req.get("capabilities")
                if isinstance(caps, dict):
                    task.capabilities = caps
                    # capability-gated v2 knob space: the trainer's mesh /
                    # family / layout legality decides which knobs exist
                    task.manager.configure_space(caps)
                from ..bucket import split_bucket_by_bucket_size

                task.recommended = BaguaHyperparameter(
                    buckets=split_bucket_by_bucket_size(
                        decls, self.default_bucket_size
                    ),
                    bucket_size=self.default_bucket_size,
                )
            return {
                "recommended_hyperparameters": task.recommended.model_dump(),
            }

    def report_metrics(self, req: dict) -> dict:
        task = self._task(req["model_name"])
        rank = int(req["rank"])
        with task.lock:
            if rank >= 0:
                task.speed_by_rank[rank] = float(req["speed"])
                obs = req.get("obs")
                if isinstance(obs, dict):
                    task.obs_by_rank[rank] = obs
                    self._ingest_trends(task, rank, obs)
            # a NEGATIVE rank is a controller (the fleet autopilot, rank
            # -1): its report carries hints only — recording its zero
            # "speed" would poison the ranks' summed score
            for hint in req.get("perf_hints") or []:
                if isinstance(hint, dict):
                    # codec names are validated ONCE here at ingest
                    # (invalid -> stripped with a warning); everything
                    # downstream — the pin path, the prior construction, every
                    # tell iteration — trusts the normalized value
                    hint = self._normalize_hint(task, hint)
                    task.perf_hints.append({**hint, "reported_by": rank})
                    task.perf_hints_total += 1
                    self._apply_controller_hint(task, hint)
            del task.perf_hints[:-64]  # bounded: hints are context, not log
        return {"message": "ok"}

    def _normalize_hint(self, task: _TaskState, hint: dict) -> dict:
        """Validate a hint's codec name exactly once at ingest.  An
        unknown codec is replaced by the empty string — downstream
        consumers skip actuation/priming on it but still honor the hint's
        other semantics (re-measure re-grant)."""
        codec = hint.get("codec")
        if codec is None:
            return hint
        from ..compression.codecs import validate_codec_policy

        try:
            return {**hint, "codec": validate_codec_policy(
                str(codec), "compress_inter")}
        except ValueError as e:
            logger.warning(
                "autotune[%s]: hint %r carried an unknown codec, "
                "stripped at ingest: %s",
                task.model_name, hint.get("kind"), e,
            )
            return {**hint, "codec": ""}

    def _ingest_trends(self, task: _TaskState, rank: int, obs: dict) -> None:
        """Historian-style trend signals riding the check-in become
        COORDINATE WEIGHTS and (once) a warm-start prior for a live v2
        search — never recommendation pins (caller holds ``task.lock``).

        * sustained DCN share of the step -> bias the exploit step toward
          the DCN-tier knobs (``compress_inter``, the inter chunk size);
        * shrinking HBM headroom -> bias toward ``flat_resident`` and
          prime one flat-layout point (the resident layout drops the
          per-step flatten temporaries).
        """
        mgr = task.manager
        if mgr.space is None or task.completed:
            return
        dcn_share = obs.get("dcn_share")
        if isinstance(dcn_share, (int, float)) and dcn_share > 0.15:
            boost = 1.0 + 4.0 * min(1.0, float(dcn_share))
            if mgr.space.has("compress_inter"):
                mgr.weight_coordinate("compress_inter", boost)
            if mgr.space.has("overlap_chunk_bytes_inter_2p"):
                mgr.weight_coordinate(
                    "overlap_chunk_bytes_inter_2p", 1.0 + 2.0 * boost / 5.0
                )
        hbm = obs.get("hbm_headroom_bytes")
        if isinstance(hbm, (int, float)):
            prev = task.hbm_prev.get(rank)
            task.hbm_prev[rank] = float(hbm)
            if (prev is not None and float(hbm) < prev * 0.95
                    and mgr.space.has("flat_resident")):
                mgr.weight_coordinate("flat_resident", 4.0)
                if not task.flat_primed:
                    task.flat_primed = True
                    mgr.prime({"flat_resident": "on"})

    def _apply_controller_hint(self, task: _TaskState, hint: dict) -> None:
        """Fleet-autopilot command hints (caller holds ``task.lock``).
        Ordinary hints (``autopilot_retune_hint``, the anomaly detector's
        ``step_time_anomaly``) need nothing here — arriving inside a
        sampling window already makes the state machine re-measure it.

        * ``autopilot_retune`` — a COMMANDED retune outranks the
          once-per-point re-measure budget (``sample_retried`` resets),
          and re-opens a completed search for a bounded number of extra
          samples: the escalation ladder's "retune" rung must still mean
          something after the BO loop pinned its best point.
        * ``autopilot_switch_family`` — pin the recommended algorithm
          family; every rank applies it at its next check-in through the
          NORMAL recommendation path (``_maybe_switch_algorithm`` — a
          re-jit plus a queued state migration, never a restart), and the
          per-train_iter decision cache keeps the switch SPMD-uniform.
        * ``autopilot_compress_dcn`` — the DCN-dominance trend hint:
          ACTUATE the wire-byte reduction by setting the recommended
          ``compress_inter`` codec policy — every rank applies it at its
          next check-in through the normal recommendation path (a re-jit
          with compressed cross-slice ring hops, kept SPMD-uniform by the
          per-train_iter decision cache) — and re-grant the once-per-point
          re-measure (the dominance evidence taints the current window's
          score).  The FAMILY named by the hint stays a suggestion (the
          BO loop keeps the last word on a family switch), but the codec
          flip is live: hierarchical collectives of the current family
          start carrying compressed DCN bytes without one.
        """
        kind = hint.get("kind")
        # a LIVE v2 search treats autopilot commands as priors, not pins:
        # the hint decides where the optimizer looks next (a primed point
        # plus coordinate weighting), the measured goodput decides whether
        # it sticks.  Legacy tasks and completed searches keep the direct
        # actuation — there is no live loop to absorb a prior.
        v2_live = task.manager.space is not None and not task.completed
        if kind == "autopilot_compress_dcn":
            task.sample_retried = False
            # codec was validated at ingest ("" = stripped as unknown)
            codec = str(hint.get("codec", "minmax_uint8"))
            if not codec:
                logger.warning(
                    "autotune[%s]: compress_dcn hint had no valid codec, "
                    "NOT actuated (re-measure still re-granted)",
                    task.model_name,
                )
            elif v2_live and task.manager.space.has("compress_inter"):
                task.manager.prime({
                    "compress_inter": codec,
                    "is_hierarchical_reduce": True,
                })
                share = hint.get("dcn_share")
                boost = (
                    2.0 + 6.0 * min(1.0, float(share))
                    if isinstance(share, (int, float)) else 4.0
                )
                task.manager.weight_coordinate("compress_inter", boost)
                logger.info(
                    "autotune[%s]: autopilot reports sustained DCN "
                    "dominance; primed DCN codec %r as a search prior "
                    "(goodput keeps the last word; re-measure re-granted)",
                    task.model_name, codec,
                )
            else:
                task.recommended.compress_inter = codec
                logger.info(
                    "autotune[%s]: autopilot reports sustained DCN "
                    "dominance; actuating DCN codec %r (suggested "
                    "compression family %r, re-measure re-granted)",
                    task.model_name, codec, hint.get("family"),
                )
        elif kind == "autopilot_retune":
            task.sample_retried = False
            if task.completed and task.extra_samples < 16:
                task.extra_samples += 4
                task.completed = False
                logger.info(
                    "autotune[%s]: autopilot retune re-opened the search "
                    "(+4 samples, %d extra total)", task.model_name,
                    task.extra_samples,
                )
        elif kind == "autopilot_switch_family":
            family = hint.get("family")
            if family and v2_live and task.manager.space.has("algorithm"):
                task.manager.prime({"algorithm": str(family)})
                task.manager.weight_coordinate("algorithm", 4.0)
                logger.info(
                    "autotune[%s]: autopilot suggested family %r; primed "
                    "as a search prior (goodput keeps the last word)",
                    task.model_name, family,
                )
            elif family:
                task.pinned_algorithm = str(family)
                task.recommended.algorithm = str(family)
                logger.info(
                    "autotune[%s]: autopilot pinned algorithm family %r",
                    task.model_name, family,
                )

    def report_tensor_execution_order(self, req: dict) -> dict:
        spans = req.get("spans", [])
        ordered = [
            s["tensor_name"]
            for s in sorted(spans, key=lambda s: s.get("start_time", 0))
            if s.get("tensor_name")
        ]
        task = self._task(req["model_name"]) if "model_name" in req else None
        if task is None:
            # reference route carries no model name; apply to every task
            with self._tasks_lock:
                tasks = list(self._tasks.values())
        else:
            tasks = [task]
        for t in tasks:
            with t.lock:
                t.manager.report_tensor_execution_order(ordered)
        return {"message": "ok"}

    def ask_hyperparameters(self, req: dict) -> dict:
        task = self._task(req["model_name"])
        rank = int(req["rank"])
        train_iter = int(req["train_iter"])
        now = time.time()
        with task.lock:
            task.iter_by_rank[rank] = train_iter
            if train_iter in task.decisions:
                return task.decisions[train_iter]
            reply = self._decide(task, train_iter, now)
            task.decisions[train_iter] = reply
            for it in sorted(task.decisions)[:-8]:  # bound the cache
                del task.decisions[it]
            return reply

    def _decide(self, task: _TaskState, train_iter: int, now: float) -> dict:
        """Compute the round's reply; caller holds ``task.lock``."""
        if task.first_ask_time is None:
            task.first_ask_time = now
            task.sample_start_time = now
        if self.autotune_level < 1 or task.completed:
            return self._reply(task)
        if now - task.first_ask_time < self.warmup_time_s:
            # hints landing during warmup describe windows that were never
            # going to be scored — absorb them, or the first real sampling
            # window would always burn its one re-measure on stale noise
            task.sample_hint_mark = task.perf_hints_total
            return self._reply(task)
        # confidence gate: the current point must have run long enough AND
        # every rank must have checked in past the point's start iteration,
        # so the summed speed reflects only the current config
        long_enough = (
            now - task.sample_start_time >= self.sampling_confidence_time_s
        )
        all_ranks_in = len(task.iter_by_rank) >= self.world_size and all(
            it > task.sample_start_iter for it in task.iter_by_rank.values()
        )
        if not (all_ranks_in and long_enough):
            return self._reply(task)
        # an anomaly-flagged window (rank-local detector flag riding the
        # obs payload) is discarded like a hint-tainted one: re-measure
        # once before scoring, then score honestly
        anomaly_flagged = any(
            bool(o.get("anomaly")) for o in task.obs_by_rank.values()
        )
        if (task.perf_hints_total > task.sample_hint_mark or anomaly_flagged) \
                and not task.sample_retried:
            # the window carried anomaly hints (a straggler, an injected
            # stall): its speed measures the environment, not the point —
            # re-measure once before scoring.  One retry only, so a
            # chronically noisy fleet still makes progress (the score is
            # then honest about its environment).
            logger.info(
                "autotune[%s]: %d perf hint(s) during the sample window — "
                "re-measuring this point before scoring",
                task.model_name,
                task.perf_hints_total - task.sample_hint_mark,
            )
            task.sample_hint_mark = task.perf_hints_total
            task.sample_retried = True
            task.sample_start_time = now
            task.sample_start_iter = train_iter
            return self._reply(task)
        score, scored_on_goodput = self._score(task)
        if task.goodput_mode is None:
            task.goodput_mode = scored_on_goodput
        usable = scored_on_goodput == task.goodput_mode
        if not usable and not task.sample_retried:
            # scale guard: the window's scoring mode disagrees with the
            # task's established one (obs coverage appeared or vanished
            # mid-search) — re-measure once before giving up on it
            logger.info(
                "autotune[%s]: window scored on %s but the search runs on "
                "%s — re-measuring before scoring",
                task.model_name,
                "goodput" if scored_on_goodput else "speed",
                "goodput" if task.goodput_mode else "speed",
            )
            task.sample_retried = True
            task.sample_start_time = now
            task.sample_start_iter = train_iter
            return self._reply(task)
        if usable:
            task.manager.record_sample(train_iter, task.recommended, score)
        else:
            logger.warning(
                "autotune[%s]: window still scored on the wrong scale "
                "after a re-measure — sample spent, observation discarded",
                task.model_name,
            )
        next_hp = task.manager.ask_hyperparameters(
            train_iter, task.tensor_list, task.recommended,
            score if usable else None,
        )
        task.n_samples += 1
        if task.n_samples >= self.max_samples + task.extra_samples:
            best = task.manager.best_hyperparameters(task.tensor_list)
            task.recommended = best if best is not None else task.recommended
            task.completed = True
            task.manager.close()
            logger.info(
                "autotune[%s] completed after %d samples (scored on %s): "
                "bucket=%d hier=%s algo=%s",
                task.model_name, task.n_samples,
                "fleet-min goodput" if scored_on_goodput else "summed speed",
                task.recommended.bucket_size,
                task.recommended.is_hierarchical_reduce,
                task.recommended.algorithm or "-",
            )
        else:
            task.recommended = next_hp
        task.sample_start_time = now
        task.sample_start_iter = train_iter
        task.sample_hint_mark = task.perf_hints_total
        task.sample_retried = False
        return self._reply(task)

    def _score(self, task: _TaskState) -> "tuple[float, bool]":
        """The sampling window's score (caller holds ``task.lock``).

        With every reporting rank carrying a goodput observation, the
        score is FLEET-MIN GOODPUT — the fleet is only as productive as
        its least productive rank (a config that compiles fast on seven
        ranks and churns on the eighth is a bad config) — with summed
        speed as a bounded tiebreak (< 1e-4, so it can never outvote a
        real goodput difference).  Compile churn is charged naturally:
        every re-jit the config causes lands in its own window's badput.
        Without full goodput coverage (obs plane off, old trainers) the
        legacy summed-speed score stands.
        """
        speed_sum = sum(task.speed_by_rank.values())
        goodputs = [
            o.get("goodput_fraction") for o in task.obs_by_rank.values()
        ]
        if (
            goodputs
            and len(task.obs_by_rank) >= len(task.speed_by_rank)
            and len(task.speed_by_rank) >= self.world_size
            and all(isinstance(g, (int, float)) for g in goodputs)
        ):
            tiebreak = 1e-4 * speed_sum / (1.0 + speed_sum)
            return min(float(g) for g in goodputs) + tiebreak, True
        return speed_sum, False

    def _reply(self, task: _TaskState) -> dict:
        if task.pinned_algorithm:
            # the autopilot's pin survives BO points and completion: every
            # reply carries it until a new pin replaces it
            task.recommended.algorithm = task.pinned_algorithm
        return {
            "recommended_hyperparameters": task.recommended.model_dump(),
            "is_autotune_completed": task.completed,
        }

    def health(self, req: dict) -> dict:
        return {"status": "ok"}


class _Handler(BaseHTTPRequestHandler):
    service: AutotuneService = None  # set by run_autotune_server

    ROUTES = {
        f"{API}/register_tensors": "register_tensors",
        f"{API}/report_metrics": "report_metrics",
        f"{API}/ask_hyperparameters": "ask_hyperparameters",
        f"{API}/report_tensor_execution_order": "report_tensor_execution_order",
        f"{API}/health": "health",
    }

    def log_message(self, fmt, *args):  # quiet
        logger.debug("autotune http: " + fmt, *args)

    def _respond(self, code: int, payload: dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == f"{API}/health":
            return self._respond(200, {"status": "ok"})
        self._respond(404, {"error": "not found"})

    def do_POST(self):
        handler_name = self.ROUTES.get(self.path)
        if handler_name is None:
            return self._respond(404, {"error": "not found"})
        length = int(self.headers.get("Content-Length", 0))
        try:
            req = json.loads(self.rfile.read(length) or b"{}")
            rsp = getattr(self.service, handler_name)(req)
            self._respond(200, rsp)
        except Exception as e:  # noqa: BLE001
            logger.exception("autotune route %s failed", self.path)
            self._respond(500, {"error": str(e)})


def make_server(port: int, service: AutotuneService) -> ThreadingHTTPServer:
    handler = type("BoundHandler", (_Handler,), {"service": service})
    return ThreadingHTTPServer(("0.0.0.0", port), handler)


def run_autotune_server(
    port: int,
    world_size: int,
    autotune_level: int = 1,
    max_samples: int = 60,
    sampling_confidence_time_s: float = 5.0,
    warmup_time_s: float = 30.0,
    is_output_autotune_log: bool = False,
    default_bucket_size: int = 10 * 1024 ** 2,
    tune_algorithm: bool = False,
) -> None:
    """Blocking server entry (run in a daemon process by
    :func:`bagua_tpu_torch.communication.start_autotune_server`)."""
    service = AutotuneService(
        world_size=world_size,
        autotune_level=autotune_level,
        max_samples=max_samples,
        sampling_confidence_time_s=sampling_confidence_time_s,
        warmup_time_s=warmup_time_s,
        is_output_autotune_log=is_output_autotune_log,
        default_bucket_size=default_bucket_size,
        tune_algorithm=tune_algorithm,
    )
    server = make_server(port, service)
    logger.info("autotune service listening on :%d", port)
    server.serve_forever()


class AutotuneClient:
    """HTTP client (reference autotune_service.py:302-384) on stdlib urllib."""

    def __init__(self, host: str, port: int, timeout_s: float = 10.0,
                 retries: int = 3):
        self.base = f"http://{host}:{port}{API}"
        self.timeout_s = timeout_s
        self.retries = retries

    def _post(self, route: str, payload: dict) -> dict:
        data = json.dumps(payload).encode()
        last_err = None
        for attempt in range(self.retries):
            try:
                req = request.Request(
                    f"{self.base}/{route}", data=data,
                    headers={"Content-Type": "application/json"},
                )
                with request.urlopen(req, timeout=self.timeout_s) as rsp:
                    return json.loads(rsp.read())
            except (error.URLError, OSError) as e:
                last_err = e
                time.sleep(0.2 * (attempt + 1))
        raise ConnectionError(f"autotune service unreachable: {last_err}")

    def health(self) -> bool:
        try:
            with request.urlopen(f"{self.base}/health", timeout=self.timeout_s):
                return True
        except (error.URLError, OSError):
            return False

    def wait_until_ready(self, timeout_s: float = 30.0) -> None:
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            if self.health():
                return
            time.sleep(0.1)
        raise TimeoutError("autotune service did not come up")

    def register_tensors(
        self, model_name: str, tensor_list: List[dict],
        capabilities: Optional[dict] = None,
    ) -> dict:
        payload = {"model_name": model_name, "tensor_list": tensor_list}
        if capabilities:
            # v2: what the trainer's mesh/family/layout makes legal —
            # selects the capability-gated knob space service-side
            payload["capabilities"] = capabilities
        return self._post("register_tensors", payload)

    def report_metrics(
        self, model_name: str, rank: int, train_iter: int,
        hyperparameters: dict, speed: float,
        perf_hints: Optional[List[dict]] = None,
        obs: Optional[dict] = None,
    ) -> dict:
        payload = {
            "model_name": model_name, "rank": rank,
            "train_iter": train_iter,
            "hyperparameters": hyperparameters, "speed": speed,
        }
        if perf_hints:
            # anomaly-detector hints (bagua_tpu_torch.obs.anomaly): the sampling
            # state machine re-measures a window these taint
            payload["perf_hints"] = perf_hints
        if obs:
            # windowed efficiency observations (goodput_fraction, mfu,
            # dcn share, hbm headroom): the v2 scoring + trend input
            payload["obs"] = obs
        return self._post("report_metrics", payload)

    def ask_hyperparameters(self, model_name: str, rank: int, train_iter: int) -> dict:
        return self._post(
            "ask_hyperparameters",
            {"model_name": model_name, "rank": rank, "train_iter": train_iter},
        )

    def report_tensor_execution_order(
        self, spans: List[dict], model_name: Optional[str] = None
    ) -> dict:
        payload = {"spans": spans}
        if model_name is not None:
            payload["model_name"] = model_name
        return self._post("report_tensor_execution_order", payload)
