"""Typed environment readers and process topology.

Port of ``bagua_tpu/env.py``'s part the port reads: the registry of
declared ``BAGUA_*`` variables with typed ``env_str``/``env_int``/``env_bool``
readers, the default bucket size, the overlap scheduler's gate and its ring
chunk targets (and their cap), the per-link codec policy, the stateful
codecs' knobs (top-k ratio, error-feedback residual), the flat-resident
layout, the gradient-health guard, async model average's staleness cap, the
fault-injection plan, the checkpoint storage quarantine, the hang watchdog's
timeout, the launcher's rendezvous, the elastic membership block and the
restart store's failover knobs, the autotune sidecar, the observability
plane (the HTTP status plane and the historian included), the fleet
autopilot, the profiler's window, the serving engine, the lockdep
witness and the pod simulator (same names,
defaults and meanings as ``bagua_tpu/env.py``), and rank / world size /
local rank / local world size.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class EnvVar:
    name: str
    type: str
    default: str
    doc: str
    choices: Tuple[str, ...] = ()


ENV_REGISTRY: Dict[str, EnvVar] = {}


def _declare(name: str, type: str, default: str, doc: str,
             choices: Tuple[str, ...] = ()) -> None:
    ENV_REGISTRY[name] = EnvVar(name, type, default, doc, choices)


_declare("BAGUA_DEFAULT_BUCKET_SIZE", "int", str(10 * 1024 ** 2),
         "Default communication bucket size in bytes (reference env.py:50-57).")
_declare("BAGUA_OVERLAP", "enum", "auto",
         "Overlap scheduler: launch each bucket's gradient collective from the "
         "backward, on a comm stream, as the bucket's gradient finalizes "
         "(`on`), keep the serialized step (`off`), or overlap where the "
         "family's measured record says so and there is something to "
         "overlap (`auto`: accumulation, or a ring chunk target set).",
         choices=("auto", "on", "off"))
_declare("BAGUA_OVERLAP_CHUNK_BYTES", "int", "0",
         "Target bytes a rank of one independent ring sub-collective under the "
         "overlap scheduler; 0 keeps one collective a bucket.")
_declare("BAGUA_OVERLAP_CHUNK_BYTES_INTRA", "int", "0",
         "Ring chunk target of the intra-node tier of the two-level "
         "collectives (and of the flat ring); 0 falls back to "
         "BAGUA_OVERLAP_CHUNK_BYTES.")
_declare("BAGUA_OVERLAP_CHUNK_BYTES_INTER", "int", "0",
         "Ring chunk target of the inter-node tier of the two-level "
         "collectives (size it above the intra-node one: a chunk that "
         "amortizes a fast hop is too small for a slow one); 0 falls back "
         "to BAGUA_OVERLAP_CHUNK_BYTES.")
_declare("BAGUA_MAX_RING_CHUNKS", "int", "32",
         "Cap on the independent sub-collectives of one chunked ring "
         "collective (each is 2(n-1) point-to-point hops a bucket).")
_declare("BAGUA_COMPRESS_INTRA", "str", "auto",
         "Per-link codec policy of the intra-node tier and the flat ring: "
         "`auto` (default) keeps it full precision; `off` forces full "
         "precision; a codec name "
         "(minmax_uint8|int8|fp8_e4m3|fp8_e5m2|onebit_ef|topk) makes the "
         "ring hops carry that codec's payload.")
_declare("BAGUA_COMPRESS_INTER", "str", "auto",
         "Per-link codec policy of the inter-node tier of the hierarchical "
         "collectives: `auto` (default) defers to the algorithm family "
         "(ByteGrad and QAdam compress it natively, the exact families keep "
         "it full precision), `off` forces full precision, a codec name "
         "(minmax_uint8|int8|fp8_e4m3|fp8_e5m2|onebit_ef|topk) compresses "
         "the inter-node ring hops for every family.")
_declare("BAGUA_TOPK_RATIO", "float", "0.01",
         "Fraction of each chunk's elements the `topk` ring codec keeps on "
         "the wire (int32 indices and f32 values; 0.01 keeps the top 1% by "
         "magnitude).  Read when the codec is looked up, so a value set "
         "before the trainer is built takes effect.")
_declare("BAGUA_EF_RESIDUAL", "enum", "on",
         "Error-feedback residual of the stateful ring codecs "
         "(onebit_ef|topk): `on` (default) carries each bucket's "
         "quantization error into the next step's gradient; `off` lets the "
         "codec ride without it (biased sign or sparse SGD, a convergence "
         "control).  Set before the trainer is built.", choices=("on", "off"))

_declare("BAGUA_FLAT_RESIDENT", "enum", "auto",
         "Flat-resident training state: keep params/grads/optimizer state "
         "as bucket-flat buffers across steps (`on`), keep the per-parameter "
         "layout (`off`), or engage it wherever the algorithm family "
         "supports it and the optimizer is elementwise (`auto`).",
         choices=("auto", "on", "off"))
_declare("BAGUA_GRAD_GUARD", "enum", "off",
         "Gradient-health sentinel policy: per-bucket isfinite checks on "
         "every step's gradients.  `warn` logs unhealthy steps, `skip` "
         "rewinds them (params/optimizer state untouched) and escalates to "
         "abort after a consecutive-skip budget, `abort` raises the comm "
         "abort flag on the first unhealthy step.",
         choices=("off", "warn", "skip", "abort"))
_declare("BAGUA_FAULT_PLAN", "str", "",
         "Deterministic fault-injection plan (JSON list of specs: point, "
         "kind, step/op trigger, count, seed) armed at the first fault-point "
         "query; drills and tests only, never production.  The port reaches "
         "every point of the JAX package, podsim.link (the pod simulator's "
         "shaped links) included.  See bagua_tpu_torch.faults.inject.")
_declare("BAGUA_CKPT_QUARANTINED_PATHS", "str", "",
         "Newline-separated checkpoint directories under storage "
         "quarantine (newline, not os.pathsep — ':' appears inside "
         "gs://-style URIs): BaguaCheckpointManager redirects saves for "
         "them to a `<dir>.redirect` sibling while restores keep walking "
         "the verified pre-quarantine history.")
_declare("BAGUA_ASYNC_MAX_STALENESS", "int", "4",
         "Bounded-staleness cap of async model average: when any rank's "
         "applied-round count reaches this many rounds behind the launched "
         "count (async.partition drops stall it), that negotiated boundary "
         "forces a synchronous catch-up average that leaves every rank's "
         "weights bitwise equal, so the lag never exceeds the cap.  0 "
         "disables the bound.")

_declare("BAGUA_COORDINATOR_ADDR", "str", "",
         "host:port of the rendezvous of a multi-process world (injected by "
         "the launcher; consumed by `init_process_group`).")
_declare("BAGUA_COMM_TIMEOUT_S", "str", "300",
         "Hang-watchdog timeout of watched collectives and steps, in seconds; "
         "``0``/``off``/``false``/``no``/``none``/empty disable the watchdog.")
# -- elastic membership (injected by the launcher, see distributed/run.py) --
_declare("BAGUA_ELASTIC", "bool", "0",
         "Set by the launcher when lease-based elastic membership is on.")
_declare("BAGUA_ELASTIC_EPOCH", "int", "0",
         "Rendezvous epoch fencing counter (launcher-injected).")
_declare("BAGUA_ELASTIC_NODE_ID", "int", "0",
         "This node's stable identity slot (launcher-injected).")
_declare("BAGUA_ELASTIC_STORE_ADDR", "str", "",
         "host:port of the restart TCPStore carrying membership leases.")
_declare("BAGUA_ELASTIC_MIN_NNODES", "int", "1",
         "Lower bound of the elastic world size (launcher-injected).")
_declare("BAGUA_ELASTIC_MAX_NNODES", "int", "",
         "Upper bound of the elastic world size (launcher-injected); "
         "defaults to the launched node count when unset.")
_declare("BAGUA_ELASTIC_JOIN_WINDOW_S", "float", "30",
         "Seconds a rendezvous round stays open for late joiners.")
_declare("BAGUA_ELASTIC_LEASE_TTL_S", "float", "15",
         "Membership lease TTL; an expired lease shrinks the world.")
_declare("BAGUA_ELASTIC_TELEMETRY_OUT", "str", "",
         "Path where membership counters + transitions are dumped on exit.")
_declare("BAGUA_ELASTIC_HEALTH_FILE", "str", "",
         "Path of this worker's health beacon file (launcher-injected, one "
         "file per local rank): the worker's gradient-guard / "
         "async-staleness event counters are published here; the launcher "
         "merges all local beacons and carries them on its lease heartbeat "
         "to the coordinator as a health payload.")
_declare("BAGUA_ELASTIC_FENCE_UNHEALTHY", "int", "0",
         "Coordinator-side health fence: expel a member whose heartbeat "
         "health payload reports at least this many unhealthy events "
         "(non-finite-gradient steps, missed async negotiation "
         "boundaries).  The fenced node's launcher exits instead of "
         "rejoining; survivors resize through the normal epoch machinery.  "
         "0 (default) disables fencing.")
# -- restart-store replication / coordinator failover --
_declare("BAGUA_RESTART_STORE_ENDPOINTS", "str", "",
         "Comma-separated ``host:port`` list (priority order) of replicated "
         "restart-store endpoints.  Entry 0 is the initial primary; later "
         "entries are standby followers the primary streams its op log to, "
         "and the clients fail over to (promoting the first reachable one) "
         "when the primary dies.  Empty = the single coordinator-hosted "
         "store.")
_declare("BAGUA_RESTART_STORE_OP_DEADLINE_S", "float", "45",
         "Total retry budget (seconds) for one restart-store op across "
         "reconnects and endpoint failovers; exhausting it raises instead "
         "of retrying forever inside watchdog sections.  0 disables the "
         "budget.")
_declare("BAGUA_RESTART_COORD_LEASE_TTL_S", "float", "5",
         "Coordinator leadership lease TTL: the active coordinator renews "
         "a lease key in the (replicated) restart store at TTL/3; a "
         "standby that sees no renewal for a full TTL on its own clock "
         "promotes the store and takes the coordinator role over.")
_declare("BAGUA_RESTART_TAKEOVER_GRACE_S", "float", "0",
         "Grace window after a coordinator takeover during which member "
         "leases are re-armed rather than expired (heartbeats queued "
         "against the dead primary need time to drain to the promoted "
         "store).  0 = auto: 2x BAGUA_ELASTIC_LEASE_TTL_S.")
# -- profiling --
_declare("BAGUA_PROFILE_DIR", "str", "",
         "Directory for torch.profiler traces (Chrome JSON); empty disables "
         "auto-capture.")
_declare("BAGUA_PROFILE_STEPS", "str", "2:5",
         "``start:stop`` step window (half-open) for trainer auto-capture.")
# -- observability plane --
_declare("BAGUA_OBS", "enum", "on",
         "Unified observability plane master switch: step-span tracing, the "
         "crash flight recorder, and the metrics exporter.  Host-side only "
         "— the plane adds no device synchronization to the step and the "
         "parameters are bitwise equal in both modes; `off` restores the "
         "exact pre-obs host behavior.",
         choices=("on", "off"))
_declare("BAGUA_OBS_RING", "int", "512",
         "Span ring-buffer capacity per process; the oldest spans drop "
         "(drop count retained) so long runs keep a bounded, readable "
         "tail for the flight recorder.")
_declare("BAGUA_OBS_DUMP_DIR", "str", "",
         "Directory for flight-recorder post-mortem dumps (watchdog abort, "
         "grad-guard escalation, health fence, armed-fault fires, SIGTERM): "
         "last-N spans + counters snapshot + step metrics, rank-tagged "
         "JSON.  Empty disables the recorder.")
_declare("BAGUA_OBS_EXPORT_DIR", "str", "",
         "Directory the background metrics exporter writes into "
         "(`metrics.jsonl` one snapshot per line + `metrics.prom` "
         "Prometheus textfile).  Empty disables the exporter thread.")
_declare("BAGUA_OBS_EXPORT_INTERVAL_S", "float", "10",
         "Metrics exporter snapshot period in seconds.")
_declare("BAGUA_OBS_EXPORT_MAX_BYTES", "int", str(64 * 1024 ** 2),
         "Size cap for the exporter's append-only `metrics.jsonl`: at the "
         "cap the file rotates to `metrics.jsonl.1` (replacing the "
         "previous rotation) so a long run keeps at most two generations "
         "on disk.  0 disables rotation (unbounded growth).")
_declare("BAGUA_OBS_FLEET_OUT", "str", "",
         "Coordinator-side fleet snapshot path: the elastic monitor merges "
         "every member's heartbeat health payload (per-rank step, "
         "staleness, skip counts, step-dt percentiles) into one atomic "
         "JSON.  Empty disables.")
_declare("BAGUA_OBS_ANOMALY", "enum", "on",
         "Step-time anomaly detector: rolling median/MAD baseline over "
         "the raw host step cadence and per-phase durations; anomalies "
         "count (`obs/step_anomalies`), trigger a throttled flight dump, "
         "publish a `straggler_suspect` phase breakdown into the health "
         "beacon, and feed perf hints to the autotune service.  Host-side "
         "only (no effect on the compiled step); rides the BAGUA_OBS "
         "master switch.",
         choices=("on", "off"))
_declare("BAGUA_OBS_ANOMALY_WINDOW", "int", "64",
         "Rolling-baseline window (steps) of the step-time anomaly "
         "detector.")
_declare("BAGUA_OBS_ANOMALY_WARMUP", "int", "16",
         "Baseline samples required before the anomaly detector may flag "
         "(compile steps and cold caches must not poison the yardstick).")
_declare("BAGUA_OBS_ANOMALY_THRESHOLD", "float", "5.0",
         "Robust-z threshold (MAD multiples) a step's raw cadence must "
         "exceed over the rolling median to count as anomalous.")
_declare("BAGUA_OBS_DUMP_MAX_FILES", "int", "64",
         "Retention cap for flight-recorder dumps under "
         "BAGUA_OBS_DUMP_DIR: when a new dump would leave more than this "
         "many flight_*.json files, the oldest (by mtime) are pruned "
         "first (counted in obs/flight_dumps_pruned).  Dumps are already "
         "overwritten per (trigger, fault point, rank, pid), so growth "
         "comes from restarts minting new pids — a long run with "
         "recurring throttled faults previously accumulated dumps "
         "without limit.  0 disables pruning (unbounded).")
# -- static analysis (bagua_tpu_torch.analysis) --
_declare("BAGUA_LOCKDEP", "enum", "off",
         "Runtime lockdep witness (bagua_tpu_torch.analysis.lockdep): `on` "
         "wraps every lock the package creates so real acquisition orders "
         "are recorded and opposite-order pairs (live deadlock windows) "
         "are detected; the witness JSON is cross-checked against the "
         "static concurrency engine's graph (`python -m "
         "bagua_tpu_torch.analysis --witness`).  Diagnostics only: adds "
         "bookkeeping to every acquisition, keep `off` in production.",
         choices=("off", "on"))
_declare("BAGUA_LOCKDEP_OUT", "str", "",
         "Output path for the lockdep witness JSON (edges, inversions, "
         "per-site acquisition counts), written at process exit.  Empty "
         "falls back to ./bagua_lockdep_witness.json.")
# -- pod simulator (bagua_tpu_torch.podsim) --
_declare("BAGUA_SCALE_RANKS", "str", "32,64,128",
         "Comma-separated world sizes of the pod simulator's drill: the "
         "first runs the end-to-end scenario (shaped collectives, elastic "
         "shrink and regrow, autopilot fence; "
         "bagua_tpu_torch.podsim.orchestrator.full_scenario).")
_declare("BAGUA_SCALE_SHAPE", "str", "pod",
         "Link-shape model for the pod simulator's data plane: a preset "
         "name (off|pod|wan) or a JSON ShapeSpec object, per-class "
         "latency/bandwidth/jitter of the intra- and inter-node links.  See "
         "bagua_tpu_torch.podsim.shaping.SHAPE_PRESETS.")
_declare("BAGUA_SCALE_SEED", "int", "0",
         "Determinism seed for the pod simulator: the shaped links' jitter "
         "hash and the drill's per-rank vectors both derive from it, so two "
         "runs at one seed inject identical network time.")
_declare("BAGUA_SCALE_DCN_CODEC", "str", "minmax_uint8",
         "Wire codec for the pod simulator's inter-node ring "
         "(f32|minmax_uint8|onebit_ef|topk): its numpy wire model "
         "(bagua_tpu_torch.podsim.collectives), checked within its "
         "quantization tolerance.")
# -- serving plane --
_declare("BAGUA_SERVE_MAX_SLOTS", "int", "8",
         "Batch slots of the continuous-batching inference engine: the "
         "batch dimension of the decode tick.  Requests join/evict "
         "mid-batch without changing the tick's shape; more slots raise "
         "throughput at the cost of per-tick latency and pool pressure.")
_declare("BAGUA_SERVE_PAGE_SIZE", "int", "16",
         "Tokens per KV-cache page of the serving engine's paged pool; "
         "must divide the model's max_seq_len.  Smaller pages waste less "
         "memory on short tails, larger pages gather more contiguously.")
_declare("BAGUA_SERVE_NUM_PAGES", "int", "0",
         "Page-pool capacity per layer (including the 2 reserved "
         "zero/trash pages).  0 (default) auto-sizes to max_slots full-"
         "length sequences — no preemption pressure; set lower to "
         "oversubscribe HBM and rely on the queue-then-preempt "
         "backpressure instead.")
_declare("BAGUA_SERVE_QUEUE_DEPTH", "int", "256",
         "Admission-queue depth of the serving engine; submissions beyond "
         "it raise ServeQueueFull (explicit shed/retry backpressure, "
         "never an OOM).")
_declare("BAGUA_SERVE_PREFILL_CHUNK", "int", "8",
         "Prompt tokens one chunked-prefill call consumes for a single "
         "slot (at most one such call per scheduler tick, so long prompts "
         "cannot stall running decodes); 1 disables the chunked program — "
         "prompts then stream through the batched tick one token per "
         "tick, generate()-style.")
_declare("BAGUA_SERVE_TICK_IDLE_S", "float", "0.001",
         "Scheduler idle-poll granularity in seconds: how long one wait "
         "slice lasts while the engine is empty and ahead of the next "
         "trace arrival (the wall it books as batch_formation_idle).")
# -- autotune sidecar --
_declare("BAGUA_SERVICE_PORT", "int", "-1",
         "Port of the autotune hyperparameter service; -1 disables.")
_declare("BAGUA_AUTOTUNE", "int", "0",
         "Autotune level: 0 off, 1 bucket-size search, 2 adds the "
         "tensor-readiness telemetry pipeline.")
_declare("BAGUA_AUTOTUNE_MAX_SAMPLES", "int", "60",
         "Max hyperparameter samples the Bayesian optimizer may score.")
_declare("BAGUA_AUTOTUNE_SAMPLING_CONFIDENCE_TIME_S", "float", "5.0",
         "Seconds of speed samples per hyperparameter config before scoring.")
_declare("BAGUA_AUTOTUNE_WARMUP_TIME_S", "float", "30.0",
         "Warmup seconds before the autotuner starts scoring configs.")
_declare("BAGUA_AUTOTUNE_ALGORITHM", "bool", "0",
         "Let the autotuner search over algorithm families too "
         "(centralized / low-precision selectable).")
_declare("BAGUA_AUTOTUNE_GOODPUT", "bool", "1",
         "Score autotune sampling windows on fleet-min goodput (windowed "
         "goodput_fraction/MFU/DCN-share observations ride each check-in "
         "when the obs plane is on); 0 reports no observations, falling "
         "back to the summed-speed score.")
_declare("BAGUA_AUTOTUNE_SPACE", "str", "auto",
         "Autotune search space: 'auto' reports trainer capabilities at "
         "registration so the service searches the full capability-gated "
         "v2 knob space (overlap + per-tier chunk bytes, codec ladder, "
         "flat residency, family switching); 'legacy' keeps the "
         "bucket-size x hierarchical two-knob space.")
_declare("BAGUA_REPORT_METRICS", "bool", "0",
         "Report training metrics to the autotune service.")
_declare("BAGUA_IS_OUTPUT_AUTOTUNE_LOG", "bool", "0",
         "Write the autotune search log to disk.")
# -- HTTP status plane and historian --
_declare("BAGUA_OBS_HTTP_PORT", "int", "0",
         "Port of the per-process HTTP status plane "
         "(bagua_tpu_torch.obs.http): `/metrics` serves the SAME Prometheus "
         "text the exporter writes to metrics.prom, `/healthz` liveness, "
         "`/ledger` the goodput report; the elastic coordinator "
         "additionally serves `/fleet` (latest bagua-obs-fleet-v1 "
         "snapshot) and `/history?metric=&window=` (historian windows).  "
         "0 (default) disables the server; a taken port falls back to an "
         "ephemeral one (logged, and published as the obs/http_port "
         "gauge).  The elastic launcher offsets each local worker's port "
         "(base + 1 + local_rank) so one host's processes never collide.")
_declare("BAGUA_OBS_HTTP_ADDR", "str", "127.0.0.1",
         "Bind address of the HTTP status plane.  The default stays on "
         "loopback — expose it beyond the host deliberately (0.0.0.0) "
         "only where the network is trusted; the endpoints are "
         "read-only but unauthenticated.")
_declare("BAGUA_OBS_HISTORIAN", "enum", "off",
         "Coordinator-side fleet telemetry historian "
         "(bagua_tpu_torch.obs.historian): bounded per-rank per-metric "
         "time-series rings fed by the beacon->heartbeat obs summaries "
         "in every fleet snapshot, with windowed rate/percentile/"
         "least-squares-slope queries.  Publishes derived trend gauges "
         "(obs/goodput_slope, obs/hbm_headroom_slope, "
         "obs/dcn_comm_share) back into the snapshot — the evidence the "
         "autopilot's trend rules (pre-OOM resize, DCN compression "
         "escalation) consume — and persists its rings through the "
         "restart TCPStore so a relaunched coordinator keeps history.",
         choices=("off", "on"))
_declare("BAGUA_OBS_HISTORIAN_CAPACITY", "int", "512",
         "Samples retained per (rank, metric) historian ring; the oldest "
         "drop first.  At the default ~1/s monitor cadence this is ~8.5 "
         "minutes of full-rate history per series (slower snapshot "
         "writers keep proportionally longer windows).")
_declare("BAGUA_OBS_HISTORIAN_WINDOW_S", "float", "600",
         "Trend window in seconds: slopes, percentiles, and the DCN "
         "comm share are computed over the trailing window of this "
         "length (the `sustained` horizon behind obs/goodput_slope and "
         "friends; /history defaults to it too).")
# -- fleet autopilot --
_declare("BAGUA_AUTOPILOT", "enum", "off",
         "Closed-loop fleet autopilot: the coordinator-side policy engine "
         "over the fleet snapshot stream.  `off` (default) never "
         "constructs the engine — coordinator behavior and the compiled "
         "step are exactly the pre-autopilot ones; `observe` runs the full "
         "decision matrix and flight-records every decision WITHOUT "
         "actuating (the dry-run rollout mode); `act` additionally "
         "actuates through the existing machinery (health fence/resize, "
         "autotune perf hints, algorithm-family switch, checkpoint "
         "storage quarantine).",
         choices=("off", "observe", "act"))
_declare("BAGUA_AUTOPILOT_SLO_GOODPUT", "float", "0",
         "Goodput-fraction SLO for the autopilot's escalation ladder: a "
         "fleet whose worst rank sits below this fraction for "
         "BAGUA_AUTOPILOT_SUSTAIN consecutive snapshots walks hint -> "
         "retune -> algorithm-family switch -> resize.  0 (default) "
         "disables the SLO rule.")
_declare("BAGUA_AUTOPILOT_SUSTAIN", "int", "3",
         "Hysteresis: consecutive fleet snapshots a rule's condition must "
         "hold before its action fires (one blip never actuates).")
_declare("BAGUA_AUTOPILOT_COOLDOWN_S", "float", "300",
         "Per-action-kind cooldown: after an autopilot action of a kind "
         "fires, further actions of that kind are suppressed for this "
         "many seconds (counted in autopilot/suppressed_cooldown).")
_declare("BAGUA_AUTOPILOT_BUDGET", "int", "8",
         "Global action budget per run: once the autopilot has taken this "
         "many actions it stops actuating entirely (counted in "
         "autopilot/suppressed_budget) — a mis-tuned policy can never "
         "flap a fleet indefinitely.  0 disables the autopilot's actions.")
_declare("BAGUA_AUTOPILOT_STALENESS_S", "float", "60",
         "Fleet-snapshot freshness bound: the policy engine refuses to "
         "decide on a snapshot older than this (a wedged snapshot writer "
         "must not cause actions from stale evidence; counted in "
         "autopilot/stale_snapshots).")
_declare("BAGUA_AUTOPILOT_STRAGGLER_RATIO", "float", "3.0",
         "Minimum straggler_suspect step-time ratio for the autopilot's "
         "chronic-straggler / victim rules to count a snapshot toward "
         "their sustain streak (blips below it are the anomaly "
         "detector's business, not the autopilot's).")
_declare("BAGUA_AUTOPILOT_SUSPECT_TTL_S", "float", "120",
         "How long a straggler_suspect stays live evidence: a suspect "
         "detected longer ago than this no longer feeds the straggler/"
         "victim streaks (the beacon keeps re-publishing the LATEST "
         "suspect even after the rank recovers).")
_declare("BAGUA_AUTOPILOT_CKPT_FAILURES", "int", "3",
         "Checkpoint-integrity threshold: a rank reporting at least this "
         "many integrity failures + fallback restores gets its storage "
         "path quarantined (saves redirect; see docs/autopilot.md).")
_declare("BAGUA_AUTOPILOT_FAMILY", "str", "async",
         "Algorithm family the escalation ladder's switch rung commands "
         "(through the autotune service's recommendation path; must be a "
         "SWITCHABLE_ALGORITHMS name).")
_declare("BAGUA_AUTOPILOT_MODEL", "str", "bagua_module",
         "Autotune task (model_name) the autopilot's perf hints and "
         "family-switch commands address — the BaguaTrainer model_name "
         "default unless the job names its model.")
_declare("BAGUA_AUTOPILOT_DCN_SHARE", "float", "0.5",
         "DCN-dominance threshold for the autopilot's trend rule: when "
         "the historian's obs/dcn_comm_share (windowed mean DCN device "
         "seconds over windowed mean step time) sits at or above this "
         "fraction for BAGUA_AUTOPILOT_SUSTAIN snapshots, the autopilot "
         "emits a compression-family escalation hint — compress the slow "
         "tier (docs/hierarchical.md).  Requires the historian "
         "(BAGUA_OBS_HISTORIAN=on): without trend windows the rule never "
         "fires.  0 disables the rule.")
_declare("BAGUA_AUTOPILOT_COMPRESS_FAMILY", "str", "bytegrad",
         "Compression algorithm family the DCN-dominance hint names "
         "(its hierarchical path compresses only the cross-slice DCN "
         "stage; delivered as an autotune perf hint, never a forced "
         "switch).")
_declare("BAGUA_AUTOPILOT_COMPRESS_CODEC", "str", "minmax_uint8",
         "DCN wire codec the autopilot's compress_dcn hint ACTUATES: the "
         "autotune service applies it to the recommended "
         "`compress_inter` policy, so every rank's next check-in re-jits "
         "its hierarchical collectives with compressed cross-slice ring "
         "hops (minmax_uint8|int8|fp8_e4m3|fp8_e5m2; "
         "docs/compression.md).")
_declare("BAGUA_AUTOPILOT_HBM_HORIZON_S", "float", "600",
         "Pre-OOM horizon for the autopilot's HBM trend rule: when a "
         "rank's historian headroom slope (obs/hbm_headroom_slope) is "
         "negative and projects exhaustion within this many seconds "
         "(headroom / -slope), sustained BAGUA_AUTOPILOT_SUSTAIN "
         "snapshots, the autopilot resizes that node away BEFORE the "
         "OOM kills the gang mid-collective.  Requires the historian; "
         "0 disables the rule.")


def _raw(name: str) -> Optional[str]:
    """The ambient value of a declared variable (unset or '' -> None)."""
    if name not in ENV_REGISTRY:
        raise KeyError(f"{name} is not declared in env.ENV_REGISTRY")
    v = os.environ.get(name)
    return None if v in (None, "") else v


def env_str(name: str) -> str:
    v = _raw(name)
    return ENV_REGISTRY[name].default if v is None else v


def env_int(name: str) -> int:
    v = _raw(name)
    if v is None:
        return int(ENV_REGISTRY[name].default)
    try:
        return int(v)
    except ValueError:
        raise ValueError(f"{name} must be an integer, got {v!r}") from None


def env_float(name: str) -> float:
    v = _raw(name)
    if v is None:
        return float(ENV_REGISTRY[name].default)
    try:
        return float(v)
    except ValueError:
        raise ValueError(f"{name} must be a number, got {v!r}") from None


def env_enum(name: str) -> str:
    """The value, lower-cased, checked against the variable's choices."""
    v = env_str(name).strip().lower() or ENV_REGISTRY[name].default
    choices = ENV_REGISTRY[name].choices
    if choices and v not in choices:
        raise ValueError(f"{name} must be {'|'.join(choices)}, got {v!r}")
    return v


def env_bool(name: str) -> bool:
    """``"1"`` is on, anything else off, except for variables whose default
    is on, where only ``"0"`` turns them off."""
    v = _raw(name)
    spec = ENV_REGISTRY[name]
    if v is None:
        return spec.default == "1"
    return v != "0" if spec.default == "1" else v == "1"


#: values that read as "disabled" for off-switchable durations
#: (:func:`env_seconds_or_off`); the empty string counts too
_OFF_VALUES = ("", "0", "off", "false", "no", "none")


def env_seconds_or_off(name: str) -> Optional[float]:
    """Float seconds with an off switch: ``0``/``off``/``false``/``no``/
    ``none``/empty mean disabled (None).  An explicitly empty value is off:
    only an unset variable falls back to the registry default (collapsing
    ``""`` to the default would silently turn the watchdog back on)."""
    if name not in ENV_REGISTRY:
        raise KeyError(f"{name} is not declared in env.ENV_REGISTRY")
    v = os.environ.get(name)
    if v is None:
        v = ENV_REGISTRY[name].default
    if v.strip().lower() in _OFF_VALUES:
        return None
    try:
        return float(v)
    except ValueError:
        raise ValueError(
            f"{name} must be a number of seconds or one of "
            f"{'/'.join(repr(x) for x in _OFF_VALUES)}, got {v!r}") from None

def _int_env(name: str, default: int) -> int:
    """Unregistered int read (the launcher's RANK / WORLD_SIZE family)."""
    v = os.environ.get(name)
    if v in (None, ""):
        return default
    try:
        return int(v)
    except ValueError:
        raise ValueError(
            f"environment variable {name} must be an integer, got {v!r}"
        ) from None


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def get_rank() -> int:
    """Global rank: the process group's once it exists, else ``RANK``."""
    dist = _dist()
    return dist.get_rank() if dist else _int_env("RANK", 0)


def get_world_size() -> int:
    """Number of ranks: the process group's once it exists, else
    ``WORLD_SIZE``."""
    dist = _dist()
    return dist.get_world_size() if dist else _int_env("WORLD_SIZE", 1)


def get_local_rank() -> int:
    return _int_env("LOCAL_RANK", 0)


def get_local_size() -> int:
    """Ranks per node from ``LOCAL_WORLD_SIZE``, 1 when unset (the JAX
    package's ``get_local_size``)."""
    return _int_env("LOCAL_WORLD_SIZE", 1)


def get_node_rank() -> int:
    """This node's rank: ``NODE_RANK``, else the global rank over the ranks
    a node."""
    return _int_env("NODE_RANK", get_rank() // max(get_local_size(), 1))


def get_master_addr() -> str:
    return os.environ.get("MASTER_ADDR", "127.0.0.1")


def get_local_world_size() -> Optional[int]:
    """Ranks per node from ``LOCAL_WORLD_SIZE`` (the launcher's), or None
    when unset: the default intra-node group size."""
    v = _int_env("LOCAL_WORLD_SIZE", 0)
    return v if v > 0 else None


def get_default_bucket_size() -> int:
    """Default bucket size in bytes; 10 MiB like the reference."""
    return env_int("BAGUA_DEFAULT_BUCKET_SIZE")


def get_overlap_mode() -> str:
    """Overlap scheduler gate: ``auto`` (default), ``on`` or ``off``."""
    return env_enum("BAGUA_OVERLAP")


def get_overlap_chunk_bytes() -> int:
    """Target bytes a rank of one ring sub-collective under the overlap
    scheduler; 0 (default) keeps one collective a bucket."""
    return env_int("BAGUA_OVERLAP_CHUNK_BYTES")


def get_overlap_chunk_bytes_intra() -> int:
    """Ring chunk target of the intra-node tier and the flat ring; 0
    (default) falls back to :func:`get_overlap_chunk_bytes`."""
    return env_int("BAGUA_OVERLAP_CHUNK_BYTES_INTRA")


def get_overlap_chunk_bytes_inter() -> int:
    """Ring chunk target of the inter-node tier; 0 (default) falls back to
    :func:`get_overlap_chunk_bytes`."""
    return env_int("BAGUA_OVERLAP_CHUNK_BYTES_INTER")


def get_max_ring_chunks() -> int:
    """Cap on a chunked ring's sub-collectives (default 32)."""
    return env_int("BAGUA_MAX_RING_CHUNKS")


def get_compress_intra() -> str:
    """Codec policy of the fast tier and the flat ring (``auto``; validated
    by :func:`bagua_tpu_torch.compression.codecs.validate_codec_policy`)."""
    return env_str("BAGUA_COMPRESS_INTRA")


def get_compress_inter() -> str:
    """Codec policy of the inter-node tier (``auto``: the family's own)."""
    return env_str("BAGUA_COMPRESS_INTER")


def get_topk_ratio() -> float:
    """Fraction of each chunk the ``topk`` codec keeps (default 0.01); read
    each time the codec is looked up."""
    return env_float("BAGUA_TOPK_RATIO")


def is_ef_residual_disabled() -> bool:
    """True when ``BAGUA_EF_RESIDUAL=off``: the stateful codecs ride without
    their residual."""
    return env_enum("BAGUA_EF_RESIDUAL") == "off"


def get_flat_resident_mode() -> str:
    """Flat-resident training state: ``auto`` (default: engage wherever the
    algorithm family supports it), ``on``, or ``off`` (the per-parameter
    layout)."""
    return env_enum("BAGUA_FLAT_RESIDENT")


def get_grad_guard_mode() -> str:
    """Gradient-health sentinel policy: ``off`` (default), ``warn``,
    ``skip`` (rewind unhealthy steps), or ``abort``."""
    return env_enum("BAGUA_GRAD_GUARD")


def get_lockdep_mode() -> str:
    """Runtime lockdep witness: ``off`` (default) or ``on``.  Read once at
    package import (the shim must wrap locks as they are created), so it is
    set in the environment, never flipped at runtime."""
    return env_enum("BAGUA_LOCKDEP")


def get_lockdep_out() -> str:
    """Lockdep witness JSON output path ("" = the default
    ``./bagua_lockdep_witness.json``)."""
    return env_str("BAGUA_LOCKDEP_OUT")


def get_scale_ranks() -> list:
    """World sizes the pod simulator's drill sweeps, parsed to ints (a bad
    entry raises: a silently skipped size would fake coverage)."""
    return [int(p) for p in env_str("BAGUA_SCALE_RANKS").split(",")
            if p.strip()]


def get_scale_shape() -> str:
    """Raw link-shape selector (preset name or JSON); parsed by
    :func:`bagua_tpu_torch.podsim.shaping.resolve_shape`."""
    return env_str("BAGUA_SCALE_SHAPE")


def get_scale_seed() -> int:
    return env_int("BAGUA_SCALE_SEED")


def get_scale_dcn_codec() -> str:
    """Wire codec of the pod simulator's inter-node ring (numpy wire model;
    default ``minmax_uint8``)."""
    return env_str("BAGUA_SCALE_DCN_CODEC")


def get_fault_plan_raw() -> Optional[str]:
    """The raw JSON fault-injection plan (None when unset); parsed by
    :mod:`bagua_tpu_torch.faults.inject`."""
    return _raw("BAGUA_FAULT_PLAN")


def get_async_max_staleness() -> int:
    """Bounded-staleness cap of async model average (0: unbounded)."""
    return env_int("BAGUA_ASYNC_MAX_STALENESS")


def get_ckpt_quarantined_paths() -> list:
    """Checkpoint directories under storage quarantine (possibly []).
    Newline-separated: ``os.pathsep`` is ``:`` on POSIX and would split
    ``gs://``-style URI directories apart."""
    raw = _raw("BAGUA_CKPT_QUARANTINED_PATHS")
    if not raw:
        return []
    return [p.strip() for p in raw.splitlines() if p.strip()]


def get_coordinator_addr() -> Optional[str]:
    """The launcher's rendezvous ``host:port`` (None when unset)."""
    return _raw("BAGUA_COORDINATOR_ADDR")


def get_comm_timeout_s() -> Optional[float]:
    """Hang-watchdog timeout in seconds, or None when disabled."""
    return env_seconds_or_off("BAGUA_COMM_TIMEOUT_S")


def get_elastic_join_window_s() -> float:
    return env_float("BAGUA_ELASTIC_JOIN_WINDOW_S")


def get_elastic_lease_ttl_s() -> float:
    return env_float("BAGUA_ELASTIC_LEASE_TTL_S")


def get_elastic_telemetry_out() -> Optional[str]:
    return _raw("BAGUA_ELASTIC_TELEMETRY_OUT")


def get_elastic_health_file() -> Optional[str]:
    """This worker's health beacon path (launcher-injected, per local rank);
    None disables the worker-to-launcher health channel."""
    return _raw("BAGUA_ELASTIC_HEALTH_FILE")


def get_elastic_fence_unhealthy() -> int:
    """Health-fence threshold (0 = fencing disabled)."""
    return env_int("BAGUA_ELASTIC_FENCE_UNHEALTHY")


def get_elastic_store_addr() -> Optional[str]:
    return _raw("BAGUA_ELASTIC_STORE_ADDR")


def get_elastic_epoch() -> int:
    return env_int("BAGUA_ELASTIC_EPOCH")


def get_elastic_node_id() -> int:
    return env_int("BAGUA_ELASTIC_NODE_ID")


def get_restart_store_endpoints() -> List[str]:
    """Priority-ordered ``host:port`` endpoints of the replicated restart
    store; empty list = single-store mode (no replication, no failover)."""
    raw = _raw("BAGUA_RESTART_STORE_ENDPOINTS") or ""
    return [part.strip() for part in raw.split(",") if part.strip()]


def get_restart_store_op_deadline_s() -> float:
    return env_float("BAGUA_RESTART_STORE_OP_DEADLINE_S")


def get_restart_coord_lease_ttl_s() -> float:
    return env_float("BAGUA_RESTART_COORD_LEASE_TTL_S")


def get_restart_takeover_grace_s() -> float:
    """Post-takeover lease re-arm grace; 0 = auto (2x the member lease TTL,
    resolved by the caller, who knows the effective TTL)."""
    return env_float("BAGUA_RESTART_TAKEOVER_GRACE_S")


def get_bagua_service_port() -> int:
    return env_int("BAGUA_SERVICE_PORT")


def get_autotune_level() -> int:
    return env_int("BAGUA_AUTOTUNE")


def get_autotune_max_samples() -> int:
    return env_int("BAGUA_AUTOTUNE_MAX_SAMPLES")


def get_autotune_sampling_confidence_time_s() -> float:
    return env_float("BAGUA_AUTOTUNE_SAMPLING_CONFIDENCE_TIME_S")


def get_autotune_warmup_time_s() -> float:
    return env_float("BAGUA_AUTOTUNE_WARMUP_TIME_S")


def is_autotune_algorithm_on() -> bool:
    """Let the autotuner search over algorithm families too."""
    return env_bool("BAGUA_AUTOTUNE_ALGORITHM")


def get_autotune_goodput() -> bool:
    """Whether check-ins carry windowed goodput/MFU/DCN observations (the
    v2 fleet-min-goodput score input; needs the obs plane on to matter)."""
    return env_bool("BAGUA_AUTOTUNE_GOODPUT")


def get_autotune_space() -> str:
    """'auto' (capability-gated v2 knob space) or 'legacy' (two-knob)."""
    v = env_str("BAGUA_AUTOTUNE_SPACE").strip().lower()
    return v if v in ("auto", "legacy") else "auto"


def is_report_metrics_switch_on() -> bool:
    return env_bool("BAGUA_REPORT_METRICS")


def is_output_autotune_log() -> bool:
    return env_bool("BAGUA_IS_OUTPUT_AUTOTUNE_LOG")


def get_autotune_server_addr() -> Optional[str]:
    return os.environ.get("AUTO_TUNE_SERVER_ADDR") or None


def get_autopilot_mode() -> str:
    """Fleet-autopilot mode: ``off`` (default — no engine), ``observe``
    (decide + flight-record, never actuate), or ``act``."""
    return env_enum("BAGUA_AUTOPILOT")


def get_autopilot_slo_goodput() -> float:
    """Goodput-fraction SLO for the escalation ladder (0 = rule off)."""
    return env_float("BAGUA_AUTOPILOT_SLO_GOODPUT")


def get_autopilot_sustain() -> int:
    """Consecutive snapshots a rule must hold before acting."""
    return env_int("BAGUA_AUTOPILOT_SUSTAIN")


def get_autopilot_cooldown_s() -> float:
    """Per-action-kind cooldown in seconds."""
    return env_float("BAGUA_AUTOPILOT_COOLDOWN_S")


def get_autopilot_budget() -> int:
    """Global autopilot action budget per run."""
    return env_int("BAGUA_AUTOPILOT_BUDGET")


def get_autopilot_staleness_s() -> float:
    """Fleet-snapshot freshness bound in seconds."""
    return env_float("BAGUA_AUTOPILOT_STALENESS_S")


def get_autopilot_straggler_ratio() -> float:
    """Minimum suspect ratio feeding the straggler/victim streaks."""
    return env_float("BAGUA_AUTOPILOT_STRAGGLER_RATIO")


def get_autopilot_suspect_ttl_s() -> float:
    """Straggler-suspect evidence time-to-live in seconds."""
    return env_float("BAGUA_AUTOPILOT_SUSPECT_TTL_S")


def get_autopilot_ckpt_failures() -> int:
    """Checkpoint-integrity event threshold for storage quarantine."""
    return env_int("BAGUA_AUTOPILOT_CKPT_FAILURES")


def get_autopilot_family() -> str:
    """Algorithm family the ladder's switch rung commands."""
    return env_str("BAGUA_AUTOPILOT_FAMILY")


def get_autopilot_model() -> str:
    """Autotune task (model_name) autopilot hints address."""
    return env_str("BAGUA_AUTOPILOT_MODEL")


def get_autopilot_dcn_share() -> float:
    """DCN-dominance share threshold for the trend rule (0 = off)."""
    return env_float("BAGUA_AUTOPILOT_DCN_SHARE")


def get_autopilot_compress_family() -> str:
    """Compression family the DCN-dominance hint names."""
    return env_str("BAGUA_AUTOPILOT_COMPRESS_FAMILY")


def get_autopilot_compress_codec() -> str:
    """DCN wire codec the compress_dcn hint actuates through autotune."""
    return env_str("BAGUA_AUTOPILOT_COMPRESS_CODEC")


def get_autopilot_hbm_horizon_s() -> float:
    """Pre-OOM projection horizon for the HBM trend rule (0 = off)."""
    return env_float("BAGUA_AUTOPILOT_HBM_HORIZON_S")


def get_obs_http_port() -> int:
    """HTTP status-plane port (0 = server disabled)."""
    return env_int("BAGUA_OBS_HTTP_PORT")


def get_obs_http_addr() -> str:
    """HTTP status-plane bind address (default loopback)."""
    return env_str("BAGUA_OBS_HTTP_ADDR")


def get_obs_historian_capacity() -> int:
    """Samples retained per (rank, metric) historian ring."""
    return env_int("BAGUA_OBS_HISTORIAN_CAPACITY")


def get_obs_historian_window_s() -> float:
    """Trend window (seconds) for historian slope/percentile queries."""
    return env_float("BAGUA_OBS_HISTORIAN_WINDOW_S")


def get_profile_dir() -> Optional[str]:
    return _raw("BAGUA_PROFILE_DIR")


def get_profile_steps_raw() -> str:
    """Raw ``start:stop`` window; parsing (and the fallback on malformed
    values) lives in :func:`bagua_tpu_torch.profiling.profile_steps`."""
    return env_str("BAGUA_PROFILE_STEPS")


def get_obs_mode() -> str:
    """Observability-plane master switch: ``on`` (default) or ``off``."""
    return env_enum("BAGUA_OBS")


def get_obs_ring_size() -> int:
    return env_int("BAGUA_OBS_RING")


def get_obs_dump_dir() -> Optional[str]:
    """Flight-recorder dump directory; None disables the recorder."""
    return _raw("BAGUA_OBS_DUMP_DIR")


def get_obs_export_dir() -> Optional[str]:
    """Metrics-exporter output directory; None disables the exporter."""
    return _raw("BAGUA_OBS_EXPORT_DIR")


def get_obs_export_interval_s() -> float:
    return env_float("BAGUA_OBS_EXPORT_INTERVAL_S")


def get_obs_export_max_bytes() -> int:
    """metrics.jsonl rotation cap in bytes (0 = unbounded)."""
    return env_int("BAGUA_OBS_EXPORT_MAX_BYTES")


def get_obs_fleet_out() -> Optional[str]:
    """Coordinator-side fleet snapshot path; None disables."""
    return _raw("BAGUA_OBS_FLEET_OUT")


def get_obs_anomaly_mode() -> str:
    """Step-time anomaly detector switch: ``on`` (default) or ``off``;
    also off whenever the obs plane itself is off."""
    return env_enum("BAGUA_OBS_ANOMALY")


def get_obs_anomaly_window() -> int:
    return env_int("BAGUA_OBS_ANOMALY_WINDOW")


def get_obs_anomaly_warmup() -> int:
    return env_int("BAGUA_OBS_ANOMALY_WARMUP")


def get_obs_anomaly_threshold() -> float:
    return env_float("BAGUA_OBS_ANOMALY_THRESHOLD")


def get_obs_dump_max_files() -> int:
    """Flight-dump retention cap (0 = unbounded)."""
    return env_int("BAGUA_OBS_DUMP_MAX_FILES")


def get_serve_max_slots() -> int:
    """Batch slots of the continuous-batching serving engine."""
    return env_int("BAGUA_SERVE_MAX_SLOTS")


def get_serve_page_size() -> int:
    """Tokens per KV-cache page of the serving page pool."""
    return env_int("BAGUA_SERVE_PAGE_SIZE")


def get_serve_num_pages() -> int:
    """Page-pool capacity per layer (0 = auto-size to max_slots
    full-length sequences)."""
    return env_int("BAGUA_SERVE_NUM_PAGES")


def get_serve_queue_depth() -> int:
    """Admission-queue depth of the serving engine."""
    return env_int("BAGUA_SERVE_QUEUE_DEPTH")


def get_serve_prefill_chunk() -> int:
    """Prompt tokens per chunked-prefill call (1 disables chunking)."""
    return env_int("BAGUA_SERVE_PREFILL_CHUNK")


def get_serve_tick_idle_s() -> float:
    """Scheduler idle-poll granularity in seconds."""
    return env_float("BAGUA_SERVE_TICK_IDLE_S")


def is_obs_historian_on() -> bool:
    """Whether the coordinator-side telemetry historian is enabled."""
    return env_enum("BAGUA_OBS_HISTORIAN") == "on"


def render_env_vars_md() -> str:
    """The ``docs/torch/env_vars.md`` reference table, emitted straight from
    :data:`ENV_REGISTRY` (``scripts/torch_gen_env_docs.py`` writes and
    checks it; the JAX package's ``render_env_vars_md``)."""
    lines = [
        "# Environment variables (bagua_tpu_torch)",
        "",
        "Generated by `scripts/torch_gen_env_docs.py` from "
        "`bagua_tpu_torch.env.ENV_REGISTRY` — do not edit by hand.",
        "",
        "Every `BAGUA_*` tunable the port reads is declared in the registry and",
        "read through `bagua_tpu_torch.env` accessors; the port's lint",
        "(`python -m bagua_tpu_torch.analysis`) flags any other read.",
        "",
        "| Variable | Type | Default | Description |",
        "| --- | --- | --- | --- |",
    ]
    for name in sorted(ENV_REGISTRY):
        v = ENV_REGISTRY[name]
        typ = v.type if not v.choices else "|".join(v.choices)
        default = v.default if v.default != "" else "*(unset)*"
        doc = " ".join(v.doc.split())
        lines.append(f"| `{name}` | {typ} | `{default}` | {doc} |")
    return "\n".join(lines) + "\n"
