"""Bench-trend sentinel: is this tree slower than a recorded run?

Port of ``bagua_tpu/obs/regress.py``.  Re-measure a small probe suite with
the interleaved A/B protocol (:mod:`.ab`), compare record-by-record against
earlier records, and write a trend record (schema
``bagua-bench-trend-v1``).

The comparison is **noise-bound-aware**: a recorded run's
``per_trial_ratios`` spread is its own statement about run-to-run
variance, so the regression tolerance for that metric is at least that
half-spread (never below ``--tolerance``, default 10%); a recorded or fresh
record flagged ``noise_bound`` can only ever produce a ``noise_bound``
verdict, never a ``regressed`` one.  Fewer probe trials than the recorded
run bias the fresh best-of LOW, i.e. toward false alarms — which is why the
sentinel is **advisory** by default (prints, writes the trend, exits 0);
``--strict`` turns regressions into a non-zero exit.

Where the port differs from the JAX package:

* ``--against`` is required: the records to compare against are the
  caller's (without it the CLI exits 2 and writes nothing).  ``--out``
  defaults to ``chiprun_out/torch_bench_trend.json`` under the repo root.
* The probe runs in this process, on the caller's device (``cuda`` unless
  ``--device cpu``): nothing binds a device topology at first use, so no
  subprocess is needed.  On the CPU its workload is the MLP (256, 256, 10)
  on 64 features, 32 rows and 30 timed steps; on a card, ResNet50 (1000
  classes, 224x224 bf16 images) at :data:`PROBE` ``["cuda"]``'s rows and
  steps, cut so that a probe of two trials takes seconds.

CLI::

    python -m bagua_tpu_torch.obs.regress --against OLD.json [--device cpu]
    python -m bagua_tpu_torch.obs.regress --fresh NEW.json --against OLD.json
    python -m bagua_tpu_torch.obs.regress --against OLD.json --strict --trials 5
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

logger = logging.getLogger(__name__)

__all__ = ["TREND_SCHEMA", "DEFAULT_TOLERANCE", "PROBE", "compare_records",
           "run_quick_probe", "measure_flat", "measure_efficiency",
           "efficiency_trend_records", "build_efficiency_record",
           "build_trend", "validate_bench_trend", "main"]

TREND_SCHEMA = "bagua-bench-trend-v1"

#: observed run-to-run variance floor of the throughput measurements
DEFAULT_TOLERANCE = 0.10

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(_REPO, "chiprun_out", "torch_bench_trend.json")

#: the probe's workload by device type: the model, the rows a step, the
#: timed steps of each of the two windows, and the bucket size
PROBE = {
    "cpu": dict(model="mlp_256x256", rows=32, timed=30, bucket_bytes=65536),
    "cuda": dict(model="resnet50", rows=32, timed=5, bucket_bytes=None),
}
#: steps of the efficiency probe (the quick measurement)
EFFICIENCY_STEPS = 12


def _half_spread(record: dict) -> float:
    """Half the per-trial ratio spread of an A/B record — its own measured
    noise band (0 when the record carries no trials)."""
    ratios = record.get("per_trial_ratios")
    if not isinstance(ratios, list) or len(ratios) < 2:
        return 0.0
    try:
        return (max(ratios) - min(ratios)) / 2.0
    except TypeError:
        return 0.0


def _direction(*records: dict) -> Optional[bool]:
    """The comparison direction for a record pair: True (higher is
    better), False (lower is better — e.g. memory footprints), or None
    (unknown — the pair is skipped rather than compared with an assumed
    direction: a lower-is-better metric run through a higher-is-better
    comparison INVERTS the verdict, which is worse than no verdict).

    An explicit ``higher_better`` field (the efficiency trend records
    carry one) wins; otherwise the heuristic recognizes throughput records
    (unit carries a rate, ``.../s...``) and A/B speedup records
    (``per_trial_ratios``/``faster_path``) as higher-is-better."""
    for rec in records:
        if isinstance(rec.get("higher_better"), bool):
            return rec["higher_better"]
    for rec in records:
        unit = rec.get("unit") or ""
        if "/s" in unit:
            return True
        if "per_trial_ratios" in rec or "faster_path" in rec:
            return True
    return None


def compare_records(fresh: Sequence[dict], committed: Sequence[dict],
                    tolerance: float = DEFAULT_TOLERANCE) -> List[dict]:
    """Per-metric fresh/recorded comparison; returns one verdict dict per
    metric present in BOTH with a positive numeric value and a KNOWN
    direction (see :func:`_direction` — direction-unknown metrics are
    skipped, never guessed).

    Verdicts: ``ok`` (within tolerance), ``improved`` (above it),
    ``regressed`` (below it, and neither side is noise-bound),
    ``noise_bound`` (below it but either side's own trial spread says the
    comparison cannot support a conclusion)."""
    by_metric: Dict[str, dict] = {
        r["metric"]: r for r in committed
        if isinstance(r, dict) and r.get("metric")
    }
    out: List[dict] = []
    for rec in fresh:
        if not isinstance(rec, dict):
            continue
        name = rec.get("metric")
        base = by_metric.get(name)
        if base is None:
            continue
        fv, cv = rec.get("value"), base.get("value")
        if not isinstance(fv, (int, float)) \
                or not isinstance(cv, (int, float)) or cv <= 0 or fv <= 0:
            continue
        higher = _direction(rec, base)
        if higher is None:
            continue
        ratio = fv / cv
        # score normalizes direction: > 1 is always "got better"
        score = ratio if higher else cv / fv
        tol = max(float(tolerance), _half_spread(base), _half_spread(rec))
        noisy = bool(base.get("noise_bound") or rec.get("noise_bound"))
        if score < 1.0 - tol:
            verdict = "noise_bound" if noisy else "regressed"
        elif score > 1.0 + tol:
            verdict = "improved"
        else:
            verdict = "ok"
        out.append({
            "metric": name,
            "fresh_value": fv,
            "committed_value": cv,
            "unit": rec.get("unit") or base.get("unit"),
            "ratio": round(ratio, 3),
            "higher_better": higher,
            "tolerance": round(tol, 3),
            "noise_bound": noisy,
            "verdict": verdict,
        })
    return out


# ---- the probe --------------------------------------------------------------


def _workload(device):
    """``(loss_fn, model, batch, sizes)`` of the probe on ``device``."""
    import numpy as np
    import torch

    sizes = PROBE["cuda" if device.type == "cuda" else "cpu"]
    rows = sizes["rows"]
    if sizes["model"] == "resnet50":
        from ..models.resnet import ResNet50, classification_loss_fn

        g = torch.Generator(device=device).manual_seed(1)
        images = torch.randn((rows, 3, 224, 224), device=device, generator=g)
        labels = torch.randint(0, 1000, (rows,), device=device, generator=g)
        model = ResNet50(num_classes=1000, device=device, seed=0)
        batch = {"images": images.to(torch.bfloat16)
                 .contiguous(memory_format=torch.channels_last), "labels": labels}
        return classification_loss_fn, model, batch, sizes
    from ..models.mlp import MLP

    dim, nclass = 64, 10
    rng = np.random.default_rng(0)
    batch = {"x": torch.from_numpy(rng.normal(size=(rows, dim)).astype(np.float32)).to(device),
             "y": torch.from_numpy(rng.integers(0, nclass, size=(rows,))).to(device)}
    model = MLP(dim, features=(256, 256, nclass), device=device, seed=0)

    def loss_fn(m, b):
        return torch.nn.functional.cross_entropy(m(b["x"]), b["y"])

    return loss_fn, model, batch, sizes


def measure_flat(flat_resident: str, device=None) -> dict:
    """One record: the throughput of ``gradient_allreduce`` at accum 1 with
    the overlap scheduler off and the flat-resident layout ``on`` or
    ``off`` (the one moving part), best of two windows of the probe's timed
    steps after two warm-up steps, each window closed by a readback."""
    import functools

    import torch

    from .. import communication
    from ..algorithms import GradientAllReduceAlgorithm
    from ..core.backend import BaguaTrainer
    from ..device import resolve_device

    device = resolve_device(device)
    communication.init_process_group(device=device)
    loss_fn, model, batch, sizes = _workload(device)
    timed = sizes["timed"]
    trainer = BaguaTrainer(
        loss_fn, functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9),
        GradientAllReduceAlgorithm(hierarchical=False), device=device,
        autotune=False, accum_steps=1, bucket_bytes=sizes["bucket_bytes"],
        flat_resident=flat_resident, overlap="off",
    )
    # an interleaved bench's leg switches are not fleet anomalies
    trainer.anomaly_detector = None
    state = trainer.init(model)
    data = trainer.shard_batch(batch)
    loss = None
    for _ in range(2):
        state, loss = trainer.train_step(state, data)
    float(loss)   # drain the queue before the timer starts
    dt = None
    for _window in range(2):
        t0 = time.perf_counter()
        for _ in range(timed):
            state, loss = trainer.train_step(state, data)
        float(loss)   # forces the chained steps to completion
        w = time.perf_counter() - t0
        dt = w if dt is None else min(dt, w)
    world = trainer.world_size
    samples = sizes["rows"] * world
    per_chip = timed * samples / dt / world
    image = sizes["model"] == "resnet50"
    return {
        "metric": f"flat_{sizes['model']}_gradient_allreduce_accum1_{flat_resident}",
        "value": round(per_chip, 1),
        "unit": "img/s/chip" if image else "samples/s/chip",
        "flat_resident": flat_resident,
        "accum_steps": 1,
        "family": "gradient_allreduce",
        "model": sizes["model"],
        "platform": device.type,
        "config": {"rows": sizes["rows"], "timed_steps": timed, "warmup_steps": 2,
                   "world": world, "dtype": "bfloat16" if image else "float32"},
        "timing": f"best_of_1_trials_min_of_2_windows_x{timed}_steps",
    }


def _golden_mlp(device, rows: int = 8):
    """The efficiency probe's task: MLP (32, 8) on x ``[rows, 4]``, labels
    ``argmax(x @ W)``, from a numpy seed."""
    import numpy as np
    import torch

    from ..models.mlp import MLP

    rng = np.random.default_rng(0)
    x = rng.normal(size=(rows, 4)).astype(np.float32)
    y = np.argmax(x @ rng.normal(size=(4, 8)).astype(np.float32), -1)
    model = MLP(4, features=(32, 8), device=device, seed=2)
    batch = {"x": torch.from_numpy(x).to(device), "y": torch.from_numpy(y).to(device)}

    def loss_fn(m, b):
        return torch.nn.functional.cross_entropy(m(b["x"]), b["y"])

    return loss_fn, model, batch


def measure_efficiency(device=None, steps: int = EFFICIENCY_STEPS) -> dict:
    """One instrumented run of the headline configuration
    (``gradient_allreduce``, accum 1, the default layout, the grad guard
    on ``skip``) over a window that exercises badput on purpose: the first
    step's build, one checkpoint save and one rewound ``grad.poison`` step.
    Returns the ledger report, the static footprint and the MFU record."""
    import functools

    import torch

    from .. import communication
    from ..algorithms import GradientAllReduceAlgorithm
    from ..checkpoint import BaguaCheckpointManager
    from ..core.backend import BaguaTrainer
    from ..device import resolve_device
    from ..faults.inject import FaultSpec, fault_scope
    from . import export as obs_export
    from . import ledger as obs_ledger
    from . import spans as obs_spans
    from .memory import static_footprint

    if not obs_spans.enabled():
        raise RuntimeError("the efficiency probe needs BAGUA_OBS=on")
    device = resolve_device(device)
    communication.init_process_group(device=device)
    loss_fn, model, batch = _golden_mlp(device)
    obs_export.reset_local_summary()
    obs_ledger.ledger.reset()   # the measured window starts clean
    poison_step = max(3, steps // 2)
    with fault_scope(FaultSpec("grad.poison", step=poison_step)):
        trainer = BaguaTrainer(loss_fn, functools.partial(torch.optim.SGD, lr=0.1),
                               GradientAllReduceAlgorithm(), device=device, autotune=False,
                               grad_guard="skip", flat_resident="auto")
        trainer.anomaly_detector = None
        state = trainer.init(model)
        data = trainer.shard_batch(batch)
        ckpt_at = max(2, steps // 3)
        with tempfile.TemporaryDirectory(prefix="eff_ckpt_") as tmp:
            mgr = BaguaCheckpointManager(os.path.join(tmp, "ckpt"), async_save=False)
            loss = None
            for i in range(steps):
                state, loss = trainer.train_step(state, data)
                if i == ckpt_at:
                    trainer.save_checkpoint(mgr, i, state)
            float(loss)
            trainer.flush_grad_health()
            mgr.close()
        report = obs_ledger.ledger.report()
        footprint = static_footprint(trainer, state)
        mfu = obs_export.last_mfu() or {
            "available": False, "rationale": "trainer published no MFU record"}
    return {"ledger": report, "footprint": footprint, "mfu": mfu, "steps": steps,
            "platform": device.type,
            "device_kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                            else "cpu"),
            "n_devices": trainer.world_size,
            "config": {"family": "gradient_allreduce", "accum_steps": 1,
                       "flat_resident": "auto", "grad_guard": "skip", "steps": steps,
                       "badput_drills": ["compile_window", "checkpoint_save",
                                         "grad_poison_rewind"]}}


def efficiency_trend_records(raw: dict) -> List[dict]:
    """The regress-consumable slice of an efficiency measurement: goodput
    fraction (higher better; noise-bound — a short window's build share
    dominates the split and varies with host load) and the static footprint
    (lower better; exact, so a memory bloat WILL flag)."""
    return [
        {
            "metric": "efficiency_goodput_fraction",
            "value": raw["ledger"]["goodput_fraction"],
            "unit": "fraction",
            "higher_better": True,
            "noise_bound": True,
            "steps": raw["steps"],
        },
        {
            "metric": "efficiency_hbm_static_footprint_bytes",
            "value": raw["footprint"]["total_bytes"],
            "unit": "bytes",
            "higher_better": False,
            "noise_bound": False,
        },
    ]


def build_efficiency_record(raw: dict) -> dict:
    """A ``bagua-efficiency-v1`` record from :func:`measure_efficiency`'s
    pieces (or a caller's of the same shape)."""
    from .ledger import EFFICIENCY_SCHEMA

    return {
        "schema": EFFICIENCY_SCHEMA,
        "time_unix": time.time(),
        "platform": raw["platform"],
        "device_kind": raw["device_kind"],
        "n_devices": raw["n_devices"],
        "config": raw["config"],
        "ledger": raw["ledger"],
        "footprint": raw["footprint"],
        "memory_analysis": None,
        "memory_analysis_rationale": raw["footprint"].get("compiled_memory_rationale"),
        "mfu": raw["mfu"],
        "trend_records": efficiency_trend_records(raw),
    }


def run_quick_probe(trials: int = 3, device=None) -> List[dict]:
    """Measure the headline configuration (``gradient_allreduce``, accum 1,
    flat-resident off against on) under the interleaved protocol, in this
    process on ``device`` (``cuda`` unless the caller passes the CPU), plus
    the efficiency trend records.  Returns the records: off, on, the
    speedup and the two efficiency records."""
    import numpy as np

    from ..device import resolve_device
    from .ab import interleaved_ab, speedup_record

    device = resolve_device(device)
    off, on, ratios = interleaved_ab(
        lambda: measure_flat("off", device),
        lambda: measure_flat("on", device),
        trials=trials,
    )
    faster = "on" if float(np.median(ratios)) >= 1.0 else "off"
    speedup = speedup_record(
        "flat_speedup_gradient_allreduce_accum1", ratios, "flat/leaf",
        faster_path=faster, platform=on["platform"],
    )
    return [off, on, speedup] + efficiency_trend_records(measure_efficiency(device))


def build_trend(comparisons: List[dict], mode: str,
                against: Sequence[str], trials: Optional[int],
                strict: bool, platform: Optional[str] = None) -> dict:
    """The trend record; ``platform`` is the probe's device type (None in
    file mode)."""
    regressions = [c["metric"] for c in comparisons
                   if c["verdict"] == "regressed"]
    record = {
        "schema": TREND_SCHEMA,
        "time_unix": time.time(),
        "mode": mode,
        "against": list(against),
        "advisory": not strict,
        "tolerance_floor": DEFAULT_TOLERANCE,
        "comparisons": comparisons,
        "regressions": regressions,
        "improved": [c["metric"] for c in comparisons
                     if c["verdict"] == "improved"],
        "noise_bound": [c["metric"] for c in comparisons
                        if c["verdict"] == "noise_bound"],
        "pass": not regressions,
    }
    if trials is not None:
        record["probe_trials"] = trials
    record["platform"] = platform
    return record


def validate_bench_trend(record: dict) -> List[str]:
    """Schema problems with a trend record ([] = valid)."""
    problems: List[str] = []
    if not isinstance(record, dict):
        return ["not a JSON object"]
    if record.get("schema") != TREND_SCHEMA:
        problems.append(f"schema != {TREND_SCHEMA}")
    for key, typ in (("time_unix", (int, float)), ("comparisons", list),
                     ("regressions", list), ("pass", bool),
                     ("advisory", bool), ("against", list)):
        if not isinstance(record.get(key), typ):
            problems.append(f"missing/mistyped {key}")
    for i, cmp_ in enumerate(record.get("comparisons") or []):
        for key in ("metric", "fresh_value", "committed_value", "ratio",
                    "tolerance", "verdict"):
            if key not in cmp_:
                problems.append(f"comparisons[{i}] missing {key}")
                break
        if cmp_.get("verdict") not in ("ok", "improved", "regressed",
                                       "noise_bound"):
            problems.append(
                f"comparisons[{i}] bad verdict {cmp_.get('verdict')!r}")
    if not (record.get("comparisons") or []):
        problems.append("comparisons empty — the sentinel measured nothing")
    return problems


def _load_records(path: str) -> List[dict]:
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict) and "trend_records" in data:
        # an efficiency record: compare its embedded trend records
        return list(data["trend_records"])
    return data if isinstance(data, list) else [data]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bagua_tpu_torch.obs.regress",
        description="Compare a fresh bench run against recorded bench "
                    "records (noise-bound-aware) and write a trend record.",
    )
    ap.add_argument("--fresh", default=None,
                    help="fresh bench records (JSON list, or an efficiency "
                         "record); default: run the quick probe in-process")
    ap.add_argument("--against", action="append", default=None,
                    help="recorded records to compare against (required; "
                         "repeatable)")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="trend record path (default: "
                         "chiprun_out/torch_bench_trend.json)")
    ap.add_argument("--trials", type=int, default=3,
                    help="quick-probe interleaved trials (default 3)")
    ap.add_argument("--device", default="cuda",
                    help="the quick probe's device (default cuda)")
    ap.add_argument("--tolerance", type=float, default=DEFAULT_TOLERANCE,
                    help="regression tolerance floor (default 0.10)")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on regressions (default: advisory exit 0)")
    args = ap.parse_args(argv)

    if not args.against:
        print("--against is required: name the recorded bench records to "
              "compare against (there is no default)", file=sys.stderr)
        return 2
    committed: List[dict] = []
    for path in args.against:
        try:
            committed.extend(_load_records(path))
        except (OSError, ValueError) as e:
            print(f"cannot read recorded records {path}: {e}",
                  file=sys.stderr)
            return 2

    trials: Optional[int] = None
    platform: Optional[str] = None
    if args.fresh:
        fresh = _load_records(args.fresh)
        mode = "files"
    else:
        trials = max(1, args.trials)
        print(f"running quick probe ({trials} interleaved trials) on "
              f"{args.device}...", flush=True)
        fresh = run_quick_probe(trials=trials, device=args.device)
        platform = fresh[0]["platform"]
        mode = "quick_probe"

    comparisons = compare_records(fresh, committed,
                                  tolerance=args.tolerance)
    if not comparisons:
        print("no comparable metrics between fresh and recorded records",
              file=sys.stderr)
        return 2
    record = build_trend(comparisons, mode, args.against, trials, args.strict,
                         platform)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1, sort_keys=True)
        f.write("\n")

    for c in comparisons:
        print(f"  {c['verdict']:>11}  {c['metric']}: "
              f"{c['fresh_value']} vs {c['committed_value']} "
              f"(x{c['ratio']}, tol ±{c['tolerance']})")
    n_reg = len(record["regressions"])
    print(f"wrote {args.out}: {len(comparisons)} metric(s), "
          f"{n_reg} regression(s), "
          f"{len(record['noise_bound'])} noise-bound — "
          f"{'PASS' if record['pass'] else 'REGRESSED'}"
          f"{' (advisory)' if record['advisory'] else ''}")
    if n_reg and args.strict:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
