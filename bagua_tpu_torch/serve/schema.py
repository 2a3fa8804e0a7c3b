"""The serving bench's record schema (``bagua-bench-serve-v1``).

Port of ``bagua_tpu/serve/schema.py``.  A serving bench's record is a list
of records: a schema header, TTFT/TPOT percentile records from a
Poisson-paced trace, the continuous-vs-static throughput A/B on the
interleaved protocol of :mod:`bagua_tpu_torch.obs.ab` (per-trial ratio
spread + ``noise_bound`` flag), and the serving goodput-ledger breakdown
proving the serving classes were *fed*.  :func:`validate_serve_bench` is
shared by whatever writes such a record (it refuses to write an invalid
one) and the gates that read it.

Import-light (no torch): a record is validated without a device bring-up.
"""

from __future__ import annotations

from typing import Dict, List

__all__ = ["SERVE_BENCH_SCHEMA", "SERVE_SPEEDUP_GATE",
           "validate_serve_bench"]

SERVE_BENCH_SCHEMA = "bagua-bench-serve-v1"

#: the acceptance ratio: continuous batching must hold at least this many
#: times static batching's token throughput on the mixed-length trace
#: (or the record must honestly flag the comparison noise-bound)
SERVE_SPEEDUP_GATE = 1.3

_PCTS = ("p50", "p90", "p99")


def _by_metric(records) -> Dict[str, dict]:
    return {r.get("metric"): r for r in records if isinstance(r, dict)}


def validate_serve_bench(records) -> List[str]:
    """Schema problems with a BENCH_SERVE.json record list ([] = valid)."""
    problems: List[str] = []
    if not isinstance(records, list) or not records:
        return ["not a non-empty JSON list"]
    by = _by_metric(records)

    header = by.get("serve_bench_schema")
    if not isinstance(header, dict):
        return ["missing serve_bench_schema header record"]
    if header.get("schema") != SERVE_BENCH_SCHEMA:
        problems.append(f"schema != {SERVE_BENCH_SCHEMA}")
    for key in ("time_unix", "platform", "n_devices", "config", "trace"):
        if key not in header:
            problems.append(f"header missing {key}")
    cfg = header.get("config") or {}
    for key in ("max_slots", "page_size", "num_pages", "prefill_chunk"):
        if not isinstance(cfg.get(key), int):
            problems.append(f"header.config missing/mistyped {key}")

    lat = by.get("serve_latency")
    if not isinstance(lat, dict):
        problems.append("missing serve_latency record")
    else:
        for field in ("ttft_s", "tpot_s"):
            pct = lat.get(field)
            if not isinstance(pct, dict):
                problems.append(f"serve_latency.{field} missing")
                continue
            for p in _PCTS:
                v = pct.get(p)
                if not isinstance(v, (int, float)) or v < 0:
                    problems.append(f"serve_latency.{field}.{p} "
                                    "missing/negative")
        if not isinstance(lat.get("n_requests"), int) \
                or lat.get("n_requests", 0) < 1:
            problems.append("serve_latency.n_requests missing")

    for side in ("serve_continuous_tokens_per_sec",
                 "serve_static_tokens_per_sec"):
        rec = by.get(side)
        if not isinstance(rec, dict):
            problems.append(f"missing {side} record")
            continue
        if not isinstance(rec.get("value"), (int, float)) \
                or rec["value"] <= 0:
            problems.append(f"{side}.value missing/nonpositive")
        if "interleaved_ab" not in str(rec.get("timing", "")):
            problems.append(f"{side} not measured under the interleaved "
                            "A/B protocol")

    sp = by.get("serve_continuous_over_static_throughput")
    if not isinstance(sp, dict):
        problems.append("missing serve_continuous_over_static_throughput")
    else:
        ratios = sp.get("per_trial_ratios")
        if not isinstance(ratios, list) or len(ratios) < 3:
            problems.append("speedup per_trial_ratios missing/too few")
        if not isinstance(sp.get("noise_bound"), bool):
            problems.append("speedup noise_bound missing")
        if not isinstance(sp.get("value"), (int, float)) \
                or sp.get("value", 0) <= 0:
            problems.append("speedup value missing/nonpositive")
        if sp.get("gate") != SERVE_SPEEDUP_GATE:
            problems.append(f"speedup gate != {SERVE_SPEEDUP_GATE}")
        if not sp.get("provenance"):
            problems.append("speedup missing provenance (cpu-sim honesty "
                            "note)")
        # the acceptance criterion itself, noise-bound-honest: a value
        # below the gate is only admissible when the trial spread says the
        # host could not resolve the comparison.  COMMITTED (full-trace)
        # records only — the CI smoke trace (fewer requests, 3 trials on
        # a loaded host) is a shape check, not an acceptance measurement;
        # the committed artifact's gate lives in test_bench_sanity.py
        if not header.get("smoke") \
                and isinstance(sp.get("value"), (int, float)) \
                and sp["value"] < SERVE_SPEEDUP_GATE \
                and not sp.get("noise_bound"):
            problems.append(
                f"continuous/static throughput {sp['value']} below the "
                f"{SERVE_SPEEDUP_GATE}x gate without a noise_bound flag"
            )

    led = by.get("serve_ledger_classes")
    if not isinstance(led, dict):
        problems.append("missing serve_ledger_classes record")
    else:
        classes = led.get("classes") or {}
        for cls in ("prefill", "decode", "weight_load"):
            v = classes.get(cls)
            if not isinstance(v, (int, float)) or v <= 0:
                problems.append(f"serving ledger class `{cls}` not fed")
        gf = led.get("goodput_fraction")
        if not isinstance(gf, (int, float)) or not (0.0 < gf <= 1.0):
            problems.append("serve_ledger_classes.goodput_fraction "
                            "missing/out of range")
    return problems
