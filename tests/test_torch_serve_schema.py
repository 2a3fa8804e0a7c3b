"""The port's serving-bench schema (``serve/schema.py``) against the JAX
package's.

- A valid record list, and one mutation for every problem
  ``validate_serve_bench`` can name: both packages give the same problem
  list, and each mutation is named.
- A record assembled from the port's engine on the CPU (a tiny f32 LM, its
  weights through the serving loader, a Poisson trace, the interleaved
  continuous/static pair) by ``chip_smoke.serve_bench_records``, the card
  run's assembly, validates.
"""

import copy
import os
import sys
import tempfile

import numpy as np
import pytest
import torch

import bagua_tpu_torch as bt
from bagua_tpu.serve import schema as jschema
from bagua_tpu_torch.obs import ledger as obs_ledger
from bagua_tpu_torch.obs.ab import interleaved_ab
from bagua_tpu_torch.serve import (SERVE_BENCH_SCHEMA, SERVE_SPEEDUP_GATE, ServeConfig,
                                   ServeEngine, load_serving_params, save_serving_artifact,
                                   validate_serve_bench)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)


def _valid():
    return [
        {"metric": "serve_bench_schema", "schema": SERVE_BENCH_SCHEMA, "time_unix": 1.0,
         "platform": "cpu", "n_devices": 1, "smoke": False,
         "config": {"max_slots": 4, "page_size": 8, "num_pages": 34, "prefill_chunk": 8},
         "trace": {"seed": 0}},
        {"metric": "serve_latency", "ttft_s": {"p50": 0.1, "p90": 0.2, "p99": 0.3},
         "tpot_s": {"p50": 0.01, "p90": 0.02, "p99": 0.03}, "n_requests": 12},
        {"metric": "serve_continuous_tokens_per_sec", "value": 130.0,
         "timing": "best_of_3_interleaved_ab_trials_single_window"},
        {"metric": "serve_static_tokens_per_sec", "value": 100.0,
         "timing": "best_of_3_interleaved_ab_trials_single_window"},
        {"metric": "serve_continuous_over_static_throughput", "value": 1.31,
         "per_trial_ratios": [1.3, 1.31, 1.4], "noise_bound": False,
         "gate": SERVE_SPEEDUP_GATE, "provenance": "cpu measurement"},
        {"metric": "serve_ledger_classes",
         "classes": {"prefill": 0.5, "decode": 1.0, "weight_load": 0.1},
         "goodput_fraction": 0.8},
    ]


def _by(records, metric):
    return next(r for r in records if r.get("metric") == metric)


def _drop(metric):
    return lambda rs: [r for r in rs if r.get("metric") != metric]


def _set(metric, key, value):
    def f(rs):
        _by(rs, metric)[key] = value
        return rs
    return f


def _delete(metric, key):
    def f(rs):
        del _by(rs, metric)[key]
        return rs
    return f


def _nested(metric, key, sub, value):
    def f(rs):
        _by(rs, metric)[key][sub] = value
        return rs
    return f


#: mutation -> (function of the valid list, a fragment of the problem named)
MUTATIONS = {
    "not_a_list": (lambda rs: {"metric": "x"}, "not a non-empty JSON list"),
    "empty": (lambda rs: [], "not a non-empty JSON list"),
    "no_header": (_drop("serve_bench_schema"), "missing serve_bench_schema header"),
    "schema": (_set("serve_bench_schema", "schema", "v0"), "schema != "),
    "header_key": (_delete("serve_bench_schema", "platform"), "header missing platform"),
    "config_key": (_nested("serve_bench_schema", "config", "page_size", "8"),
                   "header.config missing/mistyped page_size"),
    "no_latency": (_drop("serve_latency"), "missing serve_latency record"),
    "latency_field": (_delete("serve_latency", "tpot_s"), "serve_latency.tpot_s missing"),
    "latency_pct": (_nested("serve_latency", "ttft_s", "p99", -1.0),
                    "serve_latency.ttft_s.p99 missing/negative"),
    "latency_n": (_set("serve_latency", "n_requests", 0), "serve_latency.n_requests missing"),
    "no_side": (_drop("serve_static_tokens_per_sec"), "missing serve_static_tokens_per_sec"),
    "side_value": (_set("serve_continuous_tokens_per_sec", "value", 0),
                   "serve_continuous_tokens_per_sec.value missing/nonpositive"),
    "side_timing": (_set("serve_static_tokens_per_sec", "timing", "single_window"),
                    "not measured under the interleaved A/B protocol"),
    "no_speedup": (_drop("serve_continuous_over_static_throughput"),
                   "missing serve_continuous_over_static_throughput"),
    "ratios": (_set("serve_continuous_over_static_throughput", "per_trial_ratios", [1.3]),
               "speedup per_trial_ratios missing/too few"),
    "noise_flag": (_delete("serve_continuous_over_static_throughput", "noise_bound"),
                   "speedup noise_bound missing"),
    "speedup_value": (_set("serve_continuous_over_static_throughput", "value", -1.0),
                      "speedup value missing/nonpositive"),
    "gate": (_set("serve_continuous_over_static_throughput", "gate", 1.2), "speedup gate != "),
    "provenance": (_set("serve_continuous_over_static_throughput", "provenance", ""),
                   "speedup missing provenance"),
    "below_gate": (_set("serve_continuous_over_static_throughput", "value", 1.1),
                   "below the 1.3x gate without a noise_bound flag"),
    "no_ledger": (_drop("serve_ledger_classes"), "missing serve_ledger_classes record"),
    "class_not_fed": (_nested("serve_ledger_classes", "classes", "weight_load", 0.0),
                      "serving ledger class `weight_load` not fed"),
    "goodput": (_set("serve_ledger_classes", "goodput_fraction", 1.5),
                "goodput_fraction missing/out of range"),
}


def test_valid_record_and_gate_constants_equal_jax():
    assert (SERVE_BENCH_SCHEMA, SERVE_SPEEDUP_GATE) == (jschema.SERVE_BENCH_SCHEMA,
                                                        jschema.SERVE_SPEEDUP_GATE)
    assert validate_serve_bench(_valid()) == jschema.validate_serve_bench(_valid()) == []
    smoke = _valid()
    _by(smoke, "serve_bench_schema")["smoke"] = True
    _by(smoke, "serve_continuous_over_static_throughput")["value"] = 1.1
    assert validate_serve_bench(smoke) == jschema.validate_serve_bench(smoke) == []


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_each_problem_named_as_jax_names_it(name):
    mutate, fragment = MUTATIONS[name]
    bad = mutate(copy.deepcopy(_valid()))
    problems = validate_serve_bench(copy.deepcopy(bad))
    assert problems == jschema.validate_serve_bench(copy.deepcopy(bad))
    assert any(fragment in p for p in problems), problems


DIMS = dict(vocab_size=61, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq_len=64)


def test_record_from_the_ports_engine_validates():
    bt.init_process_group(device="cpu")
    from bagua_tpu_torch.obs import spans as obs_spans

    obs_spans.set_enabled(True)
    obs_ledger.install()
    obs_ledger.ledger.reset()
    try:
        model = bt.TransformerLM(bt.TransformerConfig(**DIMS, dtype=torch.float32), device="cpu")
        with tempfile.TemporaryDirectory() as tmp:
            save_serving_artifact(tmp, model, step=1)
            step, params = load_serving_params(tmp, model)
        assert step == 1
        conf = ServeConfig(max_slots=3, page_size=8, num_pages=2 + 3 * 8, queue_depth=64,
                           prefill_chunk=8, tick_idle_s=0.001)
        rng = np.random.RandomState(0)
        trace, t = [], 0.0
        for _ in range(6):
            t += float(rng.exponential(0.002))
            trace.append((t, rng.randint(0, 61, size=int(rng.randint(4, 20))).astype(np.int32),
                          int(rng.randint(2, 10))))
        done = ServeEngine(model, None, conf).run(trace)
        backlog = [(0.0, p, n) for _, p, n in trace]
        ab = interleaved_ab(
            lambda: chip_smoke.serve_throughput(model, conf, backlog, False),
            lambda: chip_smoke.serve_throughput(model, conf, backlog, True), trials=3)
        records = chip_smoke.serve_bench_records(
            done, ab, obs_ledger.ledger.report(), conf, model.cfg, torch.device("cpu"),
            {"seed": 0, "mean_interarrival_s": 0.002, "n_latency_requests": len(done),
             "n_throughput_requests": len(backlog)})
        assert validate_serve_bench(records) == jschema.validate_serve_bench(records) == []
        assert _by(records, "serve_bench_schema")["smoke"] is True
        assert len(_by(records, "serve_continuous_over_static_throughput")
                   ["per_trial_ratios"]) == 3
    finally:
        obs_ledger.ledger.reset()
        obs_spans.set_enabled(None)
