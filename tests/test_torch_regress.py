"""The port's bench-trend sentinel against the JAX package's
(``tests/test_regress.py``).

- ``tests/test_regress.py``'s cases through both packages' functions on the
  same records: equal comparisons and trend records (``build_trend`` but
  its ``time_unix`` and ``platform``), equal schema problems.
- Drawn record pairs (metric, value, unit, per-trial ratios, noise flag,
  direction): ``compare_records`` gives the same list from both packages.
- The interleaved A/B protocol (``obs/ab.py``) against ``benchmarks/_ab.py``.
- The CLI's file mode into ``tmp_path``; with no ``--against`` it exits 2
  and writes nothing.
- The CPU probe at one trial returns the metric names of the JAX package's
  records (``BENCH_FLAT.json``, ``EFFICIENCY.json``).
"""

import json
import os

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from bagua_tpu.obs import regress as jregress
from bagua_tpu_torch.obs import ab
from bagua_tpu_torch.obs import regress
from benchmarks import _ab as jab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: ``tests/test_regress.py``'s record sets: (fresh, committed)
CASES = {
    "verdicts": (
        [{"metric": "thr_ok", "value": 95.0}, {"metric": "thr_bad", "value": 70.0},
         {"metric": "thr_up", "value": 130.0}, {"metric": "speed_noisy", "value": 0.7},
         {"metric": "non_numeric", "value": 1.0}, {"metric": "unknown", "value": 1.0}],
        [{"metric": "thr_ok", "value": 100.0, "unit": "samples/s/chip"},
         {"metric": "thr_bad", "value": 100.0, "unit": "img/s/chip"},
         {"metric": "thr_up", "value": 100.0, "unit": "samples/s"},
         {"metric": "speed_noisy", "value": 1.05, "per_trial_ratios": [0.85, 1.1, 1.2],
          "noise_bound": True},
         {"metric": "no_fresh_side", "value": 9.0, "unit": "samples/s"},
         {"metric": "non_numeric", "value": None, "unit": "samples/s"}],
    ),
    "direction_unknown": (
        [{"metric": "flat_fused_adam_hlo_op_ratio", "value": 1.2},
         {"metric": "compile_s", "value": 9.0}, {"metric": "thr", "value": 100.0}],
        [{"metric": "flat_fused_adam_hlo_op_ratio", "value": 0.919,
          "unit": "x (flat/leaf StableHLO op count, fused-adam step)"},
         {"metric": "compile_s", "value": 3.0, "unit": "seconds"},
         {"metric": "thr", "value": 100.0, "unit": "samples/s"}],
    ),
    "spread_ok": ([{"metric": "m", "value": 85.0}],
                  [{"metric": "m", "value": 100.0, "per_trial_ratios": [0.8, 1.2]}]),
    "spread_regressed": ([{"metric": "m", "value": 70.0}],
                         [{"metric": "m", "value": 100.0, "per_trial_ratios": [0.8, 1.2]}]),
    "trend": ([{"metric": "m", "value": 50.0}],
              [{"metric": "m", "value": 100.0, "unit": "samples/s"}]),
    "lower_better": ([{"metric": "fp", "value": 120, "higher_better": False}],
                     [{"metric": "fp", "value": 100, "unit": "bytes", "higher_better": False}]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_compare_and_trend_equal_jax(case):
    fresh, committed = CASES[case]
    ours = regress.compare_records(fresh, committed)
    theirs = jregress.compare_records(fresh, committed)
    assert ours == theirs
    for strict in (False, True):
        a = regress.build_trend(ours, "files", ["X.json"], trials=None, strict=strict,
                                platform=None)
        b = jregress.build_trend(theirs, "files", ["X.json"], trials=None, strict=strict)
        for rec in (a, b):
            rec.pop("time_unix")
            rec.pop("platform")
        assert a == b
        full = regress.build_trend(ours, "files", ["X.json"], None, strict)
        assert regress.validate_bench_trend(full) == jregress.validate_bench_trend(full)


def test_verdicts_as_the_jax_tests_pin_them():
    out = {c["metric"]: c for c in regress.compare_records(*CASES["verdicts"])}
    assert set(out) == {"thr_ok", "thr_bad", "thr_up", "speed_noisy"}
    assert (out["thr_ok"]["verdict"], out["thr_bad"]["verdict"],
            out["thr_up"]["verdict"]) == ("ok", "regressed", "improved")
    assert out["thr_bad"]["ratio"] == 0.7
    assert out["speed_noisy"]["verdict"] == "noise_bound"
    assert out["speed_noisy"]["tolerance"] >= (1.2 - 0.85) / 2
    assert [c["metric"] for c in regress.compare_records(*CASES["direction_unknown"])] == ["thr"]
    assert regress.compare_records(*CASES["spread_ok"])[0]["verdict"] == "ok"
    assert regress.compare_records(*CASES["spread_regressed"])[0]["verdict"] == "regressed"


@pytest.mark.parametrize("mutate", ["empty", "no_schema", "missing_key", "bad_verdict",
                                    "no_comparisons", "not_dict"])
def test_validate_bench_trend_equal_jax(mutate):
    rec = regress.build_trend(regress.compare_records(*CASES["trend"]), "files",
                              ["BENCH_X.json"], trials=None, strict=False)
    assert regress.validate_bench_trend(rec) == []
    assert rec["pass"] is False and rec["regressions"] == ["m"] and rec["advisory"] is True
    bad = json.loads(json.dumps(rec))
    if mutate == "empty":
        bad = {}
    elif mutate == "no_schema":
        bad["schema"] = "x"
    elif mutate == "missing_key":
        bad["comparisons"] = [{"metric": "m"}]
    elif mutate == "bad_verdict":
        bad["comparisons"][0]["verdict"] = "meh"
    elif mutate == "no_comparisons":
        bad["comparisons"] = []
    else:
        bad = [1]
    problems = regress.validate_bench_trend(bad)
    assert problems and problems == jregress.validate_bench_trend(bad)


_metric = st.sampled_from(["a", "b", "c"])
_value = st.one_of(st.none(), st.floats(-10, 1000, allow_nan=False),
                   st.integers(-5, 1000))
_record = st.fixed_dictionaries(
    {"metric": _metric, "value": _value},
    optional={"unit": st.sampled_from(["samples/s", "img/s/chip", "bytes", "seconds", "x"]),
              "per_trial_ratios": st.lists(st.floats(0.1, 3.0, allow_nan=False),
                                           min_size=0, max_size=5),
              "noise_bound": st.booleans(),
              "higher_better": st.booleans(),
              "faster_path": st.sampled_from(["on", "off"])})


@settings(max_examples=150, deadline=None)
@given(fresh=st.lists(_record, max_size=4), committed=st.lists(_record, max_size=4),
       tol=st.floats(0.0, 0.5, allow_nan=False))
def test_compare_records_equal_jax_on_drawn_records(fresh, committed, tol):
    assert (regress.compare_records(fresh, committed, tolerance=tol)
            == jregress.compare_records(fresh, committed, tolerance=tol))


def test_interleaved_ab_equals_the_benchmarks_protocol():
    values = iter([100.0, 110.0, 90.0, 120.0, 105.0, 100.0])

    def side(label):
        return lambda: {"metric": label, "value": next(values),
                        "timing": "best_of_1_trials_min_of_2_windows_x30_steps"}

    a, b, ratios = ab.interleaved_ab(side("a"), side("b"), trials=3)
    values = iter([100.0, 110.0, 90.0, 120.0, 105.0, 100.0])
    ja, jb, jratios = jab.interleaved_ab(side("a"), side("b"), trials=3)
    assert (a, b, ratios) == (ja, jb, jratios)
    assert "interleaved_ab" in a["timing"]
    for rs in ([1.1, 1.3, 0.95], [1.2, 1.3, 1.1], [0.9, 0.8]):
        assert (ab.speedup_record("s", rs, "x/y", faster_path="on")
                == jab.speedup_record("s", rs, "x/y", faster_path="on"))


def _write(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f)


def test_cli_file_mode(tmp_path):
    fresh, committed, out = (tmp_path / n for n in ("fresh.json", "committed.json",
                                                    "trend.json"))
    _write(fresh, [{"metric": "m", "value": 96.0, "unit": "samples/s"}])
    _write(committed, [{"metric": "m", "value": 100.0, "unit": "samples/s"}])
    args = ["--fresh", str(fresh), "--against", str(committed), "--out", str(out)]
    assert regress.main(args) == 0
    rec = json.load(open(out))
    assert regress.validate_bench_trend(rec) == []
    assert rec["mode"] == "files" and rec["pass"] is True and rec["platform"] is None
    _write(fresh, [{"metric": "m", "value": 10.0}])
    assert regress.main(args + ["--strict"]) == 1
    assert regress.main(args) == 0   # advisory default
    _write(fresh, [{"metric": "zzz", "value": 1.0}])
    assert regress.main(args) == 2   # disjoint metrics
    # an efficiency record on either side contributes its trend records
    _write(fresh, {"trend_records": [{"metric": "m", "value": 99.0}]})
    assert regress.main(args) == 0
    assert json.load(open(out))["comparisons"][0]["fresh_value"] == 99.0


def test_cli_without_against_exits_2_and_writes_nothing(tmp_path, capsys):
    fresh = tmp_path / "fresh.json"
    _write(fresh, [{"metric": "m", "value": 1.0, "unit": "samples/s"}])
    before = os.path.getmtime(regress.DEFAULT_OUT) if os.path.exists(regress.DEFAULT_OUT) \
        else None
    listing = sorted(os.listdir(REPO))
    assert regress.main(["--fresh", str(fresh)]) == 2
    assert "--against" in capsys.readouterr().err
    assert sorted(os.listdir(REPO)) == listing
    after = os.path.getmtime(regress.DEFAULT_OUT) if os.path.exists(regress.DEFAULT_OUT) \
        else None
    assert after == before
    assert regress.DEFAULT_OUT.startswith(os.path.join(REPO, "chiprun_out"))


def test_cpu_probe_names_the_jax_records_metrics():
    records = regress.run_quick_probe(trials=1, device="cpu")
    names = [r["metric"] for r in records]
    with open(os.path.join(REPO, "BENCH_FLAT.json")) as f:
        flat = {r["metric"] for r in json.load(f)}
    with open(os.path.join(REPO, "EFFICIENCY.json")) as f:
        eff = {r["metric"] for r in json.load(f)["trend_records"]}
    assert names[:3] == ["flat_mlp_256x256_gradient_allreduce_accum1_off",
                         "flat_mlp_256x256_gradient_allreduce_accum1_on",
                         "flat_speedup_gradient_allreduce_accum1"]
    assert set(names[:3]) <= flat and set(names[3:]) == eff
    assert all("interleaved_ab" in r["timing"] for r in records[:2])
    assert records[0]["config"]["timed_steps"] == 30 and records[0]["config"]["rows"] == 32
    # comparable against themselves: every metric has a known direction
    assert len(regress.compare_records(records, records)) == len(records)
