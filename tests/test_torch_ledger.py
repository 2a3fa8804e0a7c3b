"""The port's goodput ledger against the JAX package's
(``tests/test_ledger.py``).

- The same sequence of windows into both ledgers, on one fake monotonic
  clock, gives the same report (every class, the wall, the goodput
  fraction, the worst badput class, the window counts): exactly equal, as
  both round to 1e-6 s the same arithmetic.  Conservation holds: the
  classes sum to the wall.
- A rewind moves the step's productive seconds to ``rewind`` in both.
- The span sink books mapped spans once (the outermost owns), the serving
  classes count as goodput, the cards' peak table is NVIDIA's alone.
- The ``python -m bagua_tpu_torch.obs.ledger`` report and ``--check``.
"""

import json
import os

import pytest

from bagua_tpu.obs import ledger as jledger
from bagua_tpu_torch.obs import export as obs_export
from bagua_tpu_torch.obs import ledger as obs_ledger
from bagua_tpu_torch.obs import spans as obs_spans


class FakeClock:
    """A ``time`` stand-in whose ``monotonic()`` the test advances."""

    def __init__(self, t=1000.0):
        self.t = t

    def monotonic(self):
        return self.t

    def sleep(self, s):
        self.t += s


@pytest.fixture()
def clock(monkeypatch):
    c = FakeClock()
    monkeypatch.setattr(obs_ledger, "time", c)
    monkeypatch.setattr(jledger, "time", c)
    return c


#: (op, args): a run with a checkpoint inside a window, a build window, a
#: stall, productive steps, a migration window and a rewind
SEQUENCE = [
    ("advance", 0.5), ("step", 1, 0.5, "compile"),
    ("advance", 0.02), ("class", "checkpoint", 0.01), ("advance", 0.03),
    ("step", 2, 0.05, "productive_step"),
    ("advance", 0.04), ("class", "stall", 0.015), ("step", 3, 0.04, "productive_step"),
    ("advance", 0.06), ("step", 4, 0.06, "state_migration"),
    ("advance", 0.05), ("step", 5, 0.05, "productive_step"),
    ("rewind", 5),
    ("advance", 0.05), ("class", "catchup_sync", 0.02), ("step", 6, 0.05, "productive_step"),
    ("advance", 0.3),
]


def _drive(led, clock):
    for op, *args in SEQUENCE:
        if op == "advance":
            clock.sleep(args[0])
        elif op == "step":
            led.note_step_window(args[0], args[1], args[2])
        elif op == "class":
            led.note_class_window(args[0], args[1])
        elif op == "rewind":
            led.reclassify_step_rewind(args[0])
    return led.report()


def test_same_windows_same_report(clock):
    port = _drive(obs_ledger.GoodputLedger(), clock)
    clock.t = 1000.0
    jax_side = _drive(jledger.GoodputLedger(), clock)
    assert port == jax_side
    total = sum(port["classes"].values())
    assert abs(total - port["wall_s"]) <= 1e-5
    assert port["step_windows"] == 6 and port["rewind_windows"] == 1
    assert port["classes"]["rewind"] == pytest.approx(0.05)
    assert port["worst_badput_class"] == "compile"


def test_rewind_moves_productive_seconds(clock):
    for mod in (obs_ledger, jledger):
        led = mod.GoodputLedger()
        clock.sleep(0.02)
        led.note_step_window(7, 0.02)
        before = led.report()["classes"]["productive_step"]
        led.reclassify_step_rewind(7)
        rep = led.report()
        assert rep["classes"]["rewind"] == pytest.approx(before)
        assert rep["classes"]["productive_step"] == 0.0
        # a never-recorded step moves the last window's size, never invents
        led.reclassify_step_rewind(99)
        assert led.report()["rewind_windows"] == 2


def test_classes_and_peak_table():
    assert obs_ledger.LEDGER_CLASSES == jledger.LEDGER_CLASSES
    assert obs_ledger.GOODPUT_CLASSES == jledger.GOODPUT_CLASSES
    assert obs_ledger.BADPUT_CLASSES == jledger.BADPUT_CLASSES
    assert obs_ledger.SPAN_CLASS_MAP == jledger.SPAN_CLASS_MAP
    assert all(k.startswith("NVIDIA ") for k in obs_ledger.PEAK_TFLOPS_BF16)
    assert set(obs_ledger.PEAK_TFLOPS_BF16) == set(obs_ledger.PEAK_HBM_GBPS)
    assert obs_ledger.peak_flops_for_device_kind("NVIDIA H100 80GB HBM3") == 989e12
    assert obs_ledger.peak_flops_for_device_kind("TPU v5 lite") is None
    assert obs_ledger.peak_flops_for_device_kind("cpu") is None


def test_span_sink_books_the_outermost_span_once():
    obs_spans.set_enabled(True)
    obs_ledger.install()
    obs_ledger.ledger.reset()
    try:
        with obs_spans.trace_span("ckpt/restore"):
            with obs_spans.trace_span("ckpt/verify"):
                pass
        with obs_spans.trace_span("serve/decode"):
            pass
        rep = obs_ledger.ledger.report()
        spans = {s["name"]: s["dur_s"] for s in obs_spans.recorder.snapshot()[-3:]}
        assert rep["classes"]["checkpoint"] == pytest.approx(spans["ckpt/restore"], abs=1e-6)
        assert rep["classes"]["decode"] == pytest.approx(spans["serve/decode"], abs=1e-6)
        assert "decode" not in obs_ledger.BADPUT_CLASSES
    finally:
        obs_ledger.ledger.reset()
        obs_spans.recorder.clear()
        obs_spans.set_enabled(None)


def test_ledger_cli_report_and_check(tmp_path, capsys, clock):
    obs_ledger.ledger.reset()
    obs_export.reset_local_summary()
    try:
        _drive(obs_ledger.ledger, clock)
        export_dir = tmp_path / "export"
        os.makedirs(export_dir)
        obs_export.MetricsExporter(str(export_dir), interval_s=60).export_once()
        rc = obs_ledger.main([str(export_dir), "--check"])
        out = capsys.readouterr().out
        assert rc == 0, out
        assert "goodput" in out and "compile" in out and "conservation holds" in out
        # the JAX package's loader reads the port's export alike
        assert jledger.load_ledger_reports([str(export_dir)])[0]["classes"] == \
            obs_ledger.load_ledger_reports([str(export_dir)])[0]["classes"]
    finally:
        obs_ledger.ledger.reset()


def test_ledger_cli_no_input_and_violation(tmp_path, capsys):
    assert obs_ledger.main([str(tmp_path)]) == 2
    assert "no ledger gauges" in capsys.readouterr().err
    export_dir = tmp_path / "export"
    os.makedirs(export_dir)
    counters = {f"obs/ledger/{c}_s": 10.0 for c in obs_ledger.LEDGER_CLASSES}
    counters["obs/ledger/wall_s"] = 10.0
    counters["obs/goodput_fraction"] = 0.5
    with open(export_dir / "metrics.jsonl", "w") as f:
        f.write(json.dumps({"rank": 0, "time_unix": 0.0, "counters": counters}) + "\n")
    assert obs_ledger.main([str(export_dir), "--check"]) == 1
    assert "exceeds wall" in capsys.readouterr().err


def test_metrics_jsonl_rotation(tmp_path, monkeypatch):
    monkeypatch.setenv("BAGUA_OBS_EXPORT_MAX_BYTES", "200")
    exp = obs_export.MetricsExporter(str(tmp_path), interval_s=60)
    for _ in range(3):
        exp.export_once()
    assert (tmp_path / "metrics.jsonl.1").exists()
    assert len((tmp_path / "metrics.jsonl").read_text().splitlines()) == 1
