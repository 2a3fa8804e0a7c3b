"""bagua-lint over the port: each test of ``tests/test_analysis.py`` with
port-shaped fixtures (the AST rules, suppressions, the shrink-only baseline,
the collective log in place of the jaxpr checker, the concurrency and
step-key engines, the lockdep witness), plus: every rule id of the JAX
package's engines mapped to a port rule or to a stated "no counterpart",
``bagua_tpu_torch/`` clean under every static engine, the collective sweep
on four CPU gloo ranks in one spawn, a seeded extra collective flagged, and
the lockdep witness of a real run checked against the static graph."""

import copy
import json
import os
import subprocess
import sys
import textwrap
import threading

import pytest
import torch

import bagua_tpu_torch
from bagua_tpu_torch.analysis import Finding, run_ast_rules
from bagua_tpu_torch.analysis import collective_check as cc
from bagua_tpu_torch.analysis import lockdep as lockdep_mod
from bagua_tpu_torch.analysis.ast_rules import analyze_source
from bagua_tpu_torch.analysis.concurrency import (
    build_program,
    run_concurrency_rules,
    static_lock_graph,
)
from bagua_tpu_torch.analysis.findings import (
    baseline_reasons,
    load_baseline,
    save_baseline,
    split_by_baseline,
)
from bagua_tpu_torch.analysis.suppressions import (
    JAX_RULE_COUNTERPARTS,
    KNOWN_RULE_IDS,
    NO_COUNTERPART,
)
from bagua_tpu_torch.analysis.trace_coherence import run_trace_coherence

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(os.path.abspath(bagua_tpu_torch.__file__))
BACKEND = "bagua_tpu_torch/core/backend.py::BaguaTrainer."


def rules_of(source, path="fixture.py"):
    return [f.rule for f in analyze_source(path, textwrap.dedent(source))]


def _cli(*args, cwd=REPO, env=None, timeout=300):
    return subprocess.run([sys.executable, "-m", "bagua_tpu_torch.analysis", *args],
                          capture_output=True, text=True, cwd=cwd, timeout=timeout,
                          env=env)


@pytest.fixture(scope="module")
def program():
    return build_program([PKG], rel_to=REPO)


@pytest.fixture(scope="module")
def ast_findings():
    return run_ast_rules([PKG], rel_to=REPO)


# ---- AST rule fixtures (positive + negative per rule) ---------------------


def test_host_sync_in_step_positive():
    found = rules_of("""
        import torch

        class Trainer:
            def train_step(self, state, batch):
                loss = self._forward(batch)
                return self._verdict(loss)

            def _verdict(self, loss):
                v = loss.item()
                h = loss.cpu()
                n = loss.tolist()
                torch.cuda.synchronize()
                return float(loss.sum()), v, h, n
    """)
    assert found.count("host-sync-in-step") == 5


def test_host_sync_outside_step_negative():
    # the same calls off the step (an evaluation helper) are fine
    found = rules_of("""
        import torch

        def evaluate(model, x):
            out = model(x)
            torch.cuda.synchronize()
            return float(out.sum()), out.item(), out.cpu().tolist()
    """)
    assert "host-sync-in-step" not in found


def test_host_sync_device_ops_negative():
    found = rules_of("""
        import torch

        class Layer(torch.nn.Module):
            def forward(self, x):
                y = torch.stack([x, x]).sum(0)
                return float(2.0) * y.mean()
    """)
    assert "host-sync-in-step" not in found


def test_raw_env_read_positive():
    found = rules_of("""
        import os
        a = os.environ.get("BAGUA_FIXTURE_X", "1")
        b = os.environ["BAGUA_FIXTURE_Y"]
        c = os.getenv("BAGUA_FIXTURE_Z")
    """)
    assert found.count("raw-env-read") == 3


def test_raw_env_read_negative():
    found = rules_of("""
        import os
        a = os.environ.get("HOME")
        b = os.environ.get("CUDA_VISIBLE_DEVICES", "")
    """)
    assert "raw-env-read" not in found


def test_raw_env_read_env_py_exempt():
    found = [f.rule for f in analyze_source(
        "bagua_tpu_torch/env.py", 'import os\nv = os.environ.get("BAGUA_ANYTHING")\n')]
    assert "raw-env-read" not in found


def test_tracer_leak_has_no_eager_counterpart():
    """JAX's ``tracer-leak`` has nothing to look at in eager torch: mapped to
    no counterpart, with its reason, and no port engine emits it."""
    assert JAX_RULE_COUNTERPARTS["tracer-leak"] is None
    assert "tracer" in NO_COUNTERPART["tracer-leak"]
    assert "tracer-leak" not in KNOWN_RULE_IDS
    found = rules_of("""
        class T:
            def train_step(self, x):
                self.cache = x * 2
                return self.cache
    """)
    assert found == []


def test_py_rng_in_step_positive_and_negative():
    found = rules_of("""
        import random
        import numpy as np

        class Trainer:
            def train_step(self, p):
                a = random.random()
                b = np.random.randn(3)
                rng = np.random.default_rng(0)  # a seeded stream is fine
                return p + a + b.sum() + rng.random()

        seed = random.random()  # host-side RNG is fine
    """)
    assert found.count("py-rng-in-step") == 2


def test_dup_lambda_positive():
    found = rules_of("""
        import torch
        f1 = lambda t: [torch.as_tensor(x)[None] for x in t]
        f2 = lambda t: [torch.as_tensor(x)[None] for x in t]
        f3 = lambda u: [torch.as_tensor(x)[None] for x in u]
    """)
    assert found.count("dup-lambda") == 3


def test_dup_lambda_negative_two_copies_and_trivial():
    found = rules_of("""
        import torch
        f1 = lambda t: [torch.as_tensor(x)[None] for x in t]
        f2 = lambda t: [torch.as_tensor(x)[None] for x in t]
        k1 = lambda p: p
        k2 = lambda p: p
        k3 = lambda p: p
    """)
    assert "dup-lambda" not in found


def test_jax_import_positive():
    found = rules_of("""
        import jax
        import torch
        from flax import linen
        import bagua_tpu.env
        from bagua_tpu import communication
    """)
    assert found.count("jax-import") == 4


def test_per_step_reflatten_positive_optimizer_step():
    # the fused-optimizer shape: a per-dtype concat of the parameters'
    # ravels inside an optimizer's step, which runs in every train step
    found = rules_of("""
        import torch

        class Fused(torch.optim.Optimizer):
            def step(self, closure=None):
                flat = torch.cat([p.grad.reshape(-1) for p in self.params])
                self.inner.step(flat)
    """)
    assert found.count("per-step-reflatten") == 1


def test_per_step_reflatten_positive_train_step():
    found = rules_of("""
        import torch

        class Trainer:
            def train_step(self, params, batch):
                flat = torch.cat([p.view(-1) for p in params])
                return flat.sum()
    """)
    assert found.count("per-step-reflatten") == 1


def test_per_step_reflatten_negative():
    # flatten without concat, concat without flatten, and a standalone
    # helper off the step are idiom; the resident step takes flats as given
    found = rules_of("""
        import torch

        def helper(tensors):
            return torch.cat([t.reshape(-1) for t in tensors])

        class Trainer:
            def train_step(self, flats, batch):
                return sum(f.sum() for f in flats) + self._only_flatten(batch)

            def _only_flatten(self, batch):
                return sum(t.reshape(-1).sum() for t in batch)

            def _only_concat(self, a, b):
                return torch.cat([a, b])
    """)
    assert "per-step-reflatten" not in found


def test_per_step_reflatten_repo_is_clean(ast_findings):
    bad = [(f.path, f.line) for f in ast_findings if f.rule == "per-step-reflatten"]
    assert not bad, bad


def test_unregistered_counter_positive_misspelled():
    found = rules_of("""
        from bagua_tpu_torch.telemetry import counters

        def on_abort():
            counters.incr("comm/abortss")
            counters.set_gauge("async/staleness_maximum", 3)
    """)
    assert found.count("unregistered-counter") == 2


def test_unregistered_counter_incr_many_and_fstring():
    found = rules_of("""
        from bagua_tpu_torch.telemetry import counters

        def on_fire(point):
            counters.incr_many({"obs/flight_dumps": 1,
                                "obs/flite_dumps": 1})
            counters.incr(f"faults/{point}/fired")
            counters.incr(f"faults/{point}/exploded")
    """)
    assert found.count("unregistered-counter") == 2


def test_unregistered_counter_negative():
    found = rules_of("""
        from bagua_tpu_torch.telemetry import counters

        def ok(name):
            counters.incr("comm/aborts")
            counters.set_gauge("async/staleness_max", 2)
            counters.incr_many({"grad_guard/skipped_steps": 1})
            counters.incr(f"faults/{name}/recovered")
            counters.incr("async/round_wait_s")
            counters.incr(name)
    """)
    assert "unregistered-counter" not in found


def test_unregistered_counter_repo_is_clean(ast_findings):
    bad = [(f.path, f.line) for f in ast_findings if f.rule == "unregistered-counter"]
    assert not bad, bad


# ---- suppressions ---------------------------------------------------------


def test_suppression_trailing_and_standalone():
    found = rules_of("""
        import os
        a = os.environ.get("BAGUA_FIXTURE_A")  # bagua: lint-ignore[raw-env-read] -- fixture
        # bagua: lint-ignore[raw-env-read] -- covers the next line
        b = os.environ.get("BAGUA_FIXTURE_B")
        c = os.environ.get("BAGUA_FIXTURE_C")
    """)
    assert found.count("raw-env-read") == 1


def test_suppression_wrong_rule_does_not_apply():
    found = rules_of("""
        import os
        a = os.environ.get("BAGUA_FIXTURE_A")  # bagua: lint-ignore[dup-lambda] -- wrong id
    """)
    assert "raw-env-read" in found


def test_suppression_without_reason_is_reported():
    found = rules_of("""
        import os
        a = os.environ.get("BAGUA_FIXTURE_A")  # bagua: lint-ignore[raw-env-read]
    """)
    assert "bad-suppression" in found
    assert "raw-env-read" in found


# ---- baseline -------------------------------------------------------------


def test_baseline_round_trip_and_shrink_only(tmp_path):
    f1 = Finding("raw-env-read", "a.py", 3, "m", text="x = 1")
    f2 = Finding("raw-env-read", "b.py", 9, "m", text="y = 2")
    path = str(tmp_path / "baseline.json")
    save_baseline(path, [f1, f2], {f1.key(): "deferred: the fixture's reason"})
    baseline = load_baseline(path)
    # every entry carries a reason
    assert baseline_reasons(path)[f1.key()] == "deferred: the fixture's reason"
    assert baseline_reasons(path)[f2.key()]

    new, old, stale = split_by_baseline([f1, f2], baseline)
    assert not new and len(old) == 2 and not stale
    drifted = Finding("raw-env-read", "a.py", 30, "m", text="x = 1")
    new, old, stale = split_by_baseline([drifted, f2], baseline)
    assert not new and not stale
    new, old, stale = split_by_baseline([f1], baseline)
    assert not new and len(stale) == 1
    f3 = Finding("dup-lambda", "c.py", 1, "m", text="f = lambda t: g(t)")
    new, old, stale = split_by_baseline([f1, f2, f3], baseline)
    assert new == [f3]


def test_package_baseline_lives_in_the_package():
    from bagua_tpu_torch.analysis.findings import BASELINE_DEFAULT

    assert os.path.dirname(BASELINE_DEFAULT) == os.path.join(PKG, "analysis")
    with open(BASELINE_DEFAULT) as fh:
        entries = json.load(fh)["findings"]
    assert all(e.get("reason") and not e["reason"].startswith("TODO") for e in entries)


# ---- the package itself is clean -------------------------------------------


def test_package_has_no_unsuppressed_findings(ast_findings):
    assert ast_findings == [], "\n".join(f.render() for f in ast_findings)


def test_cli_exits_zero_on_package():
    out = _cli("bagua_tpu_torch/", "--engine", "ast,concurrency,trace")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 finding(s)" in out.stdout


def test_cli_flags_violations_and_baseline_flow(tmp_path, monkeypatch, capsys):
    from bagua_tpu_torch.analysis.cli import main

    monkeypatch.chdir(tmp_path)
    bad = tmp_path / "bad_module.py"
    bad.write_text('import os\nv = os.environ.get("BAGUA_FIXTURE_CLI")\n')
    base = [str(bad), "--engine", "ast"]
    assert main(base) == 1 and "raw-env-read" in capsys.readouterr().out
    bl = str(tmp_path / "bl.json")
    assert main(base + ["--write-baseline", "--baseline", bl]) == 0
    assert main(base + ["--baseline", bl]) == 0, capsys.readouterr().out
    capsys.readouterr()
    bad.write_text("v = 1\n")
    assert main(base + ["--baseline", bl]) == 1 and "STALE" in capsys.readouterr().out


# ---- the collective log (counterpart of the jaxpr checker) ------------------


def C(op, axes=("dp",), shape=(8,), dtype="float32"):
    return cc.Collective(op, tuple(axes), tuple(shape), dtype)


def test_rank_divergence_flagged():
    # rank 1 posts an allreduce rank 0 never posts: the eager form of a
    # cond branch with a collective
    logs = [[C("allreduce"), C("allgather")], [C("allreduce"), C("allreduce"), C("allgather")]]
    found = cc.check_rank_agreement(logs, context="fx")
    assert [f.rule for f in found] == ["rank-collective-divergence"]


def test_rank_agreement_accepts_matched_logs():
    # the same sequence per group of axes; the interleaving of two groups
    # may differ between ranks (they are separate communicators)
    logs = [[C("allreduce", ("intra",)), C("ppermute", ("inter",)), C("allgather", ("intra",))],
            [C("ppermute", ("inter",)), C("allreduce", ("intra",)), C("allgather", ("intra",))]]
    assert cc.check_rank_agreement(logs) == []


@pytest.fixture(scope="module")
def process_group():
    bagua_tpu_torch.init_process_group(device="cpu")


def test_axis_binding_on_a_recorded_log(process_group):
    from bagua_tpu_torch.communication import get_backend

    comm = get_backend().global_communicator
    with cc.CollectiveRecorder({id(comm): ("dp",)}) as rec:
        comm.allreduce(torch.ones(4))
        comm.allgather(torch.ones(2, 3))
        comm.barrier()
    assert [c.op for c in rec.log] == ["allreduce", "allgather", "barrier"]
    assert rec.log[1] == C("allgather", shape=(2, 3))
    assert rec.log[2].shape == () and rec.log[2].dtype == "none"
    assert cc.check_axis_binding(rec.log, ("dp",)) == []
    bad = cc.check_axis_binding(rec.log, ("inter", "intra"))
    assert {b.rule for b in bad} == {"unbound-mesh-axis"}
    # an unregistered communicator records axes no mesh binds
    with cc.CollectiveRecorder() as rec:
        comm.allreduce(torch.ones(1))
    assert rec.log[0].axes == ("?",)
    # the seam is removed on exit
    from bagua_tpu_torch import communication

    assert communication._COLLECTIVE_RECORDER is None


@pytest.fixture(scope="module")
def sweep_runs():
    """The default sweep (the JAX checker's 11 configurations x accum 1
    and 4) on four gloo ranks in one spawn: each rank's recorded runs."""
    return cc.sweep_ranks()


@pytest.fixture(scope="module")
def sweep(sweep_runs):
    return cc.check_sweep(sweep_runs)


@pytest.mark.parametrize("family", ["gradient_allreduce", "zero", "bytegrad"])
@pytest.mark.parametrize("accum", [1, 4])
def test_overlap_vs_serialized_collective_equivalence(sweep, family, accum):
    findings, reports = sweep
    report = next(r for r in reports if r["family"] == family and r["accum_steps"] == accum)
    assert report["equal"], report
    assert not [f for f in findings if f.text.startswith(f"{family}:accum{accum}")]
    for row in report["serialized"]["buckets"]:
        assert row["collectives"], row


def test_sweep_covers_every_configuration_clean(sweep):
    findings, reports = sweep
    assert findings == [], "\n".join(f.render() for f in findings)
    got = {(r["family"], r["accum_steps"]) for r in reports}
    assert got == {(f, a) for f in cc.DEFAULT_FAMILIES for a in cc.DEFAULT_ACCUM_STEPS}
    for r in reports:
        assert r["equal"]
        for side in ("serialized", "overlap"):
            rows = [row for row in r[side]["buckets"] if isinstance(row["bucket"], int)]
            assert rows and all(row["collectives"] for row in rows), (r["family"], side)
            # the rows account for every byte of the step
            assert sum(row["wire_bytes"] for row in r[side]["buckets"]) == \
                r[side]["total_wire_bytes"]
        # the two-level forms run over the mesh's inter and intra axes
        if ":hier" in r["family"]:
            assert any("[intra]" in c for c in r["serialized"]["collectives"])


def test_readiness_broadcast_is_logged_as_plan_upkeep(sweep):
    """The overlapped first step of a replicated family broadcasts rank 0's
    gradient-readiness order (one int64 per tensor): the plan's upkeep,
    which the JAX package does on the host without a collective.  It is
    logged under the ``plan`` tag, never in the serialized step, never for
    ZeRO (no readiness rebucket), and left out of the multisets."""
    _, reports = sweep
    for r in reports:
        assert r["serialized"]["plan_collectives"] == []
        plan = r["overlap"]["plan_collectives"]
        if r["family"].startswith("zero"):
            assert plan == []
        else:
            assert len(plan) == 1 and plan[0].startswith("broadcast[") and ":int64" in plan[0]


def test_equivalence_catches_seeded_divergence(sweep_runs):
    """A run with one extra collective in its overlapped step is flagged, and
    the rank whose log it is disagrees with the others."""
    ranks = copy.deepcopy(sweep_runs)
    run = next(r for r in ranks[0] if r["family"] == "gradient_allreduce" and r["accum"] == 1
               and r["mode"] == "on")
    run["log"].append(["allreduce", ["dp"], [8], "float32"])
    run["buckets"].append(None)
    findings, reports = cc.check_sweep(ranks)
    assert {(f.rule, f.text.split("/")[0].split(":accum")[0]) for f in findings} >= {
        ("overlap-serialized-divergence", "gradient_allreduce"),
        ("rank-collective-divergence", "gradient_allreduce")}
    assert all(f.text.startswith("gradient_allreduce") for f in findings)
    report = next(r for r in reports if r["family"] == "gradient_allreduce"
                  and r["accum_steps"] == 1)
    assert not report["equal"]


def test_multiset_ignores_order_but_not_shape():
    a = [C("allreduce", shape=(8,)), C("allgather", shape=(4,))]
    b = list(reversed(a))
    assert cc.multiset(a) == cc.multiset(b)
    c = [C("allreduce", shape=(6,)), C("allgather", shape=(4,))]
    assert cc.multiset(a) != cc.multiset(c)
    assert "serialized x1, overlap x0" in cc.diff_multisets(cc.multiset(a), cc.multiset(c))


# ---- concurrency engine ------------------------------------------------------


def _fx(**files):
    """name -> dedented source; ``__`` in a kwarg becomes a path slash."""
    return {k.replace("__", "/") + ".py": textwrap.dedent(v) for k, v in files.items()}


def conc_rules(sources):
    return [f.rule for f in run_concurrency_rules(sources=sources)]


def test_lock_order_inversion_positive():
    rules = conc_rules(_fx(fx__mod="""
        import threading
        A = threading.Lock()
        B = threading.Lock()

        def forward():
            with A:
                with B:
                    pass

        def backward():
            with B:
                with A:
                    pass

        def start():
            threading.Thread(target=backward).start()
    """))
    assert "lock-order-inversion" in rules


def test_lock_order_consistent_negative():
    rules = conc_rules(_fx(fx__mod="""
        import threading
        A = threading.Lock()
        B = threading.Lock()

        def forward():
            with A:
                with B:
                    pass

        def also_forward():
            with A:
                with B:
                    pass

        def start():
            threading.Thread(target=also_forward).start()
    """))
    assert "lock-order-inversion" not in rules


_SHARED = """
    import threading
    _STATE = None
    _LOCK = threading.Lock()

    def init():
        global _STATE
        with _LOCK:
            _STATE = 1

    def override(v):
        global _STATE
        _STATE = v

    def bg():
        init()

    def start():
        threading.Thread(target=bg).start()
"""


def test_unguarded_shared_write_positive():
    assert "unguarded-shared-write" in conc_rules(_fx(fx__mod=_SHARED))


def test_unguarded_shared_write_common_lock_negative():
    guarded = _SHARED.replace("        global _STATE\n        _STATE = v",
                              "        global _STATE\n        with _LOCK:\n            _STATE = v")
    assert "unguarded-shared-write" not in conc_rules(_fx(fx__mod=guarded))


def test_unguarded_shared_write_single_root_negative():
    rules = conc_rules(_fx(fx__mod="""
        _STATE = None

        def init():
            global _STATE
            _STATE = 1

        def override(v):
            global _STATE
            _STATE = v
    """))
    assert "unguarded-shared-write" not in rules


def test_lock_held_io_positive_and_negative():
    src = """
        import threading
        import time
        _L = threading.Lock()

        def slow():
            with _L:
                time.sleep(1.0)

        def fast():
            with _L:
                x = 1
                return x

        def start():
            threading.Thread(target=slow).start()
    """
    assert "lock-held-io" in conc_rules(_fx(fx__mod=src))
    single = src.replace("threading.Thread(target=slow).start()", "slow()")
    assert "lock-held-io" not in conc_rules(_fx(fx__mod=single))


def test_signal_unsafe_lock_positive_sigterm_dump():
    rules = conc_rules(_fx(fx__rec="""
        import signal
        import threading
        _DUMP_LOCK = threading.Lock()

        def dump_flight_record():
            with _DUMP_LOCK:
                pass

        def _on_term(signum, frame):
            dump_flight_record()

        def install():
            signal.signal(signal.SIGTERM, _on_term)
    """))
    assert "signal-unsafe-lock" in rules


def test_signal_flag_defer_negative():
    rules = conc_rules(_fx(fx__rec="""
        import signal
        import threading
        _DUMP_LOCK = threading.Lock()
        _PENDING = threading.Event()

        def dump_flight_record():
            with _DUMP_LOCK:
                pass

        def _on_term(signum, frame):
            _PENDING.set()

        def install():
            signal.signal(signal.SIGTERM, _on_term)

        def maybe_dump():
            if _PENDING.is_set():
                dump_flight_record()
    """))
    assert "signal-unsafe-lock" not in rules


def test_non_reentrant_reacquire_positive_and_rlock_negative():
    src = """
        import threading
        _L = threading.Lock()

        def outer():
            with _L:
                inner()

        def inner():
            with _L:
                pass
    """
    assert "non-reentrant-reacquire" in conc_rules(_fx(fx__mod=src))
    rlock = src.replace("threading.Lock()", "threading.RLock()")
    assert "non-reentrant-reacquire" not in conc_rules(_fx(fx__mod=rlock))


def test_concurrency_suppression_applies():
    suppressed = _SHARED.replace(
        "            _STATE = 1",
        "            _STATE = 1  # bagua: lint-ignore[unguarded-shared-write] -- fixture")
    assert "unguarded-shared-write" not in conc_rules(_fx(fx__mod=suppressed))


def test_package_is_concurrency_and_trace_clean(program):
    """Zero findings from both engines, and the model is not vacuous: it
    sees the port's locks and its own thread roots."""
    conc = run_concurrency_rules(program=program)
    assert conc == [], "\n".join(f.render() for f in conc)
    trace = run_trace_coherence(program=program)
    assert trace == [], "\n".join(f.render() for f in trace)
    assert len(program.locks) >= 10
    roots = " ".join(program.thread_roots)
    for root in ("watchdog.py::HangWatchdog._monitor", "core/overlap.py::_serve",
                 "service/autotune_service.py::_Handler", "obs/http.py::_Handler.do_GET",
                 "obs/recorder.py::dump_flight_record",
                 "elastic/membership.py::LeaseHeartbeat._run"):
        assert root in roots, root
    g = static_lock_graph(program)
    assert "bagua_tpu_torch/obs/spans.py::_ENABLED_LOCK" in set(g["locks"].values())
    # the prover found the anchor and followed construction and the key
    from bagua_tpu_torch.analysis import trace_coherence as tc

    closure = tc._construction_closure(program, BACKEND + "_make_ctx")
    assert BACKEND + "_tiers" in closure
    assert tc._key_expressions(program, BACKEND)
    assert tc._ctx_fields(program, BACKEND)["intra_codec"] == {"compress_intra"}


def test_abort_reason_write_is_suppressed_with_its_reason(program):
    """R2: the lock-free ``_ABORT_REASON`` store carries the JAX package's
    suppression; without it the engine reports the write."""
    path = "bagua_tpu_torch/communication.py"
    src = program.modules[path].source
    assert "lint-ignore[unguarded-shared-write] -- Event-published" in src
    stripped = src.replace(
        "  # bagua: lint-ignore[unguarded-shared-write] -- Event-published; GIL-atomic "
        "store; stale read falls back to \"aborted\"", "")
    watchdog = "bagua_tpu_torch/watchdog.py"
    found = run_concurrency_rules(sources={path: stripped,
                                           watchdog: program.modules[watchdog].source})
    assert any(f.rule == "unguarded-shared-write" and "_ABORT_REASON" in f.message
               for f in found)


def test_spans_set_enabled_holds_the_lock():
    from bagua_tpu_torch.obs import spans

    class Probe:
        def __init__(self):
            self.entered = 0
            self._l = threading.Lock()

        def __enter__(self):
            self.entered += 1
            return self._l.__enter__()

        def __exit__(self, *exc):
            return self._l.__exit__(*exc)

    probe = Probe()
    orig_lock, orig_state = spans._ENABLED_LOCK, spans._ENABLED
    try:
        spans._ENABLED_LOCK = probe
        spans.set_enabled(True)
        assert probe.entered == 1
        assert spans.enabled() is True
    finally:
        spans._ENABLED_LOCK = orig_lock
        spans._ENABLED = orig_state


# ---- step-key coherence -------------------------------------------------------


_TRACE_ENV_FX = """
    import os

    def _raw(name, default):
        return os.environ.get(name, default)

    def get_ratio():
        return float(_raw("BAGUA_FX_RATIO", "0.01"))
"""

#: the port's shape: the trainer caches a context built by _make_ctx and
#: compares a step key; the codec singleton reads its knob at import
_TRACE_PRE_FIX = """
    from .env import get_ratio

    class Codec:
        def __init__(self):
            self.ratio = get_ratio()

    CODECS = {"topk": Codec()}

    def get_codec(name):
        return CODECS[name]

    class Ctx:
        def __init__(self, plan, codec):
            self.plan, self.codec = plan, codec

    class Trainer:
        def __init__(self):
            self.plan = "p"

        def _make_ctx(self):
            return Ctx(plan=self.plan, codec=get_codec("topk"))

        def _refresh_ctx(self):
            self._ctx = self._make_ctx()

        def train_step(self):
            ctx = self._ctx
            key = (ctx.plan,)
            self._step_key = key
"""


def trace_rules(sources):
    return [f.rule for f in run_trace_coherence(sources=sources)]


def test_trace_flags_import_time_env_freeze():
    found = trace_rules(_fx(fx__env=_TRACE_ENV_FX, fx__trainer=_TRACE_PRE_FIX))
    assert "trace-knob-not-keyed" in found


def test_trace_accepts_keyed_knob():
    keyed = _TRACE_PRE_FIX.replace("key = (ctx.plan,)", "key = (ctx.plan, get_ratio())")
    assert trace_rules(_fx(fx__env=_TRACE_ENV_FX, fx__trainer=keyed)) == []


def test_trace_invariant_annotation_suppresses():
    annotated = _TRACE_PRE_FIX.replace(
        'return Ctx(plan=self.plan, codec=get_codec("topk"))',
        'return Ctx(plan=self.plan, codec=get_codec("topk"))  '
        '# bagua: trace-invariant[BAGUA_FX_RATIO] -- fixture: host-side only')
    assert trace_rules(_fx(fx__env=_TRACE_ENV_FX, fx__trainer=annotated)) == []


def test_malformed_trace_invariant_is_reported():
    found = trace_rules(_fx(fx__mod="""
        # bagua: trace-invariant[get_ratio]
        X = 1
    """))
    assert "bad-trace-invariant" in found


_MUTABLE = """
    class Ctx:
        def __init__(self, overlap):
            self.overlap = overlap

    class Trainer:
        def __init__(self):
            self.overlap = "on"

        def _apply_recommendation(self, rec):
            self.overlap = rec

        def _make_ctx(self):
            return Ctx(overlap=self.overlap)

        def _refresh_ctx(self):
            self._ctx = self._make_ctx()

        def train_step(self):
            self._step_key = (1,)
"""


def test_trace_flags_autotune_mutable_attr_not_keyed():
    assert "trace-knob-not-keyed" in trace_rules(_fx(fx__trainer=_MUTABLE))
    # riding the key through the context field _make_ctx fills from it
    keyed = _MUTABLE.replace("self._step_key = (1,)",
                             "self._step_key = (1, self._ctx.overlap)")
    assert trace_rules(_fx(fx__trainer=keyed)) == []
    # or the recommendation path rebuilding the context
    rebuilt = _MUTABLE.replace("            self.overlap = rec\n",
                               "            self.overlap = rec\n            self._refresh_ctx()\n")
    assert trace_rules(_fx(fx__trainer=rebuilt)) == []


def test_trace_flags_transitive_autotune_knob_not_keyed():
    src = """
        class Ctx:
            def __init__(self, flat_resident):
                self.flat_resident = flat_resident

        class Trainer:
            def __init__(self):
                self._flat_resident = False

            def _apply_flat_resident(self, want):
                self._flat_resident = want == "on"

            def _apply_recommendation(self, rec):
                if rec.flat_resident:
                    self._apply_flat_resident(rec.flat_resident)

            def _make_ctx(self):
                return Ctx(flat_resident=self._flat_resident)

            def _refresh_ctx(self):
                self._ctx = self._make_ctx()

            def train_step(self):
                self._step_key = (1,)
    """
    assert "trace-knob-not-keyed" in trace_rules(_fx(fx__trainer=src))
    keyed = src.replace("self._step_key = (1,)", "self._step_key = (1, self._flat_resident)")
    assert trace_rules(_fx(fx__trainer=keyed)) == []


def test_constructor_frozen_attr_is_exempt():
    found = trace_rules(_fx(fx__trainer="""
        class Ctx:
            def __init__(self, donate):
                self.donate = donate

        class Trainer:
            def __init__(self, donate):
                self.donate = donate

            def _apply_recommendation(self, rec):
                pass

            def _make_ctx(self):
                return Ctx(donate=self.donate)

            def _refresh_ctx(self):
                self._ctx = self._make_ctx()

            def train_step(self):
                self._step_key = (1,)
    """))
    assert found == []


# ---- rule ids ------------------------------------------------------------------


def test_unknown_rule_id_suppression_is_reported():
    found = rules_of("""
        import os
        a = os.environ.get("BAGUA_FIXTURE_A")  # bagua: lint-ignore[no-such-rule] -- typo
    """)
    assert "bad-suppression" in found
    assert "raw-env-read" in found


def test_known_rule_ids_match_engine_catalogs():
    from bagua_tpu_torch.analysis.ast_rules import RULES as AST_RULES
    from bagua_tpu_torch.analysis.concurrency import CONCURRENCY_RULES
    from bagua_tpu_torch.analysis.lockdep import LOCKDEP_RULES
    from bagua_tpu_torch.analysis.trace_coherence import TRACE_RULES

    ids = {r.id for r in (list(AST_RULES) + list(CONCURRENCY_RULES) + list(TRACE_RULES)
                          + list(LOCKDEP_RULES))}
    ids |= {"rank-collective-divergence", "unbound-mesh-axis",
            "overlap-serialized-divergence", "bad-suppression", "*"}
    assert ids == set(KNOWN_RULE_IDS)


def test_every_jax_rule_id_is_mapped_or_documented():
    from bagua_tpu.analysis.suppressions import KNOWN_RULE_IDS as JAX_IDS

    assert set(JAX_RULE_COUNTERPARTS) == set(JAX_IDS) - {"*"}
    for jax_id, port_id in JAX_RULE_COUNTERPARTS.items():
        if port_id is None:
            assert NO_COUNTERPART[jax_id], jax_id
        else:
            assert port_id in KNOWN_RULE_IDS, (jax_id, port_id)
    # every port rule answers for some JAX rule
    assert set(KNOWN_RULE_IDS) - {"*"} == {v for v in JAX_RULE_COUNTERPARTS.values() if v}


# ---- lockdep runtime witness ---------------------------------------------------


def test_lockdep_state_records_edges_and_inversions(tmp_path):
    st = lockdep_mod._LockdepState(pkg_dir="/nonexistent", out_path=str(tmp_path / "w.json"))
    a, b = ("m.py", 1), ("m.py", 2)
    la = lockdep_mod._InstrumentedLock(threading.Lock(), a, st)
    lb = lockdep_mod._InstrumentedLock(threading.Lock(), b, st)
    with la:
        with lb:
            pass
    w = st.witness()
    assert {"from": list(a), "to": list(b), "count": 1} in w["edges"]
    assert w["inversions"] == []
    with lb:
        with la:
            pass
    assert len(st.witness()["inversions"]) == 1
    st.dump()
    assert lockdep_mod.load_witness(str(tmp_path / "w.json"))["inversions"]


def test_lockdep_reentrant_reacquire_is_not_an_edge(tmp_path):
    st = lockdep_mod._LockdepState(pkg_dir="/nonexistent", out_path=str(tmp_path / "w.json"))
    la = lockdep_mod._InstrumentedLock(threading.RLock(), ("m.py", 1), st)
    with la:
        with la:
            pass
    w = st.witness()
    assert w["edges"] == [] and w["inversions"] == []


def test_lockdep_cross_check():
    graph = {"locks": {("m.py", 1): "m.py::A", ("m.py", 2): "m.py::B"},
             "edges": {("m.py::A", "m.py::B"): "m.py:10"}}
    clean = {"edges": [{"from": ["m.py", 1], "to": ["m.py", 2], "count": 3}], "inversions": []}
    assert lockdep_mod.cross_check(clean, graph) == []
    inverted = {"edges": [], "inversions": [{"a": ["m.py", 1], "b": ["m.py", 2], "thread": "t"}]}
    assert [f.rule for f in lockdep_mod.cross_check(inverted, graph)] == \
        ["lockdep-runtime-inversion"]
    unmodeled = {"edges": [{"from": ["m.py", 2], "to": ["m.py", 1], "count": 1}],
                 "inversions": []}
    assert [f.rule for f in lockdep_mod.cross_check(unmodeled, graph)] == \
        ["lockdep-unmodeled-edge"]
    foreign = {"edges": [{"from": ["x.py", 9], "to": ["m.py", 1], "count": 1}],
               "inversions": []}
    assert lockdep_mod.cross_check(foreign, graph) == []


def test_lockdep_not_installed_by_default():
    assert lockdep_mod.maybe_install() is (lockdep_mod._STATE is not None)
    assert lockdep_mod._STATE is None


def test_lockdep_witness_of_a_real_run_fits_the_static_graph(tmp_path, program):
    """A process with BAGUA_LOCKDEP=on imports the port (its locks wrap at
    creation), drives the watchdog, the span recorder and the exporter's
    counters, and exits; its witness has no inversion and every edge among
    the package's locks is a static edge."""
    out = tmp_path / "witness.json"
    code = textwrap.dedent("""
        import bagua_tpu_torch
        from bagua_tpu_torch.analysis import lockdep
        from bagua_tpu_torch.obs import spans
        from bagua_tpu_torch.telemetry import counters
        from bagua_tpu_torch.watchdog import HangWatchdog
        assert lockdep._STATE is not None
        spans.set_enabled(True)
        with spans.trace_span("fixture/span"):
            counters.incr("comm/aborts")
        wd = HangWatchdog(timeout_s=30.0, action="abort")
        with wd.watch("fixture"):
            pass
        wd.stop()
    """)
    env = {**os.environ, "BAGUA_LOCKDEP": "on", "BAGUA_LOCKDEP_OUT": str(out),
           "PYTHONPATH": REPO}
    run = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    witness = lockdep_mod.load_witness(str(out))
    assert witness["sites"], witness
    assert witness["inversions"] == []
    assert lockdep_mod.cross_check(witness, static_lock_graph(program)) == []


def test_cli_witness_gates_runtime_inversion(tmp_path, capsys):
    from bagua_tpu_torch.analysis.cli import main

    wit = tmp_path / "wit.json"
    wit.write_text(json.dumps({"edges": [], "inversions": [
        {"a": ["bagua_tpu_torch/telemetry.py", 40],
         "b": ["bagua_tpu_torch/obs/spans.py", 40], "thread": "t"}]}))
    assert main([PKG, "--engine", "concurrency", "--witness", str(wit), "-q"]) == 1
    assert "lockdep-runtime-inversion" in capsys.readouterr().out


def test_cli_list_rules_names_every_jax_rule(capsys):
    from bagua_tpu_torch.analysis.cli import main

    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for jax_id in JAX_RULE_COUNTERPARTS:
        assert f"{jax_id} -> " in out
    assert "tracer-leak -> no counterpart" in out


def test_cli_engine_selection_runs_clean(capsys):
    from bagua_tpu_torch.analysis.cli import main

    assert main([PKG, "--engine", "concurrency,trace", "-q"]) == 0, capsys.readouterr().out


def test_lockdep_wrapped_rlock_serves_a_condition(tmp_path):
    """A Condition over an instrumented RLock (``threading.Condition()`` in
    package code creates one under the shim) waits and is notified."""
    st = lockdep_mod._LockdepState(pkg_dir="/nonexistent", out_path=str(tmp_path / "w.json"))
    cond = threading.Condition(lockdep_mod._InstrumentedLock(threading.RLock(), ("m.py", 1), st))
    ready = []

    def notify():
        with cond:
            ready.append(1)
            cond.notify_all()

    with cond:
        threading.Thread(target=notify).start()
        assert cond.wait_for(lambda: ready, timeout=10)
