"""The port's autotune service (``bagua_tpu_torch/service/``).

Mirrors ``tests/test_autotune_service.py`` (cluster-free, over real HTTP
with mock clients and a synthetic score; its trainer case runs the port's
trainer at world 1), and adds parity with the JAX package:

- the same seeded ``BayesianOptimizer`` asks the same points in both
  packages, told the same scores, on the legacy and the v2 spaces;
- the same capabilities build the same v2 knob space (names, bounds,
  choices, conditions, point rendering);
- the same registration and reports give the same recommendations, round
  by round, from both packages' services;
- the port's client drives the JAX package's server and the JAX package's
  client drives the port's (the JSON wire format of
  ``BaguaHyperparameter``, which is a pydantic model there and a dataclass
  here), and the two ``BaguaHyperparameter`` dump and coerce alike.
"""

import json
import math
import threading
import time

import pytest

from bagua_tpu_torch.define import BaguaHyperparameter, TensorDeclaration, TensorDtype
from bagua_tpu_torch.service.autotune_service import (
    AutotuneClient,
    AutotuneService,
    make_server,
)
from bagua_tpu_torch.service.bayesian_optimizer import (
    BayesianOptimizer,
    BoolParam,
    IntParam,
)


def synthetic_score(bucket_size: int, is_hierarchical: bool) -> float:
    """Concave in log2(bucket_size), peaked at 20 MB, small hierarchical
    penalty — same shape as the reference's mock."""
    peak = math.log2(20 * 1024 ** 2)
    x = math.log2(max(bucket_size, 1))
    return 1000.0 - 10.0 * (x - peak) ** 2 - (50.0 if is_hierarchical else 0.0)


def tensor_list(n=20, numel=250_000):
    return [
        TensorDeclaration(name=f"p{i}", num_elements=numel, dtype=TensorDtype.F32)
        for i in range(n)
    ]


def test_bayesian_optimizer_converges():
    opt = BayesianOptimizer(
        [IntParam("x", 10, 31), BoolParam("h")], n_initial_points=8
    )
    f = lambda p: -((p["x"] - 24) ** 2) - (5 if p["h"] else 0)
    for _ in range(50):
        p = opt.ask()
        opt.tell(p, f(p))
    best, _ = opt.best()
    assert abs(best["x"] - 24) <= 2
    assert best["h"] is False


@pytest.fixture()
def service_client():
    service = AutotuneService(
        world_size=2,
        autotune_level=1,
        max_samples=40,
        sampling_confidence_time_s=0.0,
        warmup_time_s=0.0,
        default_bucket_size=10 * 1024 ** 2,
    )
    server = make_server(0, service)
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    client = AutotuneClient("127.0.0.1", port)
    client.wait_until_ready(10)
    yield service, client
    server.shutdown()


def test_autotune_http_end_to_end(service_client):
    service, client = service_client
    decls = [t.model_dump() for t in tensor_list()]
    rsp = client.register_tensors("m", decls)
    hp = BaguaHyperparameter(**rsp["recommended_hyperparameters"])
    assert hp.buckets, "initial bucketing should partition registered tensors"
    names = [t.name for b in hp.buckets for t in b]
    assert sorted(names) == sorted(d["name"] for d in decls)

    train_iter = 0
    completed = False
    # the all-ranks confidence gate admits a sample at most every other
    # round, so allow 2x max_samples rounds plus slack
    for sample in range(120):
        train_iter += 1
        score = synthetic_score(hp.bucket_size, hp.is_hierarchical_reduce)
        for rank in range(2):
            client.report_metrics("m", rank, train_iter, hp.model_dump(), score / 2)
        for rank in range(2):
            rsp = client.ask_hyperparameters("m", rank, train_iter)
        hp = BaguaHyperparameter(**rsp["recommended_hyperparameters"])
        if rsp["is_autotune_completed"]:
            completed = True
            break
    assert completed
    # converged near the synthetic peak (20 MB = 2^~24.3; accept 2^22..2^27)
    assert 2 ** 22 <= hp.bucket_size <= 2 ** 27, hp.bucket_size
    assert hp.is_hierarchical_reduce is False


def test_execution_order_reorders_buckets(service_client):
    service, client = service_client
    decls = [t.model_dump() for t in tensor_list(n=6, numel=100)]
    client.register_tensors("m2", decls)
    order = ["p5", "p3", "p1", "p0", "p2", "p4"]
    spans = [
        {"trace_id": i, "action": "tensor_ready", "tensor_name": n,
         "start_time": i, "end_time": i + 1}
        for i, n in enumerate(order)
    ]
    client.report_tensor_execution_order(spans, model_name="m2")
    task = service._task("m2")
    hp = task.manager.ask_hyperparameters(
        1, task.tensor_list, task.recommended, None
    )
    names = [t.name for b in hp.buckets for t in b]
    assert names == order


def test_same_round_same_recommendation(service_client):
    """All ranks asking at the same train_iter MUST get identical replies,
    else their compiled SPMD programs diverge and collectives deadlock."""
    service, client = service_client
    decls = [t.model_dump() for t in tensor_list(n=8, numel=1000)]
    client.register_tensors("mr", decls)
    for it in range(1, 12):
        for rank in range(2):
            client.report_metrics("mr", rank, it, {}, 100.0)
        replies = [
            client.ask_hyperparameters("mr", rank, it) for rank in range(2)
        ]
        assert replies[0] == replies[1], f"divergent replies at iter {it}"


def test_algorithm_family_tuning():
    """With tune_algorithm on, the optimizer searches over families and the
    best one wins (bytegrad scores higher in this synthetic)."""
    service = AutotuneService(
        world_size=1, autotune_level=1, max_samples=30,
        sampling_confidence_time_s=0.0, warmup_time_s=0.0,
        tune_algorithm=True,
    )
    server = make_server(0, service)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    client = AutotuneClient("127.0.0.1", port)
    client.wait_until_ready(10)
    decls = [t.model_dump() for t in tensor_list(n=8, numel=1000)]
    rsp = client.register_tensors("ma", decls)
    hp = BaguaHyperparameter(**rsp["recommended_hyperparameters"])
    for it in range(1, 40):
        score = 100.0 + (50.0 if hp.algorithm == "bytegrad" else 0.0)
        client.report_metrics("ma", 0, it, hp.model_dump(), score)
        rsp = client.ask_hyperparameters("ma", 0, it)
        hp = BaguaHyperparameter(**rsp["recommended_hyperparameters"])
        if rsp["is_autotune_completed"]:
            break
    assert rsp["is_autotune_completed"]
    assert hp.algorithm == "bytegrad"
    server.shutdown()


def test_trainer_switches_algorithm():
    """Trainer swaps gradient_allreduce -> bytegrad on recommendation and
    keeps training (world 1, the CPU)."""
    import functools

    import torch

    import bagua_tpu_torch as bt
    from bagua_tpu_torch.models.mlp import MLP

    bt.init_process_group(device="cpu")
    g = torch.Generator().manual_seed(0)
    x = torch.randn(16, 4, generator=g)
    y = (x @ torch.randn(4, 8, generator=g)).argmax(-1)

    def loss_fn(m, batch):
        return torch.nn.functional.cross_entropy(m(batch["x"]), batch["y"])

    trainer = bt.BaguaTrainer(loss_fn, functools.partial(torch.optim.SGD, lr=0.1),
                              bt.GradientAllReduceAlgorithm(), device="cpu", autotune=False)
    state = trainer.init(MLP(4, (16, 8), device="cpu"))
    state, l0 = trainer.train_step(state, {"x": x, "y": y})
    trainer._apply_recommendation(BaguaHyperparameter(algorithm="bytegrad"))
    assert trainer.algorithm.name == "bytegrad"
    losses = []
    for _ in range(10):
        state, loss = trainer.train_step(state, {"x": x, "y": y})
        losses.append(float(loss))
    assert losses[-1] < float(l0)


# -- autotune v2: goodput scoring, conditional space, priors-not-pins -----


V2_CAPS = {
    "space": "v2",
    "two_tier": True,
    "ef_ok": True,
    "flat_ok": False,
    "families": ["gradient_allreduce"],
    "flat_families": [],
    "current_algorithm": "gradient_allreduce",
}


def _v2_service_client(**kw):
    service = AutotuneService(
        world_size=kw.pop("world_size", 1),
        autotune_level=1,
        max_samples=kw.pop("max_samples", 20),
        sampling_confidence_time_s=0.0,
        warmup_time_s=0.0,
        **kw,
    )
    server = make_server(0, service)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    client = AutotuneClient("127.0.0.1", port)
    client.wait_until_ready(10)
    return service, client, server


def test_tell_folds_repeated_observations_into_running_mean():
    opt = BayesianOptimizer([IntParam("x", 0, 10)])
    opt.tell({"x": 4}, 1.0)
    opt.tell({"x": 4}, 3.0)
    opt.tell({"x": 4}, 5.0)
    best, mean = opt.best()
    assert best["x"] == 4
    assert mean == pytest.approx(3.0)
    # a single lucky window of a worse config cannot outvote the mean
    opt.tell({"x": 9}, 4.0)
    opt.tell({"x": 9}, 0.0)
    best, mean = opt.best()
    assert best["x"] == 4 and mean == pytest.approx(3.0)


def test_conditional_space_never_varies_inactive_knobs():
    """Sampled points never differ only on a dead knob: while overlap is
    off the chunk coordinates sit at canonical lows, while hierarchical
    reduce is off BOTH tier codecs sit at their canonical first choice
    (the flat comm world spans both mesh axes — no per-tier rings)."""
    from bagua_tpu_torch.service.knob_space import (
        MIN_CHUNK_BYTES_EXP,
        build_knob_space,
    )

    space = build_knob_space(V2_CAPS, tune_algorithm=False)
    assert space is not None
    opt = BayesianOptimizer(space.params, conditions=space.conditions)
    seen = set()
    for _ in range(300):
        p = opt.ask()
        act = space.active(p)
        if p["overlap"] == "off":
            assert not act["overlap_chunk_bytes_intra_2p"]
            assert p["overlap_chunk_bytes_intra_2p"] == MIN_CHUNK_BYTES_EXP
            assert p["overlap_chunk_bytes_inter_2p"] == MIN_CHUNK_BYTES_EXP
        if not p["is_hierarchical_reduce"]:
            assert not act["compress_intra"] and not act["compress_inter"]
            assert p["compress_intra"] == "auto"
            assert p["compress_inter"] == "auto"
            # ...and the rendered recommendation keeps the live values
            # ("" / 0 = keep-current sentinels), never a forced codec
            upd = space.point_to_updates(p)
            assert upd["compress_intra"] == "" and upd["compress_inter"] == ""
        if p["overlap"] == "off":
            assert space.point_to_updates(p)["overlap_chunk_bytes_intra"] == 0
        seen.add(tuple(p[k] for k in space.names()))
        opt.tell(p, 1.0)
    # the space is genuinely explored (not collapsed by canonicalization)
    assert len(seen) > 20


def test_ef_codec_rungs_gated_on_capability():
    from bagua_tpu_torch.service.knob_space import build_knob_space

    gated = build_knob_space({**V2_CAPS, "ef_ok": False}, False)
    open_ = build_knob_space(V2_CAPS, False)
    gated_choices = next(
        p for p in gated.params if p.name == "compress_inter").choices
    open_choices = next(
        p for p in open_.params if p.name == "compress_inter").choices
    assert "onebit_ef" not in gated_choices and "topk" not in gated_choices
    assert "onebit_ef" in open_choices and "topk" in open_choices
    # single-tier mesh: no DCN knobs at all, intra codec unconditional
    single = build_knob_space({**V2_CAPS, "two_tier": False}, False)
    assert not single.has("compress_inter")
    assert not single.has("is_hierarchical_reduce")
    assert single.has("compress_intra")
    assert "compress_intra" not in single.conditions


def test_goodput_outranks_speed():
    """Two-config fixture: the non-hierarchical config steps 2x faster but
    compile-churns half its wall time away (goodput 0.5); the hierarchical
    one is slower but productive (goodput 0.9).  The legacy speed score
    would pick the churner — the v2 fleet-min goodput score must pick the
    slower-but-productive config."""
    service, client, server = _v2_service_client(max_samples=20)
    try:
        decls = [t.model_dump() for t in tensor_list(n=8, numel=1000)]
        rsp = client.register_tensors("gp", decls, capabilities=V2_CAPS)
        task = service._task("gp")
        assert task.manager.space is not None, "capabilities must build v2"
        hp = BaguaHyperparameter(**rsp["recommended_hyperparameters"])
        for it in range(1, 60):
            hier = bool(hp.is_hierarchical_reduce)
            speed = 100.0 if hier else 200.0
            goodput = 0.9 if hier else 0.5
            client.report_metrics(
                "gp", 0, it, hp.model_dump(), speed,
                obs={"goodput_fraction": goodput},
            )
            rsp = client.ask_hyperparameters("gp", 0, it)
            hp = BaguaHyperparameter(**rsp["recommended_hyperparameters"])
            if rsp["is_autotune_completed"]:
                break
        assert rsp["is_autotune_completed"]
        assert hp.is_hierarchical_reduce is True, (
            "controller picked the fast-but-churning config over the "
            "productive one"
        )
    finally:
        server.shutdown()


def test_speed_only_fallback_without_goodput_coverage():
    """Without obs payloads the same fixture falls back to summed speed
    (legacy trainers / obs plane off keep converging)."""
    service, client, server = _v2_service_client(max_samples=16)
    try:
        decls = [t.model_dump() for t in tensor_list(n=8, numel=1000)]
        rsp = client.register_tensors("sp", decls, capabilities=V2_CAPS)
        hp = BaguaHyperparameter(**rsp["recommended_hyperparameters"])
        for it in range(1, 50):
            speed = 200.0 if not hp.is_hierarchical_reduce else 100.0
            client.report_metrics("sp", 0, it, hp.model_dump(), speed)
            rsp = client.ask_hyperparameters("sp", 0, it)
            hp = BaguaHyperparameter(**rsp["recommended_hyperparameters"])
            if rsp["is_autotune_completed"]:
                break
        assert rsp["is_autotune_completed"]
        assert hp.is_hierarchical_reduce is False
    finally:
        server.shutdown()


def test_compress_dcn_hint_is_prior_not_pin_on_v2():
    """On a live v2 search the autopilot's DCN-compression hint primes a
    search point + weights the coordinate — it must NOT pin
    ``recommended.compress_inter`` (the measured goodput keeps the last
    word)."""
    service, client, server = _v2_service_client(max_samples=30)
    try:
        decls = [t.model_dump() for t in tensor_list(n=4, numel=100)]
        client.register_tensors("pr", decls, capabilities=V2_CAPS)
        task = service._task("pr")
        client.report_metrics(
            "pr", -1, 1, {}, 0.0,
            perf_hints=[{"kind": "autopilot_compress_dcn",
                         "codec": "minmax_uint8", "dcn_share": 0.4}],
        )
        # no pin...
        assert task.recommended.compress_inter == ""
        # ...but a warm-start prior carrying the codec under hierarchical
        # reduce, plus exploit weighting toward the DCN codec coordinate
        primed = task.manager.optimizer._primed
        assert primed and primed[0]["compress_inter"] == "minmax_uint8"
        assert primed[0]["is_hierarchical_reduce"] is True
        assert task.manager.optimizer._coord_weights["compress_inter"] > 1.0
        # the primed point is served by the next sampling round: drive
        # rounds until a recommendation carries the codec
        hp = task.recommended
        carried = False
        for it in range(1, 12):
            client.report_metrics("pr", 0, it, hp.model_dump(), 100.0,
                                  obs={"goodput_fraction": 0.8})
            rsp = client.ask_hyperparameters("pr", 0, it)
            hp = BaguaHyperparameter(**rsp["recommended_hyperparameters"])
            if hp.compress_inter == "minmax_uint8" \
                    and hp.is_hierarchical_reduce:
                carried = True
                break
        assert carried, "primed prior never reached a recommendation"
    finally:
        server.shutdown()


def test_invalid_hint_codec_stripped_at_ingest():
    """An unknown codec in a hint is validated ONCE at ingest and
    stripped: no pin, no prior — but the hint still lands (re-measure
    semantics keep working)."""
    service, client, server = _v2_service_client()
    try:
        decls = [t.model_dump() for t in tensor_list(n=4, numel=100)]
        client.register_tensors("bad", decls, capabilities=V2_CAPS)
        task = service._task("bad")
        client.report_metrics(
            "bad", -1, 1, {}, 0.0,
            perf_hints=[{"kind": "autopilot_compress_dcn",
                         "codec": "totally_bogus"}],
        )
        assert task.recommended.compress_inter == ""
        assert not task.manager.optimizer._primed
        assert task.perf_hints_total == 1  # hint itself was recorded
        assert task.perf_hints[-1]["codec"] == ""  # normalized at ingest
    finally:
        server.shutdown()


def test_anomaly_flagged_window_is_remeasured():
    """A window whose obs payload carries the rank-local anomaly flag is
    discarded like a hint-tainted one: the point re-measures once instead
    of scoring the environment."""
    service, client, server = _v2_service_client()
    try:
        decls = [t.model_dump() for t in tensor_list(n=4, numel=100)]
        client.register_tensors("an", decls, capabilities=V2_CAPS)
        task = service._task("an")
        client.report_metrics("an", 0, 1, task.recommended.model_dump(),
                              100.0, obs={"goodput_fraction": 0.9,
                                          "anomaly": True})
        client.ask_hyperparameters("an", 0, 1)
        assert task.n_samples == 0 and task.sample_retried is True
        # clean re-measure window scores normally
        client.report_metrics("an", 0, 2, task.recommended.model_dump(),
                              100.0, obs={"goodput_fraction": 0.9})
        client.ask_hyperparameters("an", 0, 2)
        assert task.n_samples == 1
    finally:
        server.shutdown()


def test_autotune_level_zero_is_passthrough(service_client):
    service, client = service_client
    service.autotune_level = 0
    decls = [t.model_dump() for t in tensor_list(n=4, numel=100)]
    rsp = client.register_tensors("m3", decls)
    first = rsp["recommended_hyperparameters"]
    for it in range(3):
        for rank in range(2):
            rsp = client.ask_hyperparameters("m3", rank, it + 1)
        assert rsp["recommended_hyperparameters"] == first
        assert rsp["is_autotune_completed"] is False


# -- parity with the JAX package -------------------------------------------


def _ask_tell(opt, f, n):
    points = []
    for _ in range(n):
        p = opt.ask()
        points.append(p)
        opt.tell(p, f(p))
    return points, opt.best()


@pytest.mark.parametrize("seed", [0, 5])
def test_seeded_optimizer_asks_the_same_points_as_jax(seed):
    from bagua_tpu.service import bayesian_optimizer as jbo

    from bagua_tpu_torch.service import bayesian_optimizer as tbo

    def f(p):
        return -((p["x"] - 24) ** 2) - (5 if p["h"] else 0) + 0.01 * p["c"]

    def space(mod):
        return mod.BayesianOptimizer(
            [mod.IntParam("x", 10, 31), mod.BoolParam("h"), mod.FloatParam("c", 0.0, 1.0)],
            n_initial_points=6, seed=seed)

    assert _ask_tell(space(tbo), f, 40) == _ask_tell(space(jbo), f, 40)


V2_CASES = [V2_CAPS, {**V2_CAPS, "two_tier": False}, {**V2_CAPS, "ef_ok": False},
            {**V2_CAPS, "flat_ok": True, "families": ["gradient_allreduce", "bytegrad",
                                                      "qadam", "async"],
             "flat_families": ["gradient_allreduce", "bytegrad", "qadam"]}]


@pytest.mark.parametrize("tune_algorithm", [False, True])
@pytest.mark.parametrize("caps", range(len(V2_CASES)))
def test_v2_knob_space_equals_jax(caps, tune_algorithm):
    from bagua_tpu.service.bayesian_optimizer import BayesianOptimizer as JOpt
    from bagua_tpu.service.knob_space import build_knob_space as jbuild

    from bagua_tpu_torch.service.knob_space import build_knob_space

    capabilities = V2_CASES[caps]
    got, want = build_knob_space(capabilities, tune_algorithm), jbuild(capabilities,
                                                                       tune_algorithm)
    assert got.names() == want.names()
    assert [vars(p) for p in got.params] == [vars(p) for p in want.params]
    assert sorted(got.conditions) == sorted(want.conditions)
    opt = BayesianOptimizer(got.params, conditions=got.conditions, seed=3)
    jopt = JOpt(want.params, conditions=want.conditions, seed=3)
    for i in range(60):
        p, q = opt.ask(), jopt.ask()
        assert p == q
        assert got.active(p) == want.active(q)
        assert got.point_to_updates(p) == want.point_to_updates(q)
        opt.tell(p, float(i % 7))
        jopt.tell(q, float(i % 7))


def _drive(service_mod, define_mod, caps, world=2, rounds=30):
    """One scripted search: registration, then per round each rank's
    report (a score from the recommendation, goodput obs when ``caps``) and
    ask; returns every reply, json-normalized."""
    import json

    service = service_mod.AutotuneService(
        world_size=world, autotune_level=1, max_samples=8, sampling_confidence_time_s=0.0,
        warmup_time_s=0.0, default_bucket_size=4096, tune_algorithm=True)
    decls = [{"name": f"p{i}", "num_elements": 100 * (i + 1), "dtype": "f32"}
             for i in range(12)]
    req = {"model_name": "m", "tensor_list": decls}
    if caps is not None:
        req["capabilities"] = caps
    replies = [json.loads(json.dumps(service.register_tensors(req)))]
    hp = define_mod.BaguaHyperparameter(**replies[0]["recommended_hyperparameters"])
    hints = [{"kind": "autopilot_compress_dcn", "codec": "fp8_e4m3", "dcn_share": 0.6},
             {"kind": "autopilot_retune"}]
    for it in range(1, rounds):
        for rank in range(world):
            score = synthetic_score(hp.bucket_size, hp.is_hierarchical_reduce)
            report = {"model_name": "m", "rank": rank, "train_iter": it,
                      "hyperparameters": hp.model_dump(), "speed": score}
            if caps is not None:
                report["obs"] = {"goodput_fraction": score / 2000.0,
                                 "dcn_share": 0.3, "hbm_headroom_bytes": 1e9 - it * 1e7}
            if it == 5 and rank == 0:
                report["perf_hints"] = hints
            service.report_metrics(json.loads(json.dumps(report, default=str)))
            rsp = service.ask_hyperparameters({"model_name": "m", "rank": rank,
                                               "train_iter": it})
            replies.append(json.loads(json.dumps(rsp)))
        hp = define_mod.BaguaHyperparameter(**replies[-1]["recommended_hyperparameters"])
    return replies


@pytest.mark.parametrize("caps", [None, V2_CAPS, {**V2_CAPS, "two_tier": False}])
def test_same_reports_get_the_same_recommendations_as_jax(caps):
    from bagua_tpu import define as jdefine
    from bagua_tpu.service import autotune_service as jservice

    from bagua_tpu_torch import define as tdefine
    from bagua_tpu_torch.service import autotune_service as tservice

    got = _drive(tservice, tdefine, caps)
    want = _drive(jservice, jdefine, caps)
    assert got == want
    assert any(r.get("is_autotune_completed") for r in got)
    assert len({json.dumps(r["recommended_hyperparameters"]["buckets"]) for r in got}) > 1


def _serve(service_mod):
    service = service_mod.AutotuneService(world_size=1, autotune_level=1, max_samples=3,
                                          sampling_confidence_time_s=0.0, warmup_time_s=0.0,
                                          default_bucket_size=1024)
    server = service_mod.make_server(0, service)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return service, server, server.server_address[1]


@pytest.mark.parametrize("direction", ["port_client_jax_server", "jax_client_port_server"])
def test_client_and_server_interoperate_across_packages(direction):
    from bagua_tpu import define as jdefine
    from bagua_tpu.service import autotune_service as jservice

    from bagua_tpu_torch import define as tdefine
    from bagua_tpu_torch.service import autotune_service as tservice

    client_pkg, client_define, server_pkg = (
        (tservice, tdefine, jservice) if direction == "port_client_jax_server"
        else (jservice, jdefine, tservice))
    service, server, port = _serve(server_pkg)
    try:
        client = client_pkg.AutotuneClient("127.0.0.1", port)
        client.wait_until_ready(10)
        decls = [client_define.TensorDeclaration(name=f"w{i}", num_elements=300,
                                                 dtype=client_define.TensorDtype.F32)
                 for i in range(6)]
        rsp = client.register_tensors("x", [d.model_dump() for d in decls],
                                      capabilities=V2_CAPS)
        hp = client_define.BaguaHyperparameter(**rsp["recommended_hyperparameters"])
        assert [[t.name for t in b] for b in hp.buckets]
        assert service._task("x").manager.space is not None
        client.report_tensor_execution_order(
            [{"trace_id": 0, "action": "tensor_ready", "tensor_name": f"w{5 - i}",
              "start_time": i, "end_time": i} for i in range(6)], model_name="x")
        for it in range(1, 12):
            client.report_metrics("x", 0, it, hp.model_dump(), 10.0 + it,
                                  perf_hints=[{"kind": "step_time_anomaly"}] if it == 2
                                  else None, obs={"goodput_fraction": 0.5})
            rsp = client.ask_hyperparameters("x", 0, it)
            hp = client_define.BaguaHyperparameter(**rsp["recommended_hyperparameters"])
            if rsp["is_autotune_completed"]:
                break
        assert rsp["is_autotune_completed"]
        task = service._task("x")
        assert task.n_samples >= 3 and task.perf_hints_total == 1
        assert task.manager.tensor_partial_order["w5"] == 0
    finally:
        server.shutdown()


HP_CASES = [
    {},
    {"buckets": [[{"name": "a", "num_elements": 3, "dtype": "f32"}],
                 [{"name": "b", "num_elements": "4", "dtype": "bf16"}]],
     "bucket_size": 2048.0, "is_hierarchical_reduce": "true", "compress_inter": "onebit_ef"},
    {"algorithm": "qadam", "overlap": "on", "overlap_chunk_bytes": "65536",
     "flat_resident": "off", "is_hierarchical_reduce": 1, "unknown_key": [1, 2]},
]


@pytest.mark.parametrize("case", range(len(HP_CASES)))
def test_hyperparameter_dumps_and_coerces_as_pydantic(case):
    import json

    from bagua_tpu import define as jdefine

    from bagua_tpu_torch import define as tdefine

    got = tdefine.BaguaHyperparameter(**HP_CASES[case])
    want = jdefine.BaguaHyperparameter(**HP_CASES[case])
    assert json.dumps(got.model_dump()) == json.dumps(want.model_dump())
    assert got.model_dump() == want.model_dump()
    # each package rebuilds the other's dump
    assert tdefine.BaguaHyperparameter(**json.loads(json.dumps(want.model_dump()))) == got
    assert jdefine.BaguaHyperparameter(**json.loads(json.dumps(got.model_dump()))) == want
    assert got.update({"bucket_size": 7, "nope": 1}).bucket_size == 7


@pytest.mark.parametrize("bad", [{"bucket_size": 1.5}, {"is_hierarchical_reduce": "maybe"},
                                 {"algorithm": 3},
                                 {"buckets": [[{"name": "a", "num_elements": 1,
                                                "dtype": "f64"}]]},
                                 {"buckets": [["a"]]}])
def test_hyperparameter_refuses_what_pydantic_refuses(bad):
    import pydantic

    from bagua_tpu import define as jdefine

    from bagua_tpu_torch import define as tdefine

    with pytest.raises(pydantic.ValidationError):
        jdefine.BaguaHyperparameter(**bad)
    with pytest.raises(ValueError):
        tdefine.BaguaHyperparameter(**bad)


def test_telemetry_span_matches_jax():
    from bagua_tpu import define as jdefine

    from bagua_tpu_torch import define as tdefine

    d = {"trace_id": 1, "action": "tensor_ready", "tensor_name": "w", "start_time": 5,
         "end_time": "6"}
    assert tdefine.BaguaCoreTelemetrySpan(**d).model_dump() == \
        jdefine.BaguaCoreTelemetrySpan(**d).model_dump()
    with pytest.raises(TypeError):
        tdefine.BaguaCoreTelemetrySpan(trace_id=1)
