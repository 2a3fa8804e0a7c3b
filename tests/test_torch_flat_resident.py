"""The port's flat-resident training state
(``BaguaTrainer(flat_resident=...)``) against its leaf layout and against the
JAX package.

Mirrors the portable tests of ``tests/test_flat_resident.py`` (the
checkpoint and ``fuse_optimizer`` ones wait for those modules):

- Flat against leaf for GradientAllReduce (SGD with momentum), ZeRO (Adam),
  QAdam and ByteGrad, accumulation 1 and 2: bitwise at world 1 (the
  resident gradient flat is what the leaf layout's flatten would build, and
  the elementwise updates do the same arithmetic on each element) and on
  two gloo ranks (``tests/workers/torch_features_worker.py``; gloo sums the
  same two values in either layout, ByteGrad's codec gets the same bucket
  flats); each layout within 1e-5 relative of the JAX trainer's losses
  (1e-3 for QAdam and ByteGrad, whose codecs can move a level on a one-ulp
  difference, as ``tests/test_torch_compressed.py``).  The gossip families
  and ZeRO at world 2: the two layouts bitwise, against JAX within 1e-5
  (low precision: 1e-3).
- ``auto`` engages on a supporting family and ``off`` keeps each parameter's
  own storage; a shape-aware optimizer (``torch.optim.Adafactor``) keeps
  ``auto`` on the leaf layout and makes ``on`` raise; ``on`` on async model
  average raises at construction.
- A rebucket mid-run with AdamW, and with tracked peer weights, migrates the
  state onto the new plan (the optimizer's state on the new flats) and
  leaves the losses and parameters bitwise those of the run without it.
- ``relayout_flats`` against the JAX package's on the same inputs; eval and
  ``unstack_params`` under residency.
- Port-only: the parameters keep their identity, their storage and
  ``.grad`` lie in the bucket flats after a step and after a rebucket, and
  ZeRO's chunk tensors share storage with the parameter flats.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bench
import bagua_tpu_torch as bt
from bagua_tpu.algorithms import ByteGradAlgorithm as JByteGrad
from bagua_tpu.algorithms import DecentralizedAlgorithm as JDecentralized
from bagua_tpu.algorithms import GradientAllReduceAlgorithm as JGA
from bagua_tpu.algorithms import LowPrecisionDecentralizedAlgorithm as JLowPrec
from bagua_tpu.algorithms import QAdamAlgorithm as JQAdam
from bagua_tpu.algorithms import ZeroOptimizerAlgorithm as JZero
from bagua_tpu.bucket import BucketPlan as JPlan
from bagua_tpu.bucket import relayout_flats as jrelayout_flats
from bagua_tpu.core.backend import BaguaTrainer as JTrainer
from bagua_tpu.parallel.mesh import build_mesh
from bagua_tpu.tensor import NamedParam as JNamedParam
from bagua_tpu_torch.bucket import BucketPlan, relayout_flats, split_bucket_by_bucket_size
from bagua_tpu_torch.models.convert import params_from_jax
from bagua_tpu_torch.models.mlp import MLP
from bagua_tpu_torch.tensor import NamedParam

from workers import torch_features_worker as features

torch.set_num_threads(1)

SGD = functools.partial(torch.optim.SGD, lr=0.1)
SGD_MOMENTUM = functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9)
ADAM = functools.partial(torch.optim.Adam, lr=1e-2)
ADAMW = functools.partial(torch.optim.AdamW, lr=1e-2)
#: worker base -> (port algorithm and optimizer at world 1, JAX algorithm and
#: optimizer, tolerance against JAX)
FAMILIES = {
    "ga_momentum": (bt.GradientAllReduceAlgorithm, SGD_MOMENTUM, JGA,
                    optax.sgd(0.1, momentum=0.9), 1e-5),
    "zero_adam": (lambda: bt.ZeroOptimizerAlgorithm(ADAM), None,
                  lambda: JZero(optax.adam(1e-2)), None, 1e-5),
    "qadam": (lambda: bt.QAdamAlgorithm(warmup_steps=2, lr=1e-2, hierarchical=False), None,
              lambda: JQAdam(warmup_steps=2, lr=1e-2, hierarchical=False), None, 1e-3),
    "bytegrad": (lambda: bt.ByteGradAlgorithm(hierarchical=False), SGD,
                 lambda: JByteGrad(hierarchical=False), optax.sgd(0.1), 1e-3),
    "dec_all": (lambda: bt.DecentralizedAlgorithm(hierarchical=False, track_peer_weights=True),
                SGD, lambda: JDecentralized(hierarchical=False), optax.sgd(0.1), 1e-5),
    "lowprec": (lambda: bt.LowPrecisionDecentralizedAlgorithm(hierarchical=False), SGD,
                lambda: JLowPrec(hierarchical=False), optax.sgd(0.1), 1e-3),
}
STEPS = 4
_RUNS = {}


@pytest.fixture(scope="module", autouse=True)
def process_group():
    bt.init_process_group(device="cpu")


def _golden_batch():
    _, params, batch = bench.golden_task()
    return params, {"x": torch.from_numpy(np.array(batch["x"])),
                    "y": torch.from_numpy(np.array(batch["y"]).astype(np.int64))}


def _ce(m, b):
    return torch.nn.functional.cross_entropy(m(b["x"]), b["y"])


def _train(algo, opt, mode, accum=1, steps=STEPS, rebucket_at=None, **kw):
    params, batch = _golden_batch()
    model = MLP(4, features=(32, 8), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), model))
    trainer = bt.BaguaTrainer(_ce, opt, algo(), device="cpu", bucket_bytes=256,
                              flat_resident=mode, accum_steps=accum, **kw)
    state = trainer.init(model)
    losses = []
    for i in range(steps):
        if i == rebucket_at:
            decls = [t.declaration() for b in trainer.plan.buckets for t in b.tensors]
            old = trainer.plan.signature()
            trainer.rebucket(split_bucket_by_bucket_size(decls, 64))
            assert trainer.plan.signature() != old
            assert trainer._pending_state_migration is not None
        state, loss = trainer.train_step(state, batch)
        losses.append(loss.item())
    return np.array(losses), state, trainer


def _jax_losses(base, world, accum=1, steps=STEPS, mode="off"):
    loss_fn, params, batch = bench.golden_task()
    _, _, jalgo, jopt, _ = FAMILIES[base]
    trainer = JTrainer(loss_fn, jopt, jalgo(),
                       mesh=build_mesh({"dp": world}, jax.devices()[:world]),
                       autotune=False, accum_steps=accum, flat_resident=mode)
    state = trainer.init(params)
    losses = []
    for _ in range(steps):
        state, loss = trainer.train_step(state, batch)
        losses.append(float(loss))
    return np.array(losses)


def _assert_same_params(ta, sa, tb, sb):
    pa, pb = ta.unstack_params(sa), tb.unstack_params(sb)
    assert set(pa) == set(pb)
    for n in pa:
        assert torch.equal(pa[n], pb[n]), n


def _gap(got, want):
    return float(np.max(np.abs(got - want) / np.abs(want)))


# ---- step equality: flat-resident against leaf ------------------------------


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("base", ["ga_momentum", "zero_adam", "qadam", "bytegrad"])
def test_flat_matches_leaf(base, accum):
    algo, opt, _, _, tol = FAMILIES[base]
    l_leaf, s_leaf, t_leaf = _train(algo, opt, "off", accum)
    l_flat, s_flat, t_flat = _train(algo, opt, "on", accum)
    assert t_flat._flat_resident and not t_leaf._flat_resident
    np.testing.assert_array_equal(l_flat, l_leaf)
    _assert_same_params(t_flat, s_flat, t_leaf, s_leaf)
    assert _gap(l_flat, _jax_losses(base, 1, accum)) <= tol


def _two_ranks(tmp_path_factory):
    if "runs" not in _RUNS:
        runs = [f"{b}{a}{m}" for b in ("ga_momentum", "zero_adam", "qadam", "bytegrad")
                for a in ("", ":accum=2") for m in ("", ":leaf")]
        runs += [f"{b}{m}" for b in ("dec_all", "lowprec") for m in ("", ":leaf")]
        _RUNS["runs"] = features.spawn(2, runs, tmp_path_factory.mktemp("flat2"), STEPS)
    return _RUNS["runs"]


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("base", ["ga_momentum", "zero_adam", "qadam", "bytegrad"])
def test_flat_matches_leaf_on_two_ranks(base, accum, tmp_path_factory):
    outs = _two_ranks(tmp_path_factory)
    run = base + ("" if accum == 1 else f":accum={accum}")
    for o in outs:
        assert o[f"{run}/resident"] and not o[f"{run}:leaf/resident"]
        for key in ("losses", "dense_0.kernel", "dense_0.bias", "dense_1.kernel", "dense_1.bias"):
            np.testing.assert_array_equal(o[f"{run}/{key}"], o[f"{run}:leaf/{key}"])
            np.testing.assert_array_equal(o[f"{run}/{key}"], outs[0][f"{run}/{key}"])
    assert _gap(outs[0][f"{run}/losses"], _jax_losses(base, 2, accum)) <= FAMILIES[base][-1]


@pytest.mark.parametrize("base", ["dec_all", "lowprec", "zero_adam"])
def test_flat_matches_leaf_gossip_and_zero(base, tmp_path_factory):
    outs = _two_ranks(tmp_path_factory)
    for o in outs:
        assert o[f"{base}/resident"]
        for key in ("losses", "dense_0.kernel", "dense_1.bias"):
            np.testing.assert_array_equal(o[f"{base}/{key}"], o[f"{base}:leaf/{key}"])
    if base == "dec_all":
        np.testing.assert_array_equal(outs[0]["dec_all/trace/peer_weights"],
                                      outs[0]["dec_all:leaf/trace/peer_weights"])
    assert _gap(outs[0][f"{base}/losses"], _jax_losses(base, 2)) <= FAMILIES[base][-1]


def test_auto_engages_and_off_reproduces_leaf():
    _, s_auto, t_auto = _train(bt.GradientAllReduceAlgorithm, SGD, "auto", steps=1)
    assert t_auto._flat_resident
    _, s_off, t_off = _train(bt.GradientAllReduceAlgorithm, SGD, "off", steps=1)
    assert not t_off._flat_resident and t_off._flats is None
    # every parameter keeps a storage of its own
    ptrs = {p.untyped_storage().data_ptr() for p in s_off.model.parameters()}
    assert len(ptrs) == len(list(s_off.model.parameters()))
    _assert_same_params(t_auto, s_auto, t_off, s_off)


def test_auto_falls_back_to_leaf_for_shape_aware_optimizer():
    shape_aware = functools.partial(torch.optim.Adafactor, lr=1e-2)
    _, state, trainer = _train(bt.GradientAllReduceAlgorithm, shape_aware, "auto", steps=1)
    assert not trainer._flat_resident
    with pytest.raises(ValueError, match="commute with flattening"):
        _train(bt.GradientAllReduceAlgorithm, shape_aware, "on", steps=1)
    with pytest.raises(ValueError, match="flat_resident='on'"):
        bt.BaguaTrainer(_ce, SGD, bt.AsyncModelAverageAlgorithm(), device="cpu",
                        flat_resident="on")
    with pytest.raises(ValueError, match="flat_resident must be"):
        bt.BaguaTrainer(_ce, SGD, bt.GradientAllReduceAlgorithm(), device="cpu",
                        flat_resident="sometimes")


# ---- re-bucket migration ----------------------------------------------------


def test_rebucket_migrates_resident_state():
    base, s_base, t_base = _train(bt.GradientAllReduceAlgorithm, ADAMW, "on", steps=6)
    losses, state, trainer = _train(bt.GradientAllReduceAlgorithm, ADAMW, "on", steps=6,
                                    rebucket_at=3)
    assert len(trainer.plan.buckets) != len(t_base.plan.buckets)
    assert trainer._pending_state_migration is None
    np.testing.assert_array_equal(losses, base)
    _assert_same_params(trainer, state, t_base, s_base)
    # the optimizer's state lives on the new plan's flats
    opt = state.optimizer
    group = opt.param_groups[0]["params"]
    assert len(group) == len(trainer._flats) and all(a is b for a, b in zip(group, trainer._flats))
    assert {id(f) for f in opt.state} == {id(f) for f in trainer._flats}
    for f, b in zip(trainer._flats, trainer.plan.buckets):
        assert opt.state[f]["exp_avg"].shape == opt.state[f]["exp_avg_sq"].shape == (
            b.padded_numel,)
        assert float(opt.state[f]["step"]) == 6


def test_rebucket_migrates_owned_optimizer_state():
    """QAdam owns its optimizer: its two moments, one flat a bucket under
    residency, move onto the new plan with the parameters."""
    fac = FAMILIES["qadam"][0]
    base, s_base, t_base = _train(fac, None, "on", steps=6)
    losses, state, trainer = _train(fac, None, "on", steps=6, rebucket_at=3)
    np.testing.assert_array_equal(losses, base)
    _assert_same_params(trainer, state, t_base, s_base)
    for moments in state.opt_state:
        assert [m.numel() for m in moments] == [b.padded_numel for b in trainer.plan.buckets]


def test_rebucket_migrates_gossip_peer_state():
    fac = functools.partial(bt.DecentralizedAlgorithm, hierarchical=False,
                            track_peer_weights=True, communication_interval=2)
    base, s_base, t_base = _train(fac, SGD, "on", steps=6)
    losses, state, trainer = _train(fac, SGD, "on", steps=6, rebucket_at=3)
    np.testing.assert_array_equal(losses, base)
    _assert_same_params(trainer, state, t_base, s_base)
    peers = state.algo_state["peer_weights"]
    assert [p.numel() for p in peers] == [b.padded_numel for b in trainer.plan.buckets]
    want = relayout_flats(t_base.plan, trainer.plan, s_base.algo_state["peer_weights"])
    for a, b in zip(peers, want):
        assert torch.equal(a, b)


def test_rebucket_refuses_sharded_optimizer_state():
    _, _, trainer = _train(lambda: bt.ZeroOptimizerAlgorithm(ADAM), None, "on", steps=1)
    decls = [t.declaration() for b in trainer.plan.buckets for t in b.tensors]
    with pytest.raises(ValueError, match="cannot rebucket"):
        trainer.rebucket(split_bucket_by_bucket_size(decls, 1024))


# ---- relayout_flats ---------------------------------------------------------


def _plans(a_shape=(3,)):
    a = NamedParam("a", a_shape, torch.float32)
    b = NamedParam("b", (2, 2), torch.float32)
    return BucketPlan.build([a, b], 1024, alignment=8), BucketPlan.build([a, b], 4, alignment=4)


def test_relayout_flats_rejects_resized_tensors():
    one, _ = _plans((3,))
    two, _ = _plans((4,))
    flats = one.flatten({"a": torch.arange(3.0), "b": torch.zeros(2, 2)})
    with pytest.raises(ValueError, match="sizes differ"):
        relayout_flats(one, two, flats)
    missing = BucketPlan.build([NamedParam("c", (3,), torch.float32)], 1024)
    with pytest.raises(ValueError, match="misses tensors"):
        relayout_flats(one, missing, flats)


def test_relayout_flats_unit():
    """Segments move by name, old padding dropped, new padding zero, leading
    axes kept; equal to the JAX package's relayout on the same inputs."""
    one, two = _plans()
    assert len(one.buckets) == 1 and len(two.buckets) == 2
    tree = {"a": torch.arange(3.0), "b": torch.arange(4.0).reshape(2, 2) + 10}
    flats_one = one.flatten(tree)
    flats_two = relayout_flats(one, two, flats_one)
    for got, want in zip(flats_two, two.flatten(tree)):
        assert torch.equal(got, want)
    back = relayout_flats(two, one, flats_two)
    assert torch.equal(back[0], flats_one[0])
    stacked = [torch.stack([f, f * 2]) for f in flats_one]
    for got, want in zip(relayout_flats(one, two, stacked), flats_two):
        assert torch.equal(got[0], want) and torch.equal(got[1], want * 2)
    jparams = [JNamedParam("a", (), (3,), np.dtype("float32")),
               JNamedParam("b", (), (2, 2), np.dtype("float32"))]
    jone = JPlan.build(jparams, bucket_bytes=1024, alignment=8)
    jtwo = JPlan.build(jparams, bucket_bytes=4, alignment=4)
    jflats = jrelayout_flats(jone, jtwo, [jnp.asarray(f.numpy()) for f in flats_one])
    for got, want in zip(flats_two, jflats):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- eval, leaf views, identity ---------------------------------------------


def test_eval_and_unstack_under_flat_residency():
    _, state, trainer = _train(bt.GradientAllReduceAlgorithm, SGD, "on", steps=2)
    _, batch = _golden_batch()
    e = trainer.eval_step(state, batch).item()
    assert np.isfinite(e)
    leaves = trainer.unstack_params(state)
    assert set(leaves) == {n for n, _ in state.model.named_parameters()}
    reflat = trainer.plan.flatten(leaves)
    for a, b in zip(reflat, trainer._flats):
        assert torch.equal(a, b.detach())
    # a copy: the next step leaves it as it was
    before = {n: t.clone() for n, t in leaves.items()}
    trainer.train_step(state, batch)
    for n in leaves:
        assert torch.equal(leaves[n], before[n])


def _in_flat(t, flat):
    start = flat.data_ptr()
    end = start + flat.numel() * flat.element_size()
    return start <= t.data_ptr() < end


def test_views_keep_identity_after_step_and_rebucket():
    _, state, trainer = _train(bt.GradientAllReduceAlgorithm, ADAMW, "on", steps=2)
    params = dict(state.model.named_parameters())
    ids = {n: id(p) for n, p in params.items()}

    def check():
        bucket_of = {t.name: i for i, b in enumerate(trainer.plan.buckets) for t in b.tensors}
        for n, p in state.model.named_parameters():
            assert id(p) == ids[n]
            i = bucket_of[n]
            assert _in_flat(p, trainer._flats[i]) and _in_flat(p.grad, trainer._grad_flats[i]), n
        for f, b in zip(trainer._flats, trainer.plan.buckets):
            assert torch.count_nonzero(f.detach()[b.numel:]) == 0

    check()
    decls = [t.declaration() for b in trainer.plan.buckets for t in b.tensors]
    trainer.rebucket(split_bucket_by_bucket_size(decls, 64))
    assert len(trainer.plan.buckets) == 3
    _, batch = _golden_batch()
    state, _ = trainer.train_step(state, batch)
    check()


def test_zero_chunks_share_storage_with_the_parameter_flats():
    _, state, trainer = _train(lambda: bt.ZeroOptimizerAlgorithm(ADAM), None, "on", steps=2)
    assert trainer._flat_resident
    for chunk, flat in zip(state.opt_state.chunks, trainer._flats):
        assert chunk.untyped_storage().data_ptr() == flat.untyped_storage().data_ptr()
    # the leaf layout's chunks are copies: no parameter shares their storage
    _, s_leaf, _ = _train(lambda: bt.ZeroOptimizerAlgorithm(ADAM), None, "off", steps=2)
    params = {p.untyped_storage().data_ptr() for p in s_leaf.model.parameters()}
    assert not params & {c.untyped_storage().data_ptr() for c in s_leaf.opt_state.chunks}


def test_flat_resident_env_knob(monkeypatch):
    monkeypatch.setenv("BAGUA_FLAT_RESIDENT", "off")
    _, _, trainer = _train(bt.GradientAllReduceAlgorithm, SGD, None, steps=1)
    assert trainer.flat_resident == "off" and not trainer._flat_resident
    monkeypatch.setenv("BAGUA_FLAT_RESIDENT", "on")
    _, _, trainer = _train(bt.GradientAllReduceAlgorithm, SGD, None, steps=1)
    assert trainer._flat_resident


def test_gradient_flats_grow_bucket_by_bucket():
    """A gradient flat is allocated when the backward reaches its bucket's
    first parameter, as the leaf layout's ``.grad`` are, not before the
    backward: the buckets come in the order of the plan (reversed
    registration, the backward's order)."""
    _, state, trainer = _train(bt.GradientAllReduceAlgorithm, SGD, "on", steps=1)
    seen = []
    hooks = [p.register_hook(lambda g: seen.append(
        sum(f is not None for f in trainer._grad_flats))) for p in state.model.parameters()]
    _, batch = _golden_batch()
    trainer.train_step(state, batch)
    for h in hooks:
        h.remove()
    assert seen[0] == 1 and seen[-1] == len(trainer.plan.buckets) > 1
    assert seen == sorted(seen)
