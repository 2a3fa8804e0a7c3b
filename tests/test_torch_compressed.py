"""The port's compressed data parallelism against the JAX package.

Collectives: ``tests/workers/torch_comm_worker.py`` runs at 2 and 4 gloo
ranks (spawned processes, CPU tensors, so the plain codec versions); the JAX
side runs the same inputs through ``shard_map`` on a mesh of as many CPU
devices.  A lossy collective must stay within one quantization step of each
rank block of the JAX result (the step of the block's last encode: its
``(max - min) / 255`` for MinMaxUInt8, ``absmax / 127`` for int8, the ulp at
its absmax, ``absmax / 8``, for fp8 e4m3); both sides do the same
IEEE-rounded operations in the same ring order, so in practice they agree
bitwise.  Every rank of an allreduce must hold the same bits.

Trainers: ``tests/workers/torch_trainer_worker.py`` trains the golden task
(``bench.golden_task``, 30 steps) with ByteGrad, QAdam (warmup 2) and
``compress_intra="int8"`` at 2 and 4 gloo ranks from the JAX params, held in
flax's ``[in, out]`` kernel layout so that each codec chunk holds the same
elements on both sides; the JAX trainer runs the same on a 2- and 4-device
mesh.  Losses must agree within 1e-3 relative at every step: XLA and torch
sum the gradients in other orders, and a one-ulp difference can move a value
across a quantization boundary.  (With torch's ``Linear`` layout,
``[out, in]``, a bucket's two halves hold other elements, and QAdam, which
divides the codec's error by a second moment frozen after two steps, ends
1.7% above the JAX trajectory at world size 2; ByteGrad and int8 stay within
3e-4.)
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import bench
import bagua_tpu_torch as bt
from bagua_tpu.algorithms.bytegrad import ByteGradAlgorithm as JByteGrad
from bagua_tpu.algorithms.gradient_allreduce import (
    GradientAllReduceAlgorithm as JGradientAllReduce,
)
from bagua_tpu.algorithms.q_adam import QAdamAlgorithm as JQAdam
from bagua_tpu.communication import BaguaCommunicator as JComm
from bagua_tpu.communication import ReduceOp as JReduceOp
from bagua_tpu.compat import shard_map
from bagua_tpu.compression import compressed_scatter_gather_allreduce as j_sg
from bagua_tpu.core.backend import BaguaTrainer as JTrainer
from bagua_tpu.parallel.mesh import build_mesh
from bagua_tpu_torch.bucket import BucketPlan
from bagua_tpu_torch.models.convert import params_from_jax
from bagua_tpu_torch.models.mlp import MLP
from bagua_tpu_torch.ops import codec as cd
from bagua_tpu_torch.tensor import NamedParam

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
WORKERS = REPO / "tests" / "workers"
STEPS = 30
ALGOS = ("bytegrad", "qadam", "int8")
_RUNS = {}


@pytest.fixture(scope="module", autouse=True)
def process_group():
    bt.init_process_group(device="cpu")


def _spawn(script, world, args, tmp, environ=None):
    """Run ``world`` ranks of a worker; returns each rank's output npz."""
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": os.pathsep.join(
        [str(REPO), os.environ.get("PYTHONPATH", "")]), **(environ or {})}
    init = f"file://{tmp / 'store'}"
    outs = [tmp / f"out{r}.npz" for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(WORKERS / script), str(r), str(world), init,
                               *args[:1], str(outs[r]), *args[1:]], env=env)
             for r in range(world)]
    try:
        assert [p.wait(timeout=300) for p in procs] == [0] * world
    finally:
        for p in procs:
            p.kill()
    return [np.load(o) for o in outs]


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _comm_run(world, tmp_path_factory):
    key = ("comm", world)
    if key not in _RUNS:
        rng = np.random.default_rng(world)
        xs = rng.standard_normal((world, world * 48)).astype(np.float32)
        xs_odd = rng.standard_normal((world, 101)).astype(np.float32)
        tmp = tmp_path_factory.mktemp(f"comm{world}")
        np.savez(tmp / "in.npz", xs=xs, xs_odd=xs_odd)
        _RUNS[key] = (xs, xs_odd, _spawn("torch_comm_worker.py", world,
                                         [str(tmp / "in.npz")], tmp))
    return _RUNS[key]


def _jax(world, fn, xs):
    """``fn(comm, x)`` on every rank of a ``world``-device mesh; [world, ...]."""
    mesh = build_mesh({"dp": world}, jax.devices()[:world])
    comm = JComm("dp", mesh)
    out = jax.jit(shard_map(lambda x: fn(comm, x[0])[None], mesh=mesh, in_specs=P("dp"),
                            out_specs=P("dp"), check_vma=False))(jnp.asarray(xs))
    return np.asarray(out)


def _step(kind, block):
    """One quantization step of a block's encode, per element of it."""
    if kind == "minmax_uint8":
        return (block.max() - block.min()) / 255.0
    a = np.abs(block).max()
    return a / {"int8": 127.0, "fp8_e4m3": 8.0, "fp8_e5m2": 4.0}[kind]


def _within_a_step(got, want, kind, world):
    """Every rank's result within one step of each rank block of JAX's;
    returns the largest gap in steps."""
    worst = 0.0
    for g, w in zip(got, want):
        for gb, wb in zip(np.array_split(g, world), np.array_split(w, world)):
            step = _step(kind, wb)
            gap = np.abs(gb - wb).max() / max(step, 1e-30)
            assert gap <= 1.0 + 1e-6, (kind, gap)
            worst = max(worst, gap)
    return worst


LOSSY = {
    "sg_avg": ("minmax_uint8", False, lambda c, x: j_sg(c, x, average=True)),
    "sg_sum": ("minmax_uint8", False, lambda c, x: j_sg(c, x, average=False)),
    "ring_int8": ("int8", False, lambda c, x: c.ring_allreduce(x, JReduceOp.AVG,
                                                               codec="int8")),
    "ring_fp8_e4m3": ("fp8_e4m3", False, lambda c, x: c.ring_allreduce(
        x, JReduceOp.AVG, codec="fp8_e4m3")),
    "ring_fp8_e5m2": ("fp8_e5m2", False, lambda c, x: c.ring_allreduce(
        x, JReduceOp.AVG, codec="fp8_e5m2")),
    "ring_minmax_uint8_sum": ("minmax_uint8", False, lambda c, x: c.ring_allreduce(
        x, JReduceOp.SUM, codec="minmax_uint8")),
    "ring_int8_odd": ("int8", True, lambda c, x: c.ring_allreduce(
        x, JReduceOp.AVG, codec="int8")),
    "ctx_forced_int8": ("int8", False, lambda c, x: c.ring_allreduce(x, JReduceOp.AVG,
                                                                     codec="int8")),
}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("op", sorted(LOSSY))
def test_lossy_collective_within_a_step_of_jax(op, world, tmp_path_factory):
    xs, xs_odd, outs = _comm_run(world, tmp_path_factory)
    kind, odd, fn = LOSSY[op]
    got = np.stack([o[op] for o in outs])
    for g in got[1:]:
        assert np.array_equal(g.view(np.uint32), got[0].view(np.uint32))  # ranks agree
    want = _jax(world, fn, xs_odd if odd else xs)
    _within_a_step(got, want, kind, world)


EXACT = {
    "ring_sum_odd": (True, lambda c, x: c.ring_allreduce(x, JReduceOp.SUM)),
    "ring_rs": (False, lambda c, x: c.ring_reduce_scatter(x, JReduceOp.SUM)),
    "ring_ag": (False, lambda c, x: c.ring_allgather(x[:8])),
    "ring_rs_int8": (False, lambda c, x: c.ring_reduce_scatter(x, JReduceOp.AVG,
                                                               codec="int8")),
    "ring_ag_int8": (False, lambda c, x: c.ring_allgather(x[:16], codec="int8")),
    "allgather": (False, lambda c, x: c.allgather(x[:4], tiled=False)),
    "reduce_scatter_avg": (False, lambda c, x: c.reduce_scatter(x, JReduceOp.AVG)),
    "alltoall": (False, lambda c, x: c.alltoall(x.reshape(c.nranks(), -1))),
    "ppermute_shift": (False, lambda c, x: c.ppermute(
        x[:4], [(i, (i + 1) % c.nranks()) for i in range(c.nranks())])),
    "ppermute_partial": (False, lambda c, x: c.ppermute(x[:4], [(0, 1)])),
    "ctx_default": (False, lambda c, x: c.allreduce(x, JReduceOp.AVG)),
    "ctx_off": (True, lambda c, x: c.allreduce(x, JReduceOp.SUM)),
}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("op", sorted(EXACT))
def test_collective_matches_jax(op, world, tmp_path_factory):
    """Data movement and the full-precision rings: the same values as the
    JAX package's (sums within f32 rounding; the codec legs of
    ``ring_rs_int8``/``ring_ag_int8`` run the same encodes on both sides)."""
    xs, xs_odd, outs = _comm_run(world, tmp_path_factory)
    odd, fn = EXACT[op]
    want = _jax(world, fn, xs_odd if odd else xs)
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o[op], want[r], rtol=1e-6, atol=1e-6, err_msg=op)
        assert int(o["host_staged_bytes"]) == 0   # CPU tensors never stage


# ---------------------------------------------------------------------------
# trainers on the golden task
# ---------------------------------------------------------------------------


def _ce(model, batch):
    return torch.nn.functional.cross_entropy(model(batch["x"]), batch["y"])


@functools.lru_cache(maxsize=None)
def _golden():
    loss_fn, params, batch = bench.golden_task()
    model = MLP(4, features=(32, 8), device="cpu")
    sd = params_from_jax(jax.tree.map(np.asarray, params), model)
    return loss_fn, params, batch, {k: v.numpy() for k, v in sd.items()}


#: the inter-node int8 ring on the two-level allreduce, run at 2 x 2
#: (``LOCAL_WORLD_SIZE=2``) beside the world-4 runs
HIER_ALGO = "hier_int8"


def _trainer_run(world, tmp_path_factory):
    key = ("train", world)
    if key not in _RUNS:
        _, params, batch, _ = _golden()
        tmp = tmp_path_factory.mktemp(f"train{world}")
        np.savez(tmp / "data.npz", x=np.asarray(batch["x"]), y=np.asarray(batch["y"]))
        np.savez(tmp / "params.npz", **{f"{layer}.{k}": np.asarray(v)
                                        for layer, leaves in params.items()
                                        for k, v in leaves.items()})
        algos = ALGOS + (HIER_ALGO,) if world == 4 else ALGOS
        _RUNS[key] = _spawn("torch_trainer_worker.py", world,
                            [str(tmp / "data.npz"), str(STEPS), ",".join(algos),
                             str(tmp / "params.npz")], tmp, {"LOCAL_WORLD_SIZE": "2"})
    return _RUNS[key]


def _jax_losses(world, algo):
    loss_fn, params, batch, _ = _golden()
    kw = {}
    mesh = build_mesh({"dp": world}, jax.devices()[:world])
    if algo == "bytegrad":
        jalgo, opt = JByteGrad(hierarchical=False), optax.sgd(0.1)
    elif algo == "qadam":
        jalgo, opt = JQAdam(warmup_steps=2, hierarchical=False), None
    elif algo == HIER_ALGO:
        jalgo, opt = JGradientAllReduce(hierarchical=True), optax.sgd(0.1)
        kw = {"compress_inter": "int8"}
        mesh = build_mesh({"inter": world // 2, "intra": 2}, jax.devices()[:world])
    else:
        jalgo, opt, kw = JGradientAllReduce(), optax.sgd(0.1), {"compress_intra": "int8"}
    trainer = JTrainer(loss_fn, opt, jalgo, autotune=False, mesh=mesh, **kw)
    state = trainer.init(params)
    losses = []
    for _ in range(STEPS):
        state, loss = trainer.train_step(state, batch)
        losses.append(float(loss))
    return np.array(losses)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("algo", ALGOS)
def test_golden_task_tracks_the_jax_trainer(algo, world, tmp_path_factory):
    outs = _trainer_run(world, tmp_path_factory)
    got = outs[0][f"{algo}/losses"]
    for o in outs[1:]:
        np.testing.assert_array_equal(o[f"{algo}/losses"], got)
        for name in ("dense_0.kernel", "dense_1.bias"):
            np.testing.assert_array_equal(o[f"{algo}/{name}"], outs[0][f"{algo}/{name}"])
    want = _jax_losses(world, algo)
    gap = np.abs(got - want) / np.abs(want)
    assert gap.max() <= 1e-3, f"largest relative loss gap {gap.max():.3g} at step {gap.argmax()}"
    assert got[-1] < 0.7 * got[0]


# ---------------------------------------------------------------------------
# world size 1, buckets, knobs
# ---------------------------------------------------------------------------


def test_world_one_bytegrad_is_gradient_allreduce_and_runs_no_codec(monkeypatch):
    """A single rank has no wire: ByteGrad returns the flat untouched, so it
    trains bit for bit like GradientAllReduce, and no codec runs, kernel or
    plain."""
    import bagua_tpu_torch.algorithms.bytegrad as bytegrad_mod

    def refuse(*a, **k):
        raise AssertionError("a codec ran at world size 1")

    for name in ("compress_chunked_plain", "decompress_chunked_plain",
                 "absmax_chunked_plain", "quantize_plain"):
        monkeypatch.setattr(cd, name, refuse)
    monkeypatch.setattr(bytegrad_mod, "compressed_scatter_gather_allreduce", refuse)
    cd.reset_launch_counts()
    _, _, batch, sd = _golden()
    b = {"x": torch.from_numpy(np.asarray(batch["x"])),
         "y": torch.from_numpy(np.asarray(batch["y"]).astype(np.int64))}
    runs = []
    for algo in (bt.ByteGradAlgorithm(hierarchical=False), bt.GradientAllReduceAlgorithm()):
        model = MLP(4, features=(32, 8), device="cpu")
        model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        trainer = bt.BaguaTrainer(_ce, functools.partial(torch.optim.SGD, lr=0.1), algo,
                                  device="cpu")
        state = trainer.init(model)
        losses = []
        for _ in range(10):
            state, loss = trainer.train_step(state, b)
            losses.append(loss.item())
        runs.append((losses, [p.detach().clone() for p in model.parameters()]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    assert all(k.launches == 0 for k in cd.KERNELS)


def test_flatten_zeroes_the_pad_tail(monkeypatch):
    params = [NamedParam("a", (3,), torch.float32), NamedParam("b", (2, 2), torch.float32)]
    plan = bt.ByteGradAlgorithm(hierarchical=False).tensors_to_buckets(
        [[p.declaration() for p in params]], params, 4)
    (bucket,) = plan.buckets
    assert (bucket.alignment, bucket.numel, bucket.padded_numel) == (4, 7, 8)
    assert BucketPlan.build(params, 1 << 20).buckets[0].padded_numel == 7
    empty = torch.empty
    # an allocator that hands out NaN-filled memory: the tail must be zeroed
    monkeypatch.setattr(torch, "empty", lambda *a, **k: empty(*a, **k).fill_(float("nan")))
    (flat,) = plan.flatten({"a": torch.ones(3), "b": torch.full((2, 2), 2.0)})
    assert flat.tolist() == [1.0, 1.0, 1.0, 2.0, 2.0, 2.0, 2.0, 0.0]
    named = plan.unflatten([flat])
    assert named["b"].shape == (2, 2) and named["a"].tolist() == [1.0, 1.0, 1.0]


@pytest.mark.parametrize("algo,alignment", [
    (bt.GradientAllReduceAlgorithm(), 1),
    (bt.ByteGradAlgorithm(hierarchical=False), 4),
    (bt.QAdamAlgorithm(hierarchical=False), 4),
], ids=["gradient_allreduce", "bytegrad", "qadam"])
def test_compressed_families_align_buckets_to_the_world(algo, alignment):
    params = [NamedParam("a", (5,), torch.float32), NamedParam("b", (2,), torch.float32)]
    plan = algo.tensors_to_buckets([[p.declaration() for p in params]], params, 4)
    (bucket,) = plan.buckets
    assert (bucket.alignment, bucket.padded_numel) == (alignment, 7 if alignment == 1 else 8)


def test_codec_knobs_and_unported_forms(monkeypatch, tmp_path_factory):
    """The codec knobs, and the forms that were refused before the
    hierarchical collectives were ported: a codec name on the inter-node
    tier is taken, and int8 there trains at 2 x 2 within 1e-3 of the JAX
    trainer on an (inter 2, intra 2) mesh."""
    # first the run, while the environment holds no codec knob
    outs = _trainer_run(4, tmp_path_factory)
    got = outs[0][f"{HIER_ALGO}/losses"]
    for o in outs[1:]:
        np.testing.assert_array_equal(o[f"{HIER_ALGO}/losses"], got)
        np.testing.assert_array_equal(o[f"{HIER_ALGO}/dense_0.kernel"],
                                      outs[0][f"{HIER_ALGO}/dense_0.kernel"])
    want = _jax_losses(4, HIER_ALGO)
    gap = np.abs(got - want) / np.abs(want)
    assert gap.max() <= 1e-3, f"largest relative loss gap {gap.max():.3g} at step {gap.argmax()}"
    assert got[-1] < 0.7 * got[0]

    sgd = functools.partial(torch.optim.SGD, lr=0.1)
    algo = bt.GradientAllReduceAlgorithm()
    with pytest.raises(ValueError, match="compress_intra must be one of"):
        bt.BaguaTrainer(_ce, sgd, algo, device="cpu", compress_intra="gzip")
    with pytest.raises(ValueError, match="compress_inter must be one of"):
        bt.BaguaTrainer(_ce, sgd, algo, device="cpu", compress_inter="int4")
    for codec in ("onebit_ef", "topk", "int8"):
        trainer = bt.BaguaTrainer(_ce, sgd, algo, device="cpu", compress_inter=codec)
        assert trainer.compress_inter == codec
    monkeypatch.setenv("BAGUA_COMPRESS_INTRA", "fp8_e5m2")
    monkeypatch.setenv("BAGUA_COMPRESS_INTER", "off")
    trainer = bt.BaguaTrainer(_ce, sgd, algo, device="cpu")
    assert (trainer.compress_intra, trainer.compress_inter) == ("fp8_e5m2", "off")
    for cls in (bt.ByteGradAlgorithm, bt.QAdamAlgorithm):
        assert cls().hierarchical and cls().wire_codec_dcn == "minmax_uint8"


def test_qadam_switches_phase_once_at_warmup():
    algo = bt.QAdamAlgorithm(warmup_steps=3, hierarchical=False)
    assert [algo.need_reset(s) for s in range(6)] == [False, False, False, True, False, False]
    assert algo._compressed and algo.owns_optimizer
