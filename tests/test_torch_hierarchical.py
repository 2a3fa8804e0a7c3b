"""The port's two-tier hierarchical collectives against the JAX package.

Four gloo ranks with ``LOCAL_WORLD_SIZE=2`` form two nodes of two ranks
(intra-node groups {0, 1} and {2, 3}, inter-node groups {0, 2} and {1, 3}); the
JAX side runs the same inputs on ``build_mesh({"inter": 2, "intra": 2})`` over
four CPU devices, where device ``(i, j)`` is rank ``2 i + j``.

- Collectives (``tests/workers/torch_comm_worker.py``): the two-level
  allreduce in full precision equals JAX's within f32 rounding and the flat
  allreduce within 1e-5; with a codec on the inter-node ring, every rank holds
  the same bits, within one quantization step of JAX's (the two sum the
  intra-node shard in other orders, which can move a value across a step).
- Trainers (``tests/workers/torch_trainer_worker.py``, the golden task from
  the JAX params in flax's layout): ``GradientAllReduceAlgorithm(
  hierarchical=True)`` equals the port's flat path within 1e-5 and JAX's
  within 1e-5; with ``compress_inter="onebit_ef"`` it learns and carries a
  finite, nonzero residual; ``ByteGradAlgorithm()`` and QAdam's compressed
  phase at their default ``hierarchical=True`` track JAX within 1e-3.
- The default constructors: ``ByteGradAlgorithm()`` and ``QAdamAlgorithm()``
  used to raise in the port.  At a flat world of two ranks (one node) they
  fall back to the flat scatter-gather, as in JAX, so their losses equal
  ``hierarchical=False`` bitwise.
- One node (two ranks, inter-node tier of one rank): the two-level form is
  not taken, so ``compress_inter="onebit_ef"`` keeps no residual and the
  run equals the exact flat allreduce bitwise.
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
from bagua_tpu.algorithms.base import AlgorithmContext as JContext
from bagua_tpu.algorithms.bytegrad import ByteGradAlgorithm as JByteGrad
from bagua_tpu.algorithms.gradient_allreduce import (
    GradientAllReduceAlgorithm as JGradientAllReduce,
)
from bagua_tpu.algorithms.q_adam import QAdamAlgorithm as JQAdam
from bagua_tpu.communication import BaguaCommunicator as JComm
from bagua_tpu.communication import ReduceOp as JReduceOp
from bagua_tpu.communication import collapse_trivial_axes
from bagua_tpu.compat import shard_map
from bagua_tpu.core.backend import BaguaTrainer as JTrainer
from bagua_tpu.parallel.mesh import build_mesh

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
WORKERS = REPO / "tests" / "workers"
STEPS = 20
ALGOS_4 = ("gradient_allreduce", "hier", "hier_onebit", "bytegrad_default", "qadam_default")
ALGOS_2 = ("bytegrad", "bytegrad_default", "qadam", "qadam_default", "gradient_allreduce",
           "hier_onebit")
_RUNS = {}


@pytest.fixture(scope="module", autouse=True)
def process_group():
    bt.init_process_group(device="cpu")


def _spawn(script, world, args, tmp, environ):
    """Run ``world`` ranks of a worker; returns each rank's output npz."""
    env = {k: v for k, v in os.environ.items() if k != "LOCAL_WORLD_SIZE"}
    env.update({"OMP_NUM_THREADS": "1", "PYTHONPATH": os.pathsep.join(
        [str(REPO), os.environ.get("PYTHONPATH", "")]), **environ})
    outs = [tmp / f"out{r}.npz" for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(WORKERS / script), str(r), str(world),
                               f"file://{tmp / 'store'}", *args[:1], str(outs[r]), *args[1:]],
                              env=env)
             for r in range(world)]
    try:
        assert [p.wait(timeout=300) for p in procs] == [0] * world
    finally:
        for p in procs:
            p.kill()
    return [np.load(o) for o in outs]


def _mesh():
    return build_mesh({"inter": 2, "intra": 2}, jax.devices()[:4])


def _jax_ctx(mesh, **kw):
    return JContext(comm=JComm(collapse_trivial_axes(mesh, ("inter", "intra")), mesh),
                    internode=JComm("inter", mesh), intranode=JComm("intra", mesh),
                    plan=None, world_size=4, **kw)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _comm_run(tmp_path_factory):
    if "comm" not in _RUNS:
        rng = np.random.default_rng(44)
        xs = rng.standard_normal((4, 4 * 48)).astype(np.float32)
        xs_odd = rng.standard_normal((4, 101)).astype(np.float32)
        tmp = tmp_path_factory.mktemp("tiers")
        np.savez(tmp / "in.npz", xs=xs, xs_odd=xs_odd)
        _RUNS["comm"] = (xs, xs_odd, _spawn("torch_comm_worker.py", 4, [str(tmp / "in.npz")],
                                            tmp, {"LOCAL_WORLD_SIZE": "2"}))
    return _RUNS["comm"]


def _jax(fn, xs, **kw):
    """``fn(ctx, x)`` on every rank of the (inter 2, intra 2) mesh; [4, ...]."""
    mesh = _mesh()
    ctx = _jax_ctx(mesh, **kw)
    spec = P(("inter", "intra"))
    out = jax.jit(shard_map(lambda x: fn(ctx, x[0])[None], mesh=mesh, in_specs=spec,
                            out_specs=spec, check_vma=False))(jnp.asarray(xs))
    return np.asarray(out)


def test_tiers_split_the_ranks_like_the_jax_mesh(tmp_path_factory):
    _, _, outs = _comm_run(tmp_path_factory)
    assert [o["tier_ranks"].tolist() for o in outs] == [[0, 0], [1, 0], [0, 1], [1, 1]]


TIER_EXACT = {
    "tier_avg_odd": (True, {}, lambda c, x: c.bucket_allreduce(x, JReduceOp.AVG, True)),
    "tier_sum": (False, {}, lambda c, x: c.bucket_allreduce(x, JReduceOp.SUM, True)),
}


@pytest.mark.parametrize("op", sorted(TIER_EXACT))
def test_two_level_allreduce_matches_jax_and_the_flat_sum(op, tmp_path_factory):
    xs, xs_odd, outs = _comm_run(tmp_path_factory)
    odd, kw, fn = TIER_EXACT[op]
    x = xs_odd if odd else xs
    want = _jax(fn, x, **kw)
    flat = x.mean(0) if op == "tier_avg_odd" else x.sum(0)
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o[op], want[r], rtol=1e-6, atol=1e-6, err_msg=op)
        np.testing.assert_allclose(o[op], flat, rtol=1e-5, atol=1e-6, err_msg=op)


def _step(codec, block):
    """One quantization step of the encode of ``block``."""
    a = np.abs(block).max()
    return {"int8": a / 127.0, "onebit_ef": 2 * np.abs(block).mean()}[codec]


TIER_LOSSY = {
    "tier_int8": ("int8", {"inter_codec": "int8"},
                  lambda c, x: c.bucket_allreduce(x, JReduceOp.AVG, True)),
    "tier_onebit": ("onebit_ef", {"inter_codec": "onebit_ef"},
                    lambda c, x: c.bucket_allreduce(x, JReduceOp.AVG, True)),
    "tier_rs_int8": ("int8", {"intra_codec": "int8"},
                     lambda c, x: c.tier_reduce_scatter(x, JReduceOp.SUM)),
}


@pytest.mark.parametrize("op", sorted(TIER_LOSSY))
def test_compressed_tier_within_a_step_of_jax(op, tmp_path_factory):
    xs, _, outs = _comm_run(tmp_path_factory)
    codec, kw, fn = TIER_LOSSY[op]
    got = np.stack([o[op] for o in outs])
    if op != "tier_rs_int8":                       # an allreduce: every rank the same bits
        for g in got[1:]:
            assert np.array_equal(g.view(np.uint32), got[0].view(np.uint32))
    want = _jax(fn, xs, **kw)
    for g, w in zip(got, want):
        # the blocks of the inter-node ring: half of each node's shard
        for gb, wb in zip(np.array_split(g, 4), np.array_split(w, 4)):
            step = _step(codec, wb) * (1 if op == "tier_rs_int8" else 4)
            assert np.abs(gb - wb).max() <= step + 1e-6, (op, np.abs(gb - wb).max(), step)


# ---------------------------------------------------------------------------
# trainers on the golden task
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _golden():
    return bench.golden_task()


def _trainer_run(world, tmp_path_factory):
    if world not in _RUNS:
        _, params, batch = _golden()
        tmp = tmp_path_factory.mktemp(f"hier{world}")
        np.savez(tmp / "data.npz", x=np.asarray(batch["x"]), y=np.asarray(batch["y"]))
        np.savez(tmp / "params.npz", **{f"{layer}.{k}": np.asarray(v)
                                        for layer, leaves in params.items()
                                        for k, v in leaves.items()})
        algos, environ = (ALGOS_4, {"LOCAL_WORLD_SIZE": "2"}) if world == 4 else (ALGOS_2, {})
        _RUNS[world] = _spawn("torch_trainer_worker.py", world,
                              [str(tmp / "data.npz"), str(STEPS), ",".join(algos),
                               str(tmp / "params.npz")], tmp, environ)
    return _RUNS[world]


def _jax_losses(algo):
    loss_fn, params, batch = _golden()
    sgd, kw = optax.sgd(0.1), {}
    jalgo = {"hier": lambda: JGradientAllReduce(hierarchical=True),
             "bytegrad_default": JByteGrad,
             "qadam_default": lambda: JQAdam(warmup_steps=2)}[algo]()
    trainer = JTrainer(loss_fn, None if algo == "qadam_default" else sgd, jalgo,
                       autotune=False, mesh=_mesh(), **kw)
    state = trainer.init(params)
    losses = []
    for _ in range(STEPS):
        state, loss = trainer.train_step(state, batch)
        losses.append(float(loss))
    return np.array(losses)


def _losses(outs, algo):
    """Rank 0's losses, after checking every rank has the same losses and
    parameters."""
    got = outs[0][f"{algo}/losses"]
    for o in outs[1:]:
        np.testing.assert_array_equal(o[f"{algo}/losses"], got)
        for name in ("dense_0.kernel", "dense_1.bias"):
            np.testing.assert_array_equal(o[f"{algo}/{name}"], outs[0][f"{algo}/{name}"])
    return got


def _gap(got, want, label):
    gap = (np.abs(got - want) / np.abs(want)).max()
    print(f"{label}: largest relative loss gap {gap:.3g}")   # shown by pytest -s
    return gap


def test_hierarchical_allreduce_equals_flat_and_tracks_jax(tmp_path_factory):
    outs = _trainer_run(4, tmp_path_factory)
    got = _losses(outs, "hier")
    assert _gap(got, _losses(outs, "gradient_allreduce"), "hier vs the port's flat") <= 1e-5
    assert _gap(got, _jax_losses("hier"), "hier vs JAX") <= 1e-5
    for name in ("dense_0.kernel", "dense_1.kernel"):
        np.testing.assert_allclose(outs[0][f"hier/{name}"],
                                   outs[0][f"gradient_allreduce/{name}"], rtol=1e-5, atol=1e-6)
    assert float(outs[0]["hier/ef_norm"]) == -1.0      # no codec, no residual


def test_hierarchical_onebit_learns_with_a_residual(tmp_path_factory):
    outs = _trainer_run(4, tmp_path_factory)
    got = _losses(outs, "hier_onebit")
    assert np.isfinite(got).all() and got[-1] < got[0]
    for o in outs:
        assert bool(o["hier_onebit/ef_finite"]) and float(o["hier_onebit/ef_norm"]) > 0


@pytest.mark.parametrize("algo", ["bytegrad_default", "qadam_default"])
def test_default_hierarchical_compression_tracks_jax(algo, tmp_path_factory):
    got = _losses(_trainer_run(4, tmp_path_factory), algo)
    gap = _gap(got, _jax_losses(algo), f"{algo} vs JAX")
    assert gap <= 1e-3, f"largest relative loss gap {gap:.3g}"
    assert got[-1] < got[0]


@pytest.mark.parametrize("algo", ["bytegrad", "qadam"])
def test_default_constructors_fall_back_to_flat_on_one_node(algo, tmp_path_factory):
    """The default ``hierarchical=True`` at world 2 on one node (the inter-node
    tier has one rank): the flat scatter-gather, bit for bit."""
    outs = _trainer_run(2, tmp_path_factory)
    np.testing.assert_array_equal(_losses(outs, f"{algo}_default"), _losses(outs, algo))
    for name in ("dense_0.kernel", "dense_1.kernel"):
        np.testing.assert_array_equal(outs[0][f"{algo}_default/{name}"], outs[0][f"{algo}/{name}"])


def test_one_node_hierarchical_ef_is_the_exact_path(tmp_path_factory):
    """``hierarchical=True`` with ``compress_inter="onebit_ef"`` on one node:
    no wire crosses nodes, so nothing is quantized and no residual is kept
    (a residual there would add the quantization error of a message sent
    exactly back into every step)."""
    outs = _trainer_run(2, tmp_path_factory)
    assert all(float(o["hier_onebit/ef_norm"]) == -1.0 for o in outs)
    np.testing.assert_array_equal(_losses(outs, "hier_onebit"), _losses(outs, "gradient_allreduce"))
    for name in ("dense_0.kernel", "dense_1.kernel"):
        np.testing.assert_array_equal(outs[0][f"hier_onebit/{name}"],
                                      outs[0][f"gradient_allreduce/{name}"])


def test_world_one_backend_has_no_tiers():
    backend = bt.get_backend()
    assert backend.intranode_communicator is backend.global_communicator
    assert backend.internode_communicator is backend.global_communicator
    assert backend.communicators() == [backend.global_communicator]
