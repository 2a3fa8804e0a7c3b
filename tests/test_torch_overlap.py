"""The port's overlap scheduler and chunked rings against the JAX package's.

Mirrors ``tests/test_overlap.py`` at world 2 and 4 over gloo
(``tests/workers/torch_overlap_worker.py`` for the collectives,
``tests/workers/torch_features_worker.py`` for the trainer), the JAX side
under ``shard_map`` or its trainer on as many CPU devices:

- the chunked ring allreduce (SUM and AVG), reduce-scatter and allgather at
  1, 2 and 4 sub-rings against the port's fused collectives and against
  JAX's rings, within 1e-6 (the sums of four ranks run in another order; the
  gather moves data only and is exact); the scatter/gather pair round-trips
  to the mean; an indivisible buffer is padded and sliced back;
  ``ring_chunks_for`` and ``largest_divisor_leq`` equal JAX's on a grid;
- the trainer with ``overlap="on"`` against ``"off"`` for GradientAllReduce
  (SGD), ZeRO (Adam) and ByteGrad (SGD) at accumulation 1 and 4 on the
  golden task, buckets of 64 bytes (several of them): bitwise for GradientAllReduce
  and ZeRO at world 2 (gloo adds the same two values whatever the plan),
  within 1e-6 at world 4 (the readiness rebucket moves the offsets that
  order gloo's four-term sums); ByteGrad within 1e-3 (the rebucket moves its
  quantization chunks, as in JAX's test); each overlapped run within 1e-5
  of JAX's overlapped trainer (1e-3 for ByteGrad);
- the chunked ring end to end (``overlap_chunk_bytes=64``) within 1e-5 of
  the serialized run, GradientAllReduce and ZeRO;
- four ranks as two nodes of two (``LOCAL_WORLD_SIZE=2``): the two-level
  GradientAllReduce overlapped bitwise equal to serialized (each tier adds two
  values), ByteGrad's two-level form within 1e-3, both within JAX's
  overlapped two-level trainer's losses (1e-5, ByteGrad 1e-3);
- the ``auto`` gate's table; the readiness rebucket covers every tensor;
- both ranks issue their buckets in the launch order, the plan's or one of
  its own, when their hooks fire in different orders;
- a failure in the comm worker, and an abort raised during the backward,
  surface at the main thread's wait; the trainer steps again after it;
- the guard's rewind under the overlap is bitwise a step not taken, the
  1-bit ring's residual (compensated inside the backward) and ZeRO's state
  included.

Every multi-rank run has a join timeout: a collective issued out of order
hangs instead of failing.
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
from jax.sharding import Mesh, PartitionSpec as P

import bench
import bagua_tpu_torch as bt
from bagua_tpu.algorithms import ByteGradAlgorithm as JByteGrad
from bagua_tpu.algorithms import GradientAllReduceAlgorithm as JGA
from bagua_tpu.algorithms import ZeroOptimizerAlgorithm as JZero
from bagua_tpu.communication import BaguaCommunicator as JComm
from bagua_tpu.communication import ReduceOp as JReduceOp
from bagua_tpu.communication import largest_divisor_leq as jlargest_divisor_leq
from bagua_tpu.communication import ring_chunks_for as jring_chunks_for
from bagua_tpu.compat import shard_map
from bagua_tpu.core.backend import BaguaTrainer as JTrainer
from bagua_tpu.parallel.mesh import build_mesh
from bagua_tpu_torch.communication import (MAX_RING_CHUNKS, BaguaAborted,
                                           largest_divisor_leq, ring_chunks_for)
from bagua_tpu_torch.models.mlp import MLP

from workers import torch_features_worker as features

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "workers" / "torch_overlap_worker.py"
WORLDS = (2, 4)
CHUNKS = (1, 2, 4)
STEPS = 4
BUCKET = 64
SGD = functools.partial(torch.optim.SGD, lr=0.1)
_RUNS = {}


# ---- the collectives ---------------------------------------------------------


def worker_inputs(world):
    """Row r of each array is rank r's operand (shared with
    tests/test_torch_compressed_ring.py and tests/test_torch_eager.py)."""
    rng = np.random.default_rng(world)
    counts = rng.integers(0, 4, (world, world))
    v = np.zeros((world, int(counts.sum(axis=1).max()), 3), np.float32)
    for r in range(world):
        v[r, :counts[r].sum()] = rng.normal(size=(counts[r].sum(), 3))
    return {"x": rng.normal(size=(world, 64)).astype(np.float32),
            "c": rng.normal(size=(world, 64)).astype(np.float32),
            "odd": rng.normal(size=(world, 50)).astype(np.float32),
            "e": rng.normal(size=(world, 4 * world, 6)).astype(np.float32),
            "recv": rng.normal(size=(world, 4 * world, 6)).astype(np.float32),
            "grecv": rng.normal(size=(world, 4 * world * world, 6)).astype(np.float32),
            "v": v, "counts": counts}


def worker_run(world, tmp_path_factory):
    """Every rank's results of the overlap worker, ``[world, ...]`` by case."""
    if world not in _RUNS:
        tmp = tmp_path_factory.mktemp(f"overlap{world}")
        np.savez(tmp / "in.npz", **worker_inputs(world))
        env = {**os.environ, "OMP_NUM_THREADS": "1",
               "PYTHONPATH": os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")])}
        outs = [tmp / f"out{r}.npz" for r in range(world)]
        procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), str(world),
                                   f"file://{tmp / 'store'}", str(tmp / "in.npz"), str(outs[r])],
                                  env=env) for r in range(world)]
        try:
            assert [p.wait(timeout=300) for p in procs] == [0] * world
        finally:
            for p in procs:
                p.kill()
        loaded = [np.load(o) for o in outs]
        _RUNS[world] = {k: np.stack([o[k] for o in loaded]) for k in loaded[0].files}
    return _RUNS[world]


def jax_rows(world, fn, x):
    """``fn(comm, row)`` on every rank's row of ``x`` under ``shard_map`` over
    ``world`` CPU devices; ``[world, ...]``."""
    mesh = Mesh(np.array(jax.devices()[:world]), ("dp",))
    comm = JComm("dp", mesh)
    f = shard_map(lambda v: fn(comm, v[0])[None], mesh=mesh, in_specs=P("dp"),
                  out_specs=P("dp"), check_vma=False)
    return np.asarray(jax.jit(f)(jnp.asarray(x)))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("num_chunks", CHUNKS)
@pytest.mark.parametrize("op", ["SUM", "AVG"])
def test_ring_allreduce_matches_fused_and_jax(world, num_chunks, op, tmp_path_factory):
    got = worker_run(world, tmp_path_factory)
    ring = got[f"ring/allreduce/{op}/{num_chunks}"]
    np.testing.assert_allclose(ring, got[f"fused/allreduce/{op}"], rtol=1e-6, atol=1e-6)
    want = jax_rows(world, lambda c, v: c.ring_allreduce(v, JReduceOp[op], num_chunks=num_chunks),
                    worker_inputs(world)["x"])
    np.testing.assert_allclose(ring, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("num_chunks", CHUNKS)
def test_ring_reduce_scatter_matches_fused_and_jax(world, num_chunks, tmp_path_factory):
    got = worker_run(world, tmp_path_factory)
    ring = got[f"ring/reduce_scatter/{num_chunks}"]
    np.testing.assert_allclose(ring, got["fused/reduce_scatter"], rtol=1e-6, atol=1e-6)
    want = jax_rows(world, lambda c, v: c.ring_reduce_scatter(v, JReduceOp.AVG,
                                                              num_chunks=num_chunks),
                    worker_inputs(world)["x"])
    np.testing.assert_allclose(ring, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("num_chunks", CHUNKS)
def test_ring_allgather_matches_fused_and_jax(world, num_chunks, tmp_path_factory):
    got = worker_run(world, tmp_path_factory)
    ring = got[f"ring/allgather/{num_chunks}"]
    np.testing.assert_array_equal(ring, got["fused/allgather"])
    want = jax_rows(world, lambda c, v: c.ring_allgather(v[:8], num_chunks=num_chunks),
                    worker_inputs(world)["x"])
    np.testing.assert_array_equal(ring, want)


@pytest.mark.parametrize("world", WORLDS)
def test_ring_scatter_gather_pair_is_layout_symmetric(world, tmp_path_factory):
    # reduce-scatter then allgather, 4 sub-rings each, round-trips to the
    # mean: the invariant ZeRO's chunk-resident state rests on
    got = worker_run(world, tmp_path_factory)["ring/pair"]
    want = worker_inputs(world)["x"].mean(axis=0)
    for row in got:
        np.testing.assert_allclose(row, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("num_chunks", [1, 2])
def test_ring_allreduce_pads_indivisible_buffers(world, num_chunks, tmp_path_factory):
    # 50 elements: a multiple of neither the world nor world * num_chunks
    got = worker_run(world, tmp_path_factory)
    np.testing.assert_allclose(got[f"ring/pad/{num_chunks}"], got["fused/pad"], rtol=1e-6,
                               atol=1e-6)
    assert got[f"ring/pad/{num_chunks}"].shape == (world, 50)


def test_ring_chunks_for_sizing():
    # JAX's own cases: 8 ranks, 1024 f32 -> 128 elements (512 B) a rank
    assert ring_chunks_for(1024, 4, 8, None) == 1
    assert ring_chunks_for(1024, 4, 8, 0) == 1
    assert ring_chunks_for(1024, 4, 8, 512) == 1
    assert ring_chunks_for(1024, 4, 8, 128) == 4
    k = ring_chunks_for(1024, 4, 8, 100)
    assert 128 % k == 0 and k > 1
    assert ring_chunks_for(1023, 4, 8, 64) == 8
    assert ring_chunks_for(800_000, 4, 8, 16) <= MAX_RING_CHUNKS == 32
    # a target by link class; a class it does not name is not chunked
    assert ring_chunks_for(1024, 4, 8, {"ici": 128}, "ici") == 4
    assert ring_chunks_for(1024, 4, 8, {"ici": 128}, "dcn") == 1
    # and the JAX package's answer on a grid
    for numel in (1, 7, 50, 1023, 1024, 99991, 2621440, 31260672):
        for nranks in (1, 2, 4, 8):
            for target in (0, 16, 100, 4096, 1 << 20, {"ici": 512, "dcn": 1 << 16}):
                for link in ("ici", "dcn"):
                    assert (ring_chunks_for(numel, 4, nranks, target, link)
                            == jring_chunks_for(numel, 4, nranks, target, link)), \
                        (numel, nranks, target, link)


def test_largest_divisor_leq_matches_jax():
    for m in (1, 2, 12, 97, 1000, 65536, 1310720, 999983):
        for k in (1, 2, 3, 5, 32, 1000, 10 ** 7):
            assert largest_divisor_leq(m, k) == jlargest_divisor_leq(m, k), (m, k)


# ---- the scheduler's issue order ----------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("order", ["plan", "custom"])
def test_ranks_issue_in_launch_order_whatever_the_hooks(world, order, tmp_path_factory):
    # each rank's hooks fire in a permutation of its own; every rank issues
    # the buckets in the launch order, and each bucket's sum is right
    from workers.torch_overlap_worker import LAUNCH_ORDERS

    got = worker_run(world, tmp_path_factory)
    for issued in got[f"order/{order}/issued"]:
        assert issued.tolist() == LAUNCH_ORDERS[order]
    want = np.stack([np.full(3, 10.0 * i * world + sum(range(world))) for i in range(6)])
    for reduced in got[f"order/{order}/reduced"]:
        np.testing.assert_array_equal(reduced, want)


# ---- the trainer ----------------------------------------------------------------

BASES = {"gradient_allreduce": "ga", "zero": "zero_adam", "bytegrad": "bytegrad"}


def _run(base, accum, overlap, chunk=None):
    run = f"{base}:bucket={BUCKET}:overlap={overlap}:steps={STEPS}"
    if accum > 1:
        run += f":accum={accum}"
    if chunk is not None:
        run += f":chunk={chunk}"
    return run


def trainer_runs(world, tmp_path_factory):
    key = ("trainer", world)
    if key not in _RUNS:
        runs = [_run(b, a, o) for b in BASES.values() for a in (1, 4) for o in ("off", "on")]
        runs += [_run(b, 4, "on", chunk=64) for b in ("ga", "zero_adam")]
        _RUNS[key] = features.spawn(world, runs, tmp_path_factory.mktemp(f"ov_trainer{world}"),
                                    STEPS)
    return _RUNS[key]


def _params(out, run):
    return {k[len(run) + 1:]: v for k, v in out.items()
            if k.startswith(run + "/dense_")}


def _jax_losses(name, world, accum, overlap, chunk=0):
    loss_fn, params, batch = bench.golden_task()
    algo = {"gradient_allreduce": JGA, "zero": lambda: JZero(optax.adam(1e-2)),
            "bytegrad": lambda: JByteGrad(hierarchical=False)}[name]()
    opt = None if name == "zero" else optax.sgd(0.1)
    trainer = JTrainer(loss_fn, opt, algo, mesh=build_mesh({"dp": world}, jax.devices()[:world]),
                       bucket_bytes=BUCKET, autotune=False, accum_steps=accum, overlap=overlap,
                       overlap_chunk_bytes=chunk)
    state = trainer.init(params)
    losses = []
    for _ in range(STEPS):
        state, loss = trainer.train_step(state, batch)
        losses.append(float(loss))
    return np.array(losses)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("accum", [1, 4])
@pytest.mark.parametrize("name", list(BASES))
def test_overlap_matches_serialized_and_jax(world, accum, name, tmp_path_factory):
    outs = trainer_runs(world, tmp_path_factory)
    on, off = _run(BASES[name], accum, "on"), _run(BASES[name], accum, "off")
    for o in outs:
        assert o[f"{on}/overlapped"] and not o[f"{off}/overlapped"]
        # the ranks agree bitwise
        np.testing.assert_array_equal(o[f"{on}/losses"], outs[0][f"{on}/losses"])
        for n, v in _params(o, on).items():
            np.testing.assert_array_equal(v, outs[0][f"{on}/{n}"])
    got, ser = outs[0][f"{on}/losses"], outs[0][f"{off}/losses"]
    p_on, p_off = _params(outs[0], on), _params(outs[0], off)
    if name == "bytegrad":
        # the readiness rebucket moves the codec's chunk boundaries
        np.testing.assert_allclose(got, ser, rtol=1e-3)
    elif world == 2:
        np.testing.assert_array_equal(got, ser)
        for n in p_off:
            np.testing.assert_array_equal(p_on[n], p_off[n], err_msg=n)
    else:
        np.testing.assert_allclose(got, ser, rtol=1e-6)
        for n in p_off:
            np.testing.assert_allclose(p_on[n], p_off[n], rtol=1e-6, atol=1e-7, err_msg=n)
    want = _jax_losses(name, world, accum, "on")
    np.testing.assert_allclose(got, want, rtol=1e-3 if name == "bytegrad" else 1e-5)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["gradient_allreduce", "zero"])
def test_chunked_ring_end_to_end(world, name, tmp_path_factory):
    outs = trainer_runs(world, tmp_path_factory)
    chunked = _run(BASES[name], 4, "on", chunk=64)
    got = outs[0][f"{chunked}/losses"]
    np.testing.assert_allclose(got, outs[0][f"{_run(BASES[name], 4, 'off')}/losses"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, _jax_losses(name, world, 4, "on", chunk=64), rtol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_readiness_rebucket_covers_every_tensor(world, tmp_path_factory):
    outs = trainer_runs(world, tmp_path_factory)
    run = _run("ga", 4, "on")
    names = {"dense_0.bias", "dense_0.kernel", "dense_1.bias", "dense_1.kernel"}
    for o in outs:
        assert o[f"{run}/ordered"]
        plan = [n for b in o[f"{run}/plan"] for n in str(b).split(",")]
        assert sorted(plan) == sorted(names)
        # one plan on every rank
        np.testing.assert_array_equal(o[f"{run}/plan"], outs[0][f"{run}/plan"])
    # ZeRO's state is sharded by bucket: no rebucket
    assert not outs[0][f"{_run('zero_adam', 4, 'on')}/ordered"]


@pytest.mark.parametrize("name", ["gradient_allreduce", "bytegrad"])
def test_overlap_on_two_nodes_of_two(name, tmp_path_factory):
    # four ranks as two nodes of two: the scheduler issues the buckets with
    # the most inter-node bytes first (``bucket_launch_order``); the tiers
    # add two values each, so GradientAllReduce stays bitwise; each within
    # 1e-5 of JAX's overlapped two-level trainer (ByteGrad 1e-3)
    key = ("hier", name)
    base = {"gradient_allreduce": "ga_hier", "bytegrad": "bytegrad_hier"}[name]
    on, off = _run(base, 4, "on"), _run(base, 4, "off")
    if key not in _RUNS:
        _RUNS[key] = features.spawn(4, [on, off], tmp_path_factory.mktemp(f"ov_hier_{name}"),
                                    STEPS, {r: {"LOCAL_WORLD_SIZE": "2"} for r in range(4)})
    outs = _RUNS[key]
    got, ser = outs[0][f"{on}/losses"], outs[0][f"{off}/losses"]
    for o in outs:
        assert o[f"{on}/overlapped"]
        np.testing.assert_array_equal(o[f"{on}/losses"], got)
    if name == "gradient_allreduce":
        np.testing.assert_array_equal(got, ser)
        for n, v in _params(outs[0], off).items():
            np.testing.assert_array_equal(outs[0][f"{on}/{n}"], v, err_msg=n)
    else:
        np.testing.assert_allclose(got, ser, rtol=1e-3)
    loss_fn, params, batch = bench.golden_task()
    algo = JGA(hierarchical=True) if name == "gradient_allreduce" else JByteGrad()
    trainer = JTrainer(loss_fn, optax.sgd(0.1), algo,
                       mesh=build_mesh({"inter": 2, "intra": 2}, jax.devices()[:4]),
                       bucket_bytes=BUCKET, autotune=False, accum_steps=4, overlap="on")
    state = trainer.init(params)
    want = []
    for _ in range(STEPS):
        state, loss = trainer.train_step(state, batch)
        want.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=1e-3 if name == "bytegrad" else 1e-5)


# ---- the gate --------------------------------------------------------------------


@pytest.fixture(scope="module")
def process_group():
    bt.init_process_group(device="cpu")


def _trainer(algo, accum=1, opt=SGD, **kw):
    trainer = bt.BaguaTrainer(lambda m, b: torch.nn.functional.cross_entropy(m(b["x"]), b["y"]),
                              opt, algo, device="cpu", bucket_bytes=BUCKET, accum_steps=accum,
                              **kw)
    return trainer, trainer.init(MLP(12, features=(16, 10), device="cpu"))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"x": torch.from_numpy(rng.normal(size=(16, 12)).astype(np.float32)),
            "y": torch.from_numpy(rng.integers(0, 10, size=16))}


def test_auto_gate_follows_the_measured_record(process_group):
    zero = lambda: bt.ZeroOptimizerAlgorithm(functools.partial(torch.optim.Adam, lr=1e-2))  # noqa: E731
    cases = [
        # allreduce: serialized at accum 1, overlapped with accumulation
        (bt.GradientAllReduceAlgorithm(), 1, {}, False),
        (bt.GradientAllReduceAlgorithm(), 4, {}, True),
        # ZeRO and ByteGrad measured slower overlapped: auto stays off, on wins
        (zero(), 4, {}, False),
        (zero(), 4, {"overlap": "on"}, True),
        (bt.ByteGradAlgorithm(), 4, {}, False),
        (bt.ByteGradAlgorithm(), 4, {"overlap": "on"}, True),
        # families outside the contract never overlap
        (bt.QAdamAlgorithm(warmup_steps=2), 4, {"overlap": "on"}, False),
        (bt.DecentralizedAlgorithm(), 4, {"overlap": "on"}, False),
        # a chunk target opts accum 1 into the rings
        (bt.GradientAllReduceAlgorithm(), 1, {"overlap_chunk_bytes": 4096}, True),
        (bt.GradientAllReduceAlgorithm(), 1, {"overlap_chunk_bytes_inter": 4096}, True),
        # off wins; ZeRO on the leaf layout keeps its collectives in the update
        (bt.GradientAllReduceAlgorithm(), 4, {"overlap": "off"}, False),
        (zero(), 4, {"overlap": "on", "flat_resident": "off"}, False),
    ]
    for algo, accum, kw, want in cases:
        opt = None if algo.owns_optimizer else SGD
        trainer, _ = _trainer(algo, accum, opt, **kw)
        assert trainer._overlap_active() is want, (type(algo).__name__, accum, kw)
        assert trainer._ctx.overlap is want
    # the chunk targets reach the context only under the scheduler
    trainer, _ = _trainer(bt.GradientAllReduceAlgorithm(), 1, overlap="off",
                          overlap_chunk_bytes=4096)
    assert trainer._ctx.overlap_chunk_bytes is None
    trainer, _ = _trainer(bt.GradientAllReduceAlgorithm(), 1, overlap_chunk_bytes=4096,
                          overlap_chunk_bytes_inter=8192)
    assert (trainer._ctx.overlap_chunk_bytes, trainer._ctx.chunk_bytes_for("dcn"),
            trainer._ctx.chunk_bytes_for("ici")) == (4096, 8192, 4096)


def test_overlap_knobs_from_env_and_validation(process_group, monkeypatch):
    monkeypatch.setenv("BAGUA_OVERLAP", "on")
    monkeypatch.setenv("BAGUA_OVERLAP_CHUNK_BYTES", "1024")
    trainer, _ = _trainer(bt.GradientAllReduceAlgorithm())
    assert (trainer.overlap, trainer.overlap_chunk_bytes) == ("on", 1024)
    with pytest.raises(ValueError, match="overlap must be"):
        _trainer(bt.GradientAllReduceAlgorithm(), overlap="sometimes")
    with pytest.raises(ValueError, match=">= 0"):
        _trainer(bt.GradientAllReduceAlgorithm(), overlap_chunk_bytes=-1)
    monkeypatch.setenv("BAGUA_OVERLAP", "maybe")
    with pytest.raises(ValueError, match="BAGUA_OVERLAP"):
        _trainer(bt.GradientAllReduceAlgorithm())


# ---- failures --------------------------------------------------------------------


class _Failing(bt.GradientAllReduceAlgorithm):
    """Fails its second bucket's collective once."""

    def __init__(self):
        super().__init__()
        self.fail = True

    def reduce_bucket_grad(self, ctx, index, flat):
        if index == 1 and self.fail:
            self.fail = False
            raise RuntimeError("bucket 1's collective failed")
        return super().reduce_bucket_grad(ctx, index, flat)


def test_worker_failure_surfaces_at_the_wait(process_group):
    trainer, state = _trainer(_Failing(), 2, overlap="on")
    assert len(trainer.plan.buckets) > 2
    with pytest.raises(RuntimeError, match="bucket 1's collective failed"):
        trainer.train_step(state, _batch())
    # nothing hidden: no fallback took the step; the next one runs
    assert state.step == 0
    state, loss = trainer.train_step(state, _batch())
    assert np.isfinite(loss.item()) and state.step == 1


def test_abort_in_the_backward_surfaces_at_the_wait(process_group):
    trainer, state = _trainer(bt.GradientAllReduceAlgorithm(), 2, overlap="on")
    first = trainer._params[trainer.plan.buckets[0].tensors[0].name]
    handle = first.register_post_accumulate_grad_hook(lambda p: bt.abort("test abort"))
    try:
        with pytest.raises(BaguaAborted, match="test abort|aborted before"):
            trainer.train_step(state, _batch())
    finally:
        handle.remove()
        bt.reset_abort()
    _, loss = trainer.train_step(state, _batch())
    assert np.isfinite(loss.item())


def test_worker_thread_ends_with_its_trainer(process_group):
    import gc

    trainer, state = _trainer(bt.GradientAllReduceAlgorithm(), 2, overlap="on")
    trainer.train_step(state, _batch())
    thread = trainer._worker._thread
    assert thread.is_alive() and thread.name == "bagua-comm-worker"
    del trainer, state
    gc.collect()
    thread.join(timeout=10)
    assert not thread.is_alive()


def test_a_dead_worker_thread_raises_instead_of_hanging():
    from bagua_tpu_torch.core.overlap import CommWorker

    worker = CommWorker(torch.device("cpu"))
    worker.close()
    worker._thread.join(timeout=10)
    with pytest.raises(RuntimeError, match="comm worker thread has ended"):
        worker.flush()


# ---- the guard under the overlap ----------------------------------------------------


def test_guard_rewind_under_overlap_is_bitwise(tmp_path_factory):
    # the 1-bit ring's residual is compensated inside the backward and the
    # rewind discards it; ZeRO's chunks come from the overlapped scatter
    clean = ["onebit:guard:overlap=on:bucket=256:steps=5",
             "zero_adam:guard:overlap=on:bucket=256:steps=5"]
    poisoned = ["onebit:guard:overlap=on:bucket=256:poison=3:steps=6",
                "zero_adam:guard:overlap=on:bucket=256:poison=3:steps=6"]
    outs = features.spawn(2, clean + poisoned, tmp_path_factory.mktemp("ov_guard"), 6)
    for o in outs:
        for c, p in zip(clean, poisoned):
            assert o[f"{p}/overlapped"]
            assert o[f"{p}/counter/grad_guard/skipped_steps"] == 1
            keys = [k[len(c) + 1:] for k in o if k.startswith(c + "/dense_")] + ["ef"]
            for key in keys:
                np.testing.assert_array_equal(o[f"{p}/{key}"], o[f"{c}/{key}"], err_msg=key)
            np.testing.assert_array_equal(np.delete(o[f"{p}/losses"], 3), o[f"{c}/losses"])
        assert o[f"{poisoned[0]}/ef"].size and np.isfinite(o[f"{poisoned[0]}/ef"]).all()
