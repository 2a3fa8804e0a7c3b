"""The port's gossip families (``DecentralizedAlgorithm``,
``LowPrecisionDecentralizedAlgorithm``) against the JAX package.

Mirrors ``tests/test_decentralized.py``, ``tests/test_low_precision_decentralized.py``
and the decentralized rows of ``tests/test_loss_goldens.py`` and
``tests/test_multiprocess_families.py``.  The golden task (``bench.golden_task``,
SGD(0.1), ``STEPS`` steps) is trained by ``tests/workers/torch_trainer_worker.py``
on 2 and 4 gloo ranks from the JAX params in flax's ``[in, out]`` layout
(the low-precision ring compresses a whole bucket as one chunk, so a bucket
must hold the same elements on both sides); ``LOCAL_WORLD_SIZE=2``, so world
2 is one node and world 4 two nodes of two.  The JAX trainer runs on a mesh
of as many CPU devices: flat (``{"dp": w}``), or ``{"inter": w // 2,
"intra": 2}`` for the hierarchical runs, the port's tiers.

- Every rank's parameters after every step equal ``params[r]`` of the JAX
  trainer: full precision within ``test_decentralized.py``'s rtol 1e-5 /
  atol 1e-6, low precision within its golden's 1e-4 (``LOWPREC_TOL``) but
  for a few values one level of the u8 grid apart (``LOWPREC_LEVEL_TOL``).
- ``all`` leaves every rank's peer weights bitwise equal after every step,
  skip steps included; under ``shift_one`` rank r's equal those of
  ``shift_one_peer(r, 4, k)`` at the k-th exchange.
- The low-precision ring keeps ``left_r == self_(r-1)``, ``right_r ==
  self_(r+1)`` (ring neighbours of the gossip tier) and the parameters ``==
  self`` bitwise, and tracks the numpy ring golden of
  ``test_low_precision_decentralized.py`` (``tests/internal/compressor.py``).
- The default constructors on one node average within the node: no ring
  and no codec call.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

import bench
import bagua_tpu_torch as bt
from bagua_tpu.algorithms.decentralized import DecentralizedAlgorithm as JDec
from bagua_tpu.algorithms.decentralized import LowPrecisionDecentralizedAlgorithm as JLow
from bagua_tpu.algorithms.decentralized import shift_one_peer as jax_shift_one_peer
from bagua_tpu.core.backend import BaguaTrainer as JTrainer
from bagua_tpu.parallel.mesh import build_mesh
from bagua_tpu_torch.communication import BaguaCommunicator
from bagua_tpu_torch.models.mlp import MLP
from tests.internal.compressor import MinMaxUInt8Numpy

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
WORKERS = REPO / "tests" / "workers"
STEPS = 6
LR = 0.1
#: the low-precision runs against JAX and the numpy golden: the golden's own
#: tolerance (``test_low_precision_decentralized.py``) ...
LOWPREC_TOL = 1e-4
#: ... except where a one-ulp difference in the gradient (XLA and torch sum
#: in other orders) moves a value of ``diff`` across a rounding boundary of
#: the u8 grid: that element then differs by one level, ``(mx - mn) / 255``
#: of the bucket's ``diff`` (1.4e-4 to 3.7e-4 on this task).  At world 4 one
#: or two values of a traced tensor do, by at most 1.63e-4; none at world 2.
#: Such elements stay within ``LOWPREC_LEVEL_TOL`` and are at most
#: ``LOWPREC_LEVEL_SHARE`` of the values.
LOWPREC_LEVEL_TOL = 5e-4
LOWPREC_LEVEL_SHARE = 1e-3
NAMES = ("dense_0.bias", "dense_0.kernel", "dense_1.bias", "dense_1.kernel")
#: name -> (JAX algorithm factory, hierarchical mesh)
JAX_ALGORITHMS = {
    "dec_all": (lambda: JDec(hierarchical=False, track_peer_weights=True), False),
    "dec_all_i2": (lambda: JDec(hierarchical=False, communication_interval=2,
                                track_peer_weights=True), False),
    "dec_shift_one": (lambda: JDec(hierarchical=False, peer_selection_mode="shift_one",
                                   track_peer_weights=True), False),
    "dec_shift_one_i2": (lambda: JDec(hierarchical=False, peer_selection_mode="shift_one",
                                      communication_interval=2, track_peer_weights=True),
                         False),
    "dec_hier": (lambda: JDec(hierarchical=True, track_peer_weights=True), True),
    "dec_hier_shift_one": (lambda: JDec(hierarchical=True, peer_selection_mode="shift_one",
                                        track_peer_weights=True), True),
    "dec_default": (JDec, True),
    "lowprec": (lambda: JLow(hierarchical=False), False),
    "lowprec_i2": (lambda: JLow(hierarchical=False, communication_interval=2), False),
    "lowprec_default": (JLow, True),
}
ALGOS = {2: ("dec_all", "dec_all_i2", "dec_hier", "dec_default", "lowprec", "lowprec_i2",
             "lowprec_default"),
         4: ("dec_all", "dec_all_i2", "dec_shift_one", "dec_shift_one_i2", "dec_hier",
             "dec_hier_shift_one", "lowprec", "lowprec_default")}
CASES = [(w, a) for w, algos in sorted(ALGOS.items()) for a in algos]
_RUNS = {}
_JAX = {}


def _spawn(world, args, tmp):
    """Run ``world`` ranks of the trainer worker, two ranks a node; returns
    each rank's output npz."""
    env = {**os.environ, "OMP_NUM_THREADS": "1", "LOCAL_WORLD_SIZE": "2",
           "PYTHONPATH": os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")])}
    outs = [tmp / f"out{r}.npz" for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(WORKERS / "torch_trainer_worker.py"), str(r),
                               str(world), f"file://{tmp / 'store'}", *args[:1], str(outs[r]),
                               *args[1:]], env=env)
             for r in range(world)]
    try:
        assert [p.wait(timeout=300) for p in procs] == [0] * world
    finally:
        for p in procs:
            p.kill()
    return [np.load(o) for o in outs]


def _run(world, tmp_path_factory):
    if world not in _RUNS:
        _, params, batch = bench.golden_task()
        tmp = tmp_path_factory.mktemp(f"decentralized{world}")
        np.savez(tmp / "data.npz", x=np.asarray(batch["x"]), y=np.asarray(batch["y"]))
        np.savez(tmp / "params.npz", **{f"{layer}.{k}": np.asarray(v)
                                        for layer, leaves in params.items()
                                        for k, v in leaves.items()})
        _RUNS[world] = _spawn(world, [str(tmp / "data.npz"), str(STEPS), ",".join(ALGOS[world]),
                                      str(tmp / "params.npz")], tmp)
    return _RUNS[world]


def _jax_run(world, algo):
    """The JAX trainer's losses and, after every step, its stacked
    per-rank parameters by the port's names and its algorithm state's
    flats (each ``[steps, world, ...]``)."""
    if (world, algo) not in _JAX:
        loss_fn, params, batch = bench.golden_task()
        factory, hierarchical = JAX_ALGORITHMS[algo]
        axes = {"inter": world // 2, "intra": 2} if hierarchical else {"dp": world}
        mesh = build_mesh(axes, jax.devices()[:world])
        trainer = JTrainer(loss_fn, optax.sgd(LR), factory(), autotune=False, mesh=mesh,
                           flat_resident="off")
        state = trainer.init(params)
        losses, trace = [], {}
        for _ in range(STEPS):
            state, loss = trainer.train_step(state, batch)
            losses.append(float(loss))
            for name in NAMES:
                layer, leaf = name.split(".")
                trace.setdefault(name, []).append(np.asarray(state.params[layer][leaf]))
            for key, flats in (state.algo_state or {}).items():
                trace.setdefault(key, []).append(
                    np.concatenate([np.asarray(f) for f in flats], axis=1))
        _JAX[world, algo] = np.array(losses), {k: np.stack(v) for k, v in trace.items()}
    return _JAX[world, algo]


def _trace(outs, algo, key):
    """``[ranks, steps, ...]`` of one traced quantity of the port's run."""
    return np.stack([o[f"{algo}/trace/{key}"] for o in outs])


def _close(got, want, algo, what=""):
    """Full precision within rtol 1e-5 / atol 1e-6; low precision within
    ``LOWPREC_TOL``, but for a share of at most ``LOWPREC_LEVEL_SHARE`` one
    grid level apart (within ``LOWPREC_LEVEL_TOL``)."""
    got, want = np.asarray(got), np.asarray(want)
    if not algo.startswith("lowprec"):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=what)
        return
    np.testing.assert_allclose(got, want, rtol=0, atol=LOWPREC_LEVEL_TOL, err_msg=what)
    off = ~np.isclose(got, want, rtol=LOWPREC_TOL, atol=LOWPREC_TOL)
    assert off.mean() <= LOWPREC_LEVEL_SHARE, (
        f"{what}: {off.sum()} of {off.size} values beyond {LOWPREC_TOL}, largest gap "
        f"{np.abs(got - want).max():.3g}")


# ---------------------------------------------------------------------------
# the pairing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4, 8, 16])
def test_shift_one_peer_matches_jax(n):
    period = n // 2
    for step in range(2 * period):
        peers = [bt.shift_one_peer(r, n, step) for r in range(n)]
        assert peers == [jax_shift_one_peer(r, n, step) for r in range(n)]
        assert all(peers[peers[r]] == r for r in range(n)), (n, step, peers)
        assert sorted(peers) == list(range(n))
    # one period later the pairing repeats
    assert [bt.shift_one_peer(r, n, 0) for r in range(n)] == \
        [bt.shift_one_peer(r, n, period) for r in range(n)]


class _FourRanks(BaguaCommunicator):
    """Rank 0 of four, with no process group: the pairing check runs
    before anything goes on the wire."""

    def __init__(self):
        pass

    def nranks(self):
        return 4

    def rank(self):
        return 0


def test_exchange_with_peer_checks_the_pairing():
    comm, x = _FourRanks(), torch.arange(3.0)
    with pytest.raises(ValueError, match="not an involution"):
        comm.exchange_with_peer(x, lambda r, n, s: (r + 1) % n, 0)
    with pytest.raises(ValueError, match="not an involution"):
        comm.exchange_with_peer(x, lambda r, n, s: n, 0)
    # every rank its own partner: nothing is sent and each keeps its value
    y = comm.exchange_with_peer(x, lambda r, n, s: r, 0)
    assert torch.equal(y, x) and y is not x


def test_constructors_check_their_arguments():
    with pytest.raises(ValueError, match="peer_selection_mode"):
        bt.DecentralizedAlgorithm(peer_selection_mode="ring")
    with pytest.raises(ValueError, match="communication_interval"):
        bt.DecentralizedAlgorithm(communication_interval=0)
    with pytest.raises(ValueError, match="communication_interval"):
        bt.LowPrecisionDecentralizedAlgorithm(communication_interval=0)
    for algo in (bt.DecentralizedAlgorithm(), bt.LowPrecisionDecentralizedAlgorithm()):
        assert algo.replicated_params is False and algo.hierarchical is True
    assert bt.GradientAllReduceAlgorithm().replicated_params is True


# ---------------------------------------------------------------------------
# against the JAX trainer, rank by rank
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world,algo", CASES)
def test_tracks_the_jax_trainer_rank_by_rank(world, algo, tmp_path_factory):
    outs = _run(world, tmp_path_factory)
    want_losses, want = _jax_run(world, algo)
    for name in NAMES:
        _close(_trace(outs, algo, name).swapaxes(0, 1), want[name], algo, name)
    for o in outs:
        _close(o[f"{algo}/losses"], want_losses, algo, "losses")
    for key in ("peer_weights", "left", "right", "self"):
        if key in want:
            _close(_trace(outs, algo, key).swapaxes(0, 1), want[key], algo, key)


@pytest.mark.parametrize("world,algo", CASES)
def test_losses_equal_on_every_rank_and_falling(world, algo, tmp_path_factory):
    outs = _run(world, tmp_path_factory)
    losses = outs[0][f"{algo}/losses"]
    for o in outs[1:]:
        np.testing.assert_array_equal(o[f"{algo}/losses"], losses)
    assert np.isfinite(losses).all() and losses[-1] < 0.9 * losses[0], losses


@pytest.mark.parametrize("world,algo", [(2, "dec_all"), (4, "dec_shift_one"), (2, "lowprec"),
                                        (4, "lowprec")])
def test_ranks_hold_their_own_weights(world, algo, tmp_path_factory):
    # the gossip families are not replicated: after a step the ranks'
    # weights differ, and eval_step averages each rank's own loss
    outs = _run(world, tmp_path_factory)
    params = _trace(outs, algo, "params")[:, -1]
    assert all(not np.array_equal(params[0], p) for p in params[1:])
    loss_fn, _, batch = bench.golden_task()
    rows = batch["x"].shape[0] // world
    own = [float(loss_fn({"dense_0": {"bias": o[f"{algo}/dense_0.bias"],
                                      "kernel": o[f"{algo}/dense_0.kernel"]},
                          "dense_1": {"bias": o[f"{algo}/dense_1.bias"],
                                      "kernel": o[f"{algo}/dense_1.kernel"]}},
                         {k: v[r * rows:(r + 1) * rows] for k, v in batch.items()}))
           for r, o in enumerate(outs)]
    for o in outs:
        np.testing.assert_allclose(o[f"{algo}/eval_loss"], np.mean(own), rtol=1e-6)


def test_one_node_hierarchical_is_the_all_average(tmp_path_factory):
    # two ranks on one node: the inter-node tier has one rank, so
    # hierarchical=True is the intra-node average alone, the same sum and
    # division as ``all``: bit for bit
    for o in _run(2, tmp_path_factory):
        for algo in ("dec_hier", "dec_default"):
            for name in NAMES:
                np.testing.assert_array_equal(o[f"{algo}/trace/{name}"],
                                              o[f"dec_all/trace/{name}"])


# ---------------------------------------------------------------------------
# the invariants
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world,algo", [(2, "dec_all"), (2, "dec_all_i2"), (2, "dec_hier"),
                                        (4, "dec_all"), (4, "dec_all_i2"), (4, "dec_hier"),
                                        (4, "dec_hier_shift_one")])
def test_peer_weights_identical_on_every_rank(world, algo, tmp_path_factory):
    # after every step, skip steps included (interval 2 exchanges at steps
    # 0, 2, 4 and keeps the last peer weights between them); at 2 x 2 the
    # node average makes shift_one over the two nodes a world average too
    outs = _run(world, tmp_path_factory)
    peer = _trace(outs, algo, "peer_weights")
    for r in range(1, world):
        np.testing.assert_array_equal(peer[r], peer[0])
    if algo.endswith("_i2"):
        np.testing.assert_array_equal(peer[:, 1::2], peer[:, 0::2])


@pytest.mark.parametrize("algo,interval", [("dec_shift_one", 1), ("dec_shift_one_i2", 2)])
def test_shift_one_peer_weights_pair_up(algo, interval, tmp_path_factory):
    outs = _run(4, tmp_path_factory)
    peer = _trace(outs, algo, "peer_weights")
    params = _trace(outs, algo, "params")
    for step in range(STEPS):
        k = step // interval
        for r in range(4):
            np.testing.assert_array_equal(peer[r, step], peer[bt.shift_one_peer(r, 4, k), step])
        if step % interval:
            np.testing.assert_array_equal(peer[:, step], peer[:, step - 1])
    # ranks 0 and 1 are never partners at world 4, so their peer weights
    # differ once the weights have drifted apart
    assert not np.array_equal(peer[0, -1], peer[1, -1])
    assert not np.array_equal(params[0, -1], params[1, -1])


def _ring_neighbours(world, hierarchical, r):
    """Global ranks of rank r's left and right gossip neighbours: the flat
    ring, or the inter-node ring of the ranks of r's local index."""
    intra = 2 if hierarchical else 1
    n, i, local = world // intra, r // intra, r % intra
    return ((i - 1) % n) * intra + local, ((i + 1) % n) * intra + local


@pytest.mark.parametrize("world,algo,interval", [(2, "lowprec", 1), (2, "lowprec_i2", 2),
                                                 (4, "lowprec", 1), (4, "lowprec_default", 1)])
def test_low_precision_replica_invariant(world, algo, interval, tmp_path_factory):
    # after every step; the parameters equal ``self`` after an exchange (a
    # step without one moves the parameters alone)
    outs = _run(world, tmp_path_factory)
    left, right, mine = (_trace(outs, algo, k) for k in ("left", "right", "self"))
    params = _trace(outs, algo, "params")
    for r in range(world):
        lo, hi = _ring_neighbours(world, algo == "lowprec_default", r)
        np.testing.assert_array_equal(left[r], mine[lo])
        np.testing.assert_array_equal(right[r], mine[hi])
        np.testing.assert_array_equal(params[r, ::interval], mine[r, ::interval])
        if interval > 1:
            np.testing.assert_array_equal(mine[r, 1::2], mine[r, 0::2])
            assert not np.array_equal(params[r, 1], mine[r, 1])
    # the first and the last rank are on other nodes at 2 x 2 (the two
    # ranks of a node hold the same node average)
    assert not np.array_equal(mine[0, -1], mine[-1, -1])


@pytest.mark.parametrize("world,algo,calls", [
    (2, "dec_default", 0), (2, "lowprec_default", 0), (2, "dec_all", 0),
    (2, "lowprec", 4 * STEPS), (2, "lowprec_i2", 4 * STEPS // 2), (4, "lowprec", 4 * STEPS),
    (4, "lowprec_default", 4 * STEPS),
])
def test_codec_calls(world, algo, calls, tmp_path_factory):
    # one compress and three decompresses a bucket and exchange (one bucket
    # here); the default constructors on one node call no codec
    for o in _run(world, tmp_path_factory):
        assert int(o[f"{algo}/n_buckets"]) == 1
        assert int(o[f"{algo}/codec_calls"]) == calls


def test_one_node_low_precision_default_is_the_node_average(tmp_path_factory):
    # no ring: the parameters after the optimizer step are averaged within
    # the node, so both ranks hold the same weights and the replicas never
    # move from the initial weights
    outs = _run(2, tmp_path_factory)
    params = _trace(outs, "lowprec_default", "params")
    np.testing.assert_array_equal(params[0], params[1])
    mine = _trace(outs, "lowprec_default", "self")
    np.testing.assert_array_equal(mine[:, -1], mine[:, 0])


# ---------------------------------------------------------------------------
# the numpy ring golden (test_low_precision_decentralized.py:40-110)
# ---------------------------------------------------------------------------


def _numpy_ring_golden(world):
    """The low-precision ring of ``test_low_precision_decentralized.py`` on
    the golden task: each rank's SGD step on its batch slice (JAX's
    gradient), then the simultaneous compressed exchange with the golden
    codec; returns ``[steps, world, numel]`` in the bucket order ``order``."""
    loss_fn, params, batch = bench.golden_task()
    grad_fn = jax.jit(jax.grad(loss_fn))
    # the port's bucket order: reversed registration order of FlaxLayoutMLP
    order = ["dense_1.kernel", "dense_1.bias", "dense_0.kernel", "dense_0.bias"]
    shapes = {n: np.asarray(params[n.split(".")[0]][n.split(".")[1]]).shape for n in order}

    def flatten(tree):
        return np.concatenate([np.asarray(tree[n.split(".")[0]][n.split(".")[1]]).ravel()
                               for n in order]).astype(np.float32)

    def unflatten(vec):
        tree, off = {"dense_0": {}, "dense_1": {}}, 0
        for n in order:
            size = int(np.prod(shapes[n]))
            tree[n.split(".")[0]][n.split(".")[1]] = vec[off:off + size].reshape(shapes[n])
            off += size
        return tree

    codec = MinMaxUInt8Numpy()
    flat0 = flatten(params)
    x = [flat0.copy() for _ in range(world)]
    left = [flat0.copy() for _ in range(world)]
    right = [flat0.copy() for _ in range(world)]
    mine = [flat0.copy() for _ in range(world)]
    rows = batch["x"].shape[0] // world
    out = []
    for _ in range(STEPS):
        for r in range(world):
            shard = {k: v[r * rows:(r + 1) * rows] for k, v in batch.items()}
            x[r] = x[r] - LR * flatten(grad_fn(unflatten(x[r]), shard))
        comp = [codec.compress(x[r] + left[r] / 3.0 + right[r] / 3.0 - (5.0 / 3.0) * mine[r])
                for r in range(world)]
        for r in range(world):
            left[r] = left[r] + codec.decompress(*comp[(r - 1) % world])
            right[r] = right[r] + codec.decompress(*comp[(r + 1) % world])
        for r in range(world):
            x[r] = mine[r] + codec.decompress(*comp[r])
            mine[r] = x[r].copy()
        out.append(np.stack(x))
    return np.stack(out), order


@pytest.mark.parametrize("world", [2, 4])
def test_low_precision_matches_numpy_ring_golden(world, tmp_path_factory):
    outs = _run(world, tmp_path_factory)
    want, order = _numpy_ring_golden(world)
    got = _trace(outs, "lowprec", "params").swapaxes(0, 1)
    # the worker's bucket holds the same tensors in the same order
    flat = np.concatenate([outs[0][f"lowprec/{n}"].ravel() for n in order])
    np.testing.assert_array_equal(flat, got[-1, 0])
    _close(got, want, "lowprec", "numpy golden")


# ---------------------------------------------------------------------------
# one rank
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["decentralized", "low_precision"])
def test_world_one_is_plain_sgd(family):
    # one rank: no gossip, so the run is the replicated SGD run bit for bit
    bt.init_process_group(device="cpu")
    _, _, batch = bench.golden_task()
    x = torch.from_numpy(np.array(batch["x"]))
    y = torch.from_numpy(np.asarray(batch["y"]).astype(np.int64))

    def ce(m, b):
        return torch.nn.functional.cross_entropy(m(b["x"]), b["y"])

    sgd = lambda p: torch.optim.SGD(p, lr=LR)
    gossip = (bt.DecentralizedAlgorithm(hierarchical=False, peer_selection_mode="shift_one")
              if family == "decentralized" else bt.LowPrecisionDecentralizedAlgorithm())
    runs = []
    for algo in (gossip, bt.GradientAllReduceAlgorithm()):
        model = MLP(4, features=(32, 8), device="cpu", seed=0)
        trainer = bt.BaguaTrainer(ce, sgd, algo, device="cpu")
        state = trainer.init(model)
        losses = []
        for _ in range(4):
            state, loss = trainer.train_step(state, {"x": x, "y": y})
            losses.append(loss.item())
        runs.append((losses, [p.detach().clone() for p in model.parameters()]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
