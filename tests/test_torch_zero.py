"""The port's ZeRO-1 (``ZeroOptimizerAlgorithm``) against the JAX package.

Mirrors ``tests/test_zero.py`` where the port has the parts.  The golden task
(``bench.golden_task``, 30 steps) is trained by
``tests/workers/torch_trainer_worker.py`` on 2 and 4 gloo ranks from the JAX
params, held in flax's ``[in, out]`` layout so that each codec chunk holds
the same elements on both sides; ``LOCAL_WORLD_SIZE=2``, so world 4 is two
nodes of two ranks and world 2 one node.

- ZeRO with SGD(0.1, momentum 0.9) (``bench._algorithms()["zero"]``) tracks
  the JAX trainer's ``ZeroOptimizerAlgorithm(optax.sgd(0.1, momentum=0.9))``
  within 1e-3 relative at every step: flat at world 2 and 4, staged at 2 x 2
  against ``hierarchical=True`` on ``{"inter": 2, "intra": 2}``, and at world
  2 through the int8 ring (``compress_intra="int8"``) and with
  ``clip_global_norm=0.5``.  XLA and gloo sum in other orders, and a one-ulp
  difference can move a value across an int8 step, as in
  ``tests/test_torch_compressed.py``.  Every rank holds the same losses and
  parameters, bit for bit.
- ZeRO with Adam equals the replicated ``GradientAllReduce`` + Adam within
  ``test_zero.py``'s tolerance (rtol 2e-5, atol 2e-6 on the parameters):
  both average the same two gradients and run the same elementwise update.
- Each rank's optimizer state totals ``padded_numel / world`` elements a
  moment, and ``padded_numel / intra`` when staged.
- ``hierarchical=True`` on one node is the flat path: bitwise the same run.
- A factory whose step clips by its own norm fails the elementwise probe.
"""

import functools
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
from bagua_tpu.algorithms.zero import ZeroOptimizerAlgorithm as JZero
from bagua_tpu.core.backend import BaguaTrainer as JTrainer
from bagua_tpu.parallel.mesh import build_mesh
from bagua_tpu_torch.models.mlp import MLP

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
WORKERS = REPO / "tests" / "workers"
STEPS = 30
ALGOS = {2: ("zero", "zero_hierarchical", "zero_int8", "zero_clip", "zero_adam", "adam"),
         4: ("zero", "zero_hierarchical")}
_RUNS = {}


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
        tmp = tmp_path_factory.mktemp(f"zero{world}")
        np.savez(tmp / "data.npz", x=np.asarray(batch["x"]), y=np.asarray(batch["y"]))
        np.savez(tmp / "params.npz", **{f"{layer}.{k}": np.asarray(v)
                                        for layer, leaves in params.items()
                                        for k, v in leaves.items()})
        _RUNS[world] = _spawn(world, [str(tmp / "data.npz"), str(STEPS), ",".join(ALGOS[world]),
                                      str(tmp / "params.npz")], tmp)
    return _RUNS[world]


def _jax_losses(world, algo):
    loss_fn, params, batch = bench.golden_task()
    kw = {}
    mesh = build_mesh({"dp": world}, jax.devices()[:world])
    clip = 0.5 if algo == "zero_clip" else None
    hierarchical = algo == "zero_hierarchical"
    if hierarchical:
        mesh = build_mesh({"inter": world // 2, "intra": 2}, jax.devices()[:world])
    if algo == "zero_int8":
        kw = {"compress_intra": "int8"}
    jalgo = JZero(optax.sgd(0.1, momentum=0.9), clip_global_norm=clip, hierarchical=hierarchical)
    trainer = JTrainer(loss_fn, None, jalgo, autotune=False, mesh=mesh, **kw)
    state = trainer.init(params)
    losses = []
    for _ in range(STEPS):
        state, loss = trainer.train_step(state, batch)
        losses.append(float(loss))
    return np.array(losses)


def _same_on_every_rank(outs, algo):
    got = outs[0][f"{algo}/losses"]
    for o in outs[1:]:
        np.testing.assert_array_equal(o[f"{algo}/losses"], got)
        for name in ("dense_0.kernel", "dense_0.bias", "dense_1.kernel", "dense_1.bias"):
            np.testing.assert_array_equal(o[f"{algo}/{name}"], outs[0][f"{algo}/{name}"])
    return got


@pytest.mark.parametrize("world,algo", [(2, "zero"), (4, "zero"), (4, "zero_hierarchical"),
                                        (2, "zero_int8"), (2, "zero_clip")])
def test_golden_task_tracks_the_jax_trainer(world, algo, tmp_path_factory):
    got = _same_on_every_rank(_run(world, tmp_path_factory), algo)
    want = _jax_losses(world, algo)
    gap = np.abs(got - want) / np.abs(want)
    assert gap.max() <= 1e-3, f"largest relative loss gap {gap.max():.3g} at step {gap.argmax()}"
    assert got[-1] < 0.7 * got[0]


def test_matches_replicated_adam(tmp_path_factory):
    outs = _run(2, tmp_path_factory)
    _same_on_every_rank(outs, "zero_adam")
    for name in ("dense_0.kernel", "dense_0.bias", "dense_1.kernel", "dense_1.bias"):
        np.testing.assert_allclose(outs[0][f"zero_adam/{name}"], outs[0][f"adam/{name}"],
                                   rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(outs[0]["zero_adam/losses"], outs[0]["adam/losses"],
                               rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("world,algo,moments,shards", [
    (2, "zero", ("momentum_buffer",), 2),
    (4, "zero", ("momentum_buffer",), 4),
    (2, "zero_adam", ("exp_avg", "exp_avg_sq"), 2),
])
def test_optimizer_state_is_sharded(world, algo, moments, shards, tmp_path_factory):
    for o in _run(world, tmp_path_factory):
        padded = int(o[f"{algo}/padded_numel"])
        assert padded % world == 0
        for key in moments:
            assert int(o[f"{algo}/state/{key}"]) == padded // shards, key


def test_hierarchical_opt_state_sharded_intra_only(tmp_path_factory):
    # staged at 2 x 2: the state is sharded over the two ranks of a node and
    # replicated across the nodes
    for o in _run(4, tmp_path_factory):
        padded = int(o["zero_hierarchical/padded_numel"])
        assert int(o["zero_hierarchical/state/momentum_buffer"]) == padded // 2


def test_hierarchical_flag_falls_back_on_flat_mesh(tmp_path_factory):
    # two ranks on one node: no inter-node tier, so hierarchical=True is the
    # flat path, bit for bit, with the state sharded over the world
    outs = _run(2, tmp_path_factory)
    for o in outs:
        for key in [k for k in o.files if k.startswith("zero/")]:
            np.testing.assert_array_equal(o[key], o["zero_hierarchical/" + key[len("zero/"):]])


class _ClippedAdam(torch.optim.Adam):
    """Adam whose step first clips the gradients by their global norm: not
    elementwise."""

    def step(self, closure=None):
        torch.nn.utils.clip_grad_norm_(self.param_groups[0]["params"], 1.0)
        return super().step(closure)


def test_rejects_norm_coupled_optimizer():
    with pytest.raises(ValueError, match="ELEMENTWISE"):
        bt.ZeroOptimizerAlgorithm(functools.partial(_ClippedAdam, lr=1e-3))
    # elementwise optimizers pass the probe, torch's foreach and fused forms too
    for factory in (functools.partial(torch.optim.AdamW, lr=1e-3),
                    functools.partial(torch.optim.AdamW, lr=1e-3, foreach=True),
                    functools.partial(torch.optim.AdamW, lr=1e-3, fused=True),
                    functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9),
                    None):
        bt.ZeroOptimizerAlgorithm(factory)
    algo = bt.ZeroOptimizerAlgorithm(functools.partial(_ClippedAdam, lr=1e-3),
                                     check_elementwise=False)
    assert algo.owns_optimizer and algo.sharded_opt_state and algo.align_to_world


def test_world_one_zero_is_replicated_adam():
    # one rank: the chunk is the whole flat, so ZeRO's update is the
    # replicated optimizer's, bit for bit
    bt.init_process_group(device="cpu")
    _, _, batch = bench.golden_task()
    x = torch.from_numpy(np.array(batch["x"]))
    y = torch.from_numpy(np.asarray(batch["y"]).astype(np.int64))

    def ce(m, b):
        return torch.nn.functional.cross_entropy(m(b["x"]), b["y"])

    adam = functools.partial(torch.optim.Adam, lr=1e-2)
    runs = []
    for algo, opt in ((bt.ZeroOptimizerAlgorithm(adam), None),
                      (bt.GradientAllReduceAlgorithm(), adam)):
        model = MLP(4, features=(32, 8), device="cpu", seed=0)
        trainer = bt.BaguaTrainer(ce, opt, algo, device="cpu")
        state = trainer.init(model)
        losses = []
        for _ in range(5):
            state, loss = trainer.train_step(state, {"x": x, "y": y})
            losses.append(loss.item())
        runs.append((losses, [p.detach().clone() for p in model.parameters()]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
