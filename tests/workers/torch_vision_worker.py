"""One rank of the port's SyncBatchNorm checks over gloo
(tests/test_torch_contrib_sync_bn.py).

    python torch_vision_worker.py RANK WORLD INIT_METHOD IN_NPZ OUT_NPZ

Four ranks run every case; a case at world 2 runs on the mesh ``{"rep": 2,
"dp": 2}``, whose two ``dp`` pairs compute the same thing, one at world 4 on
``{"dp": 4}``.  ``IN_NPZ`` holds the inputs the test made with numpy and the
JAX package; each case writes its outputs under ``<case>/`` in
``OUT_NPZ``:

- ``bn_w2``, ``bn_w4``: ``SyncBatchNorm(axis_name="dp")`` on this rank's
  rows of ``x`` (``[N, C, A]``, features dim 1): the output, the running
  ``mean`` and ``var`` after the step, the batch statistics; then on this
  rank's rows of ``x2`` (``[N, C]``), the gradient of ``sum(y ** 2)`` with
  respect to them;
- ``train_sync``, ``train_local``: the small ResNet (``stage_sizes=(1,
  1)``, 8 filters, 4 classes, f32) from the flax params ``params/*`` (with
  ``SyncBatchNorm`` over dp, or the local norm), ``BaguaTrainer`` with SGD
  0.05 over the dp pair, 5 steps on this pair's halves of ``images`` and
  ``labels``: the losses and the parameters after the steps.

Imports only torch, numpy and the port.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import torch

import bagua_tpu_torch as bt
from bagua_tpu_torch.contrib import SyncBatchNorm
from bagua_tpu_torch.models.convert import params_from_jax
from bagua_tpu_torch.models.resnet import ResNet, classification_loss_fn

MESHES = {2: {"rep": 2, "dp": 2}, 4: {"dp": 4}}
STEPS = 5


def _unflat(flat):
    tree = {}
    for name, arr in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = arr
    return tree


def small_resnet(norm: str) -> ResNet:
    norm_cls = functools.partial(SyncBatchNorm, axis_name="dp") if norm == "sync" else None
    return ResNet(stage_sizes=(1, 1), num_classes=4, num_filters=8, dtype=torch.float32,
                  norm_dtype=torch.float32, norm_cls=norm_cls, device="cpu")


def _rows(x, mesh):
    n, i = mesh.size_of("dp"), mesh.index("dp")
    rows = x.shape[0] // n
    return x[i * rows:(i + 1) * rows]


def bn_case(data, mesh):
    bn = SyncBatchNorm(data["x"].shape[1], use_running_average=False, axis_name="dp")
    x = torch.from_numpy(_rows(data["x"], mesh))
    y = bn(x)
    mean, var = bn.batch_stats
    bn2 = SyncBatchNorm(data["x2"].shape[1], use_running_average=False, axis_name="dp")
    x2 = torch.from_numpy(_rows(data["x2"], mesh)).requires_grad_()
    (bn2(x2) ** 2).sum().backward()
    return {"y": y.detach().numpy(), "ra_mean": bn.mean.numpy(), "ra_var": bn.var.numpy(),
            "batch_mean": mean.numpy(), "batch_var": var.numpy(), "grad": x2.grad.numpy()}


def train_case(data, mesh, norm):
    prefix = f"params_{norm}/"
    params = _unflat({k[len(prefix):]: data[k] for k in data.files if k.startswith(prefix)})
    model = small_resnet(norm)
    model.load_state_dict(params_from_jax(params, model), strict=False)
    trainer = bt.BaguaTrainer(classification_loss_fn, functools.partial(torch.optim.SGD, lr=0.05),
                              bt.GradientAllReduceAlgorithm(), device="cpu", mesh=mesh)
    state = trainer.init(model)
    batch = trainer.shard_batch({"images": torch.from_numpy(data["images"]).permute(0, 3, 1, 2),
                                 "labels": torch.from_numpy(data["labels"])}, global_batch=True)
    losses = []
    for _ in range(STEPS):
        state, loss = trainer.train_step(state, batch)
        losses.append(loss.item())
    out = {"losses": np.array(losses), "world": np.array(trainer.world_size)}
    out.update({f"param/{n}": t.numpy() for n, t in trainer.unstack_params(state).items()})
    return out


CASES = {
    "bn_w2": (2, bn_case), "bn_w4": (4, bn_case),
    "train_sync": (2, functools.partial(train_case, norm="sync")),
    "train_local": (2, functools.partial(train_case, norm="local")),
}


def spawn(data, tmp, world=4, timeout=300):
    """Run ``world`` ranks of this worker over gloo on the arrays of
    ``data`` (name -> array); returns each rank's outputs."""
    np.savez(tmp / "in.npz", **data)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([repo, os.environ.get("PYTHONPATH", "")])}
    outs = [tmp / f"out{r}.npz" for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         f"file://{tmp / 'store'}", str(tmp / "in.npz"), str(outs[r])], env=env)
        for r in range(world)]
    try:
        codes = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert codes == [0] * world, codes
    return [dict(np.load(o)) for o in outs]


def main(rank, world, init_method, in_path, out_path):
    # the ranks yield the CPU to the suite's other tests (JAX's virtual
    # devices must meet at their collectives within a timeout)
    os.nice(10)
    torch.set_num_threads(1)
    bt.init_process_group(init_method, world_size=world, rank=rank, device="cpu")
    data = np.load(in_path)
    out = {}
    meshes = {n: bt.build_mesh(axes) for n, axes in MESHES.items()}
    for case, (n, run) in CASES.items():
        bt.set_global_mesh(meshes[n])
        torch.manual_seed(0)
        out.update({f"{case}/{k}": v for k, v in run(data, meshes[n]).items()})
        bt.set_global_mesh(None)
    np.savez(out_path, **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:])
