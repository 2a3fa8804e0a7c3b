"""One rank of the port's gloo runs (tests/test_torch_trainer.py,
tests/test_torch_compressed.py).

    python torch_trainer_worker.py RANK WORLD INIT_METHOD DATA_NPZ OUT_NPZ STEPS [ALGOS [PARAMS_NPZ]]

Trains the golden-task MLP on this rank's contiguous slice of the batch in
``DATA_NPZ`` and writes the loss history and final params to ``OUT_NPZ``.
Without ``ALGOS`` it trains once with ``GradientAllReduceAlgorithm`` at
512-byte buckets from a per-rank random init (the trainer gives every rank
rank 0's weights) and writes unprefixed keys.  ``ALGOS`` is a comma-separated
list of ``bytegrad``, ``qadam``, ``int8`` (``GradientAllReduceAlgorithm``
with ``compress_intra="int8"``) and ``gradient_allreduce``, each trained at the
default bucket size from the flax params in ``PARAMS_NPZ`` (keys
``dense_<i>.kernel`` ``[in, out]`` and ``dense_<i>.bias``) held in flax's
layout, so that every bucket flat, and so every codec chunk, holds the same
elements as the JAX trainer's; keys prefixed ``<algo>/``.  Imports only
torch, numpy and the port.
"""

import functools
import sys

import numpy as np
import torch

import bagua_tpu_torch as bt
from bagua_tpu_torch.models.mlp import MLP

SGD = functools.partial(torch.optim.SGD, lr=0.1)


class FlaxLayoutMLP(torch.nn.Module):
    """The golden-task MLP with flax ``Dense`` kernels ``[in, out]``,
    registered in the order of the JAX package's sorted pytree flatten
    (``dense_0.bias``, ``dense_0.kernel``, ...).  torch's ``Linear`` keeps
    ``[out, in]``, which orders a bucket's elements differently, so a codec
    chunk would hold other elements than the JAX trainer's."""

    def __init__(self, params):
        super().__init__()
        self.n = len({k.split(".")[0] for k in params.files})
        for i in range(self.n):
            layer = torch.nn.Module()
            layer.bias = torch.nn.Parameter(torch.from_numpy(params[f"dense_{i}.bias"]))
            layer.kernel = torch.nn.Parameter(torch.from_numpy(params[f"dense_{i}.kernel"]))
            self.add_module(f"dense_{i}", layer)

    def forward(self, x):
        for i in range(self.n):
            layer = getattr(self, f"dense_{i}")
            x = x @ layer.kernel + layer.bias
            if i < self.n - 1:
                x = torch.relu(x)
        return x


def _trainer(algo, ce, bucket_bytes=None):
    kw = {"device": "cpu", "bucket_bytes": bucket_bytes}
    if algo == "bytegrad":
        return bt.BaguaTrainer(ce, SGD, bt.ByteGradAlgorithm(hierarchical=False), **kw)
    if algo == "qadam":
        return bt.BaguaTrainer(ce, None, bt.QAdamAlgorithm(warmup_steps=2, hierarchical=False),
                               **kw)
    if algo == "int8":
        return bt.BaguaTrainer(ce, SGD, bt.GradientAllReduceAlgorithm(),
                               compress_intra="int8", **kw)
    return bt.BaguaTrainer(ce, SGD, bt.GradientAllReduceAlgorithm(), **kw)


def main(rank, world, init_method, data_path, out_path, steps, algos=None, params_path=None):
    torch.set_num_threads(1)
    bt.init_process_group(init_method, world_size=world, rank=rank, device="cpu")
    data = np.load(data_path)
    rows = data["x"].shape[0] // world
    part = slice(rank * rows, (rank + 1) * rows)
    local = {"x": data["x"][part], "y": data["y"][part].astype(np.int64)}

    def ce(m, b):
        return torch.nn.functional.cross_entropy(m(b["x"]), b["y"])

    out = {}
    for algo in (algos or "gradient_allreduce").split(","):
        if algos is None:
            model = MLP(data["x"].shape[1], features=(32, 8), device="cpu", seed=int(rank))
            trainer, prefix = _trainer(algo, ce, bucket_bytes=512), ""
        else:
            model = FlaxLayoutMLP(np.load(params_path))
            trainer, prefix = _trainer(algo, ce), f"{algo}/"
        state = trainer.init(model)   # every rank starts from rank 0's weights
        batch = trainer.shard_batch(local)
        losses = []
        for _ in range(steps):
            state, loss = trainer.train_step(state, batch)
            losses.append(loss.item())
        out[prefix + "losses"] = np.array(losses)
        out[prefix + "n_buckets"] = len(trainer.plan.buckets)
        out.update({prefix + n: p.detach().numpy().copy() for n, p in model.named_parameters()})
    np.savez(out_path, **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    r, w, init, data, out, steps, *rest = sys.argv[1:]
    main(int(r), int(w), init, data, out, int(steps), *rest)
