"""One rank of the port's two-rank gloo run (tests/test_torch_trainer.py).

    python torch_trainer_worker.py RANK WORLD INIT_METHOD DATA_NPZ OUT_NPZ STEPS

Trains the golden-task MLP on this rank's contiguous slice of the batch in
``DATA_NPZ`` and writes the loss history and final params to ``OUT_NPZ``.
Imports only torch, numpy and the port.
"""

import functools
import sys

import numpy as np
import torch

import bagua_tpu_torch as bt
from bagua_tpu_torch.models.mlp import MLP


def main(rank, world, init_method, data_path, out_path, steps):
    bt.init_process_group(init_method, world_size=world, rank=rank, device="cpu")
    data = np.load(data_path)
    rows = data["x"].shape[0] // world
    part = slice(rank * rows, (rank + 1) * rows)
    model = MLP(data["x"].shape[1], features=(32, 8), device="cpu", seed=int(rank))
    trainer = bt.BaguaTrainer(
        lambda m, b: torch.nn.functional.cross_entropy(m(b["x"]), b["y"]),
        functools.partial(torch.optim.SGD, lr=0.1),
        bt.GradientAllReduceAlgorithm(), device="cpu", bucket_bytes=512)
    state = trainer.init(model)   # every rank starts from rank 0's weights
    batch = trainer.shard_batch({"x": data["x"][part],
                                 "y": data["y"][part].astype(np.int64)})
    losses = []
    for _ in range(steps):
        state, loss = trainer.train_step(state, batch)
        losses.append(loss.item())
    np.savez(out_path, losses=np.array(losses),
             n_buckets=len(trainer.plan.buckets),
             **{n: p.detach().numpy() for n, p in model.named_parameters()})
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    r, w, init, data, out, steps = sys.argv[1:]
    main(int(r), int(w), init, data, out, int(steps))
