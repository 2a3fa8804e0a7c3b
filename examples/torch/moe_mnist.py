"""MoE MNIST on the port: expert parallelism end to end.

Counterpart of ``examples/moe_mnist.py`` (the reference Bagua's
``examples/moe/mnist_main.py``): two convolutions, a Dense, an ``MoEMLP``
hidden layer (4 experts, k 1, d_ff 128), the classifier.  MNIST-shaped
synthetic data from numpy seed 0 unless ``--mnist-dir`` holds the standard
IDX files.  At world ``n > 1`` the experts shard over ``{"dp": 1, "ep": n}``
(``max(4, n)`` experts).

    python examples/torch/moe_mnist.py --device cpu --steps 60
    bagua-tpu-torch-run --nproc_per_node 2 examples/torch/moe_mnist.py --dropless

The JAX example routes with capacity (GShard's dense dispatch and combine).
``--dropless`` routes every token through the grouped matmul instead
(``ops.gmm``: K7a and K7b on the card) and, having no capacity to drop at,
gives the same losses at every ep size.
"""

import argparse
import functools
import gzip
import math
import os
import struct
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch import nn  # noqa: E402

import bagua_tpu_torch as bt  # noqa: E402
from bagua_tpu_torch.device import resolve_device  # noqa: E402
from bagua_tpu_torch.model_parallel.moe import MoEMLP, globalize_expert_params  # noqa: E402
from bagua_tpu_torch.models.resnet import Conv  # noqa: E402


class MoEMnistNet(nn.Module):
    """Conv stem -> MoE hidden layer -> classifier, with flax's module names
    (``Conv_0``, ``Conv_1``, ``Dense_0``, ``MoEMLP_0``, ``Dense_1``); images
    NHWC ``[B, 28, 28, 1]`` as in the JAX example."""

    def __init__(self, n_experts: int = 4, ep_size: int = 1, dropless: bool = False,
                 device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.Conv_0 = Conv(1, 16, 3, 2, use_bias=True, dtype=torch.float32, device=device)
        self.Conv_1 = Conv(16, 32, 3, 2, use_bias=True, dtype=torch.float32, device=device)
        self.Dense_0 = nn.Linear(32 * 7 * 7, 64, device=device)
        self.MoEMLP_0 = MoEMLP(n_experts, 128, d_model=64, ep_size=ep_size, k=1,
                               dropless=dropless).to(device)
        self.Dense_1 = nn.Linear(64, 10, device=device)
        gen = torch.Generator(device=device).manual_seed(seed)
        with torch.no_grad():
            for conv in (self.Conv_0, self.Conv_1):
                fan_in = conv.weight[0].numel()
                conv.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=gen)
        self.MoEMLP_0.reset_parameters(gen)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)                     # NHWC -> NCHW for the convolutions
        x = F.relu(self.Conv_0(x))
        x = F.relu(self.Conv_1(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], 1, -1)   # NHWC order, as flax
        x = self.MoEMLP_0(self.Dense_0(x))
        # flax's Dense promotes the MoE's bf16 output to its f32 parameters
        return self.Dense_1(x.reshape(x.shape[0], -1).float())


def loss_fn(model, batch):
    return F.cross_entropy(model(batch["x"]), batch["y"].long())


def load_batches(args, rng):
    if args.mnist_dir:
        with gzip.open(os.path.join(args.mnist_dir, "train-images-idx3-ubyte.gz")) as f:
            _, num, rows, cols = struct.unpack(">IIII", f.read(16))
            images = np.frombuffer(f.read(), np.uint8).reshape(num, rows, cols, 1)
        with gzip.open(os.path.join(args.mnist_dir, "train-labels-idx1-ubyte.gz")) as f:
            struct.unpack(">II", f.read(8))
            labels = np.frombuffer(f.read(), np.uint8)
        images = images.astype(np.float32) / 255.0
    else:   # synthetic MNIST-shaped, deterministic (the JAX example's draws)
        images = rng.normal(size=(args.batch * 8, 28, 28, 1)).astype(np.float32)
        labels = rng.integers(0, 10, args.batch * 8)
    return images, labels.astype(np.int64)


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=64, help="the global batch")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--mnist-dir", type=str, default=None)
    ap.add_argument("--dropless", action="store_true",
                    help="route through the grouped matmul, no capacity")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def run(args, params=None) -> dict:
    """Train ``args.steps`` steps.  ``params``: a flax param tree of the JAX
    example's ``MoEMnistNet`` with GLOBAL expert tables (numpy), loaded
    through ``params_from_jax`` (each rank keeps its experts); None draws
    from seed 0, the experts from one global draw.  Returns the losses."""
    device = resolve_device(args.device)
    bt.init_process_group(device=device)
    world = bt.get_world_size()
    ep = world if world > 1 else 1
    mesh = bt.build_mesh({"dp": 1, "ep": ep}) if ep > 1 else None
    if mesh is not None:
        bt.set_global_mesh(mesh)
    try:
        model = MoEMnistNet(n_experts=max(4, ep), ep_size=ep, dropless=args.dropless,
                            device=device)
        if params is not None:
            from bagua_tpu_torch.models.convert import params_from_jax

            model.load_state_dict(params_from_jax(params, model))
        elif ep > 1:
            globalize_expert_params(model, torch.Generator(device=device).manual_seed(1))
        images, labels = load_batches(args, np.random.default_rng(0))
        trainer = bt.BaguaTrainer(loss_fn, functools.partial(torch.optim.Adam, lr=args.lr),
                                  bt.GradientAllReduceAlgorithm(), device=device, mesh=mesh,
                                  expert_axis="ep" if ep > 1 else None)
        state = trainer.init(model)
        losses = []
        for step in range(args.steps):
            lo = (step * args.batch) % (len(images) - args.batch)
            batch = trainer.shard_batch({"x": images[lo:lo + args.batch],
                                         "y": labels[lo:lo + args.batch]}, global_batch=True)
            state, loss = trainer.train_step(state, batch)
            losses.append(loss.item())
            if step % 10 == 0:
                print(f"step {step} loss {losses[-1]:.6f}", flush=True)
        print(f"final_loss {losses[-1]:.6f}", flush=True)
    finally:
        if mesh is not None:
            bt.set_global_mesh(None)
    return {"losses": losses, "world": world, "ep": ep, "model": model, "trainer": trainer}


def main(argv=None):
    losses = run(parser().parse_args(argv))["losses"]
    assert losses[-1] < losses[0], (losses[0], losses[-1])


if __name__ == "__main__":
    main()
