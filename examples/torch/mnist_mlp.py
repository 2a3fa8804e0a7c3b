"""Minimum end-to-end example on the port (counterpart of
``examples/mnist_mlp.py`` and the reference Bagua's ``examples/mnist/main.py``):
an MLP on real handwritten digits (the vendored 8x8 scans,
``bagua_tpu_torch/contrib/digits_data.py``) under any of the six families of
``make_algorithm``; ``--data synthetic`` switches to the MNIST-shaped
synthetic teacher task (numpy from ``--seed``).

    python examples/torch/mnist_mlp.py --device cpu
    bagua-tpu-torch-run --nproc_per_node 2 examples/torch/mnist_mlp.py --algorithm bytegrad

The digits train set is cut to a multiple of ``--train-multiple-of`` rows
(default: the world size), so that it splits evenly over the ranks.
"""

import argparse
import functools
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import bagua_tpu_torch as bt  # noqa: E402
from bagua_tpu_torch.device import resolve_device  # noqa: E402
from bagua_tpu_torch.models.mlp import MLP  # noqa: E402

FAMILIES = ("gradient_allreduce", "bytegrad", "decentralized", "low_precision_decentralized",
            "async", "qadam")


def make_algorithm(name: str):
    return {
        "gradient_allreduce": lambda: bt.GradientAllReduceAlgorithm(),
        "bytegrad": lambda: bt.ByteGradAlgorithm(),
        "decentralized": lambda: bt.DecentralizedAlgorithm(),
        "low_precision_decentralized": lambda: bt.LowPrecisionDecentralizedAlgorithm(),
        "async": lambda: bt.AsyncModelAverageAlgorithm(),
        "qadam": lambda: bt.QAdamAlgorithm(warmup_steps=20),
    }[name]()


def loss_fn(model, batch):
    return F.cross_entropy(model(batch["x"]), batch["y"].long())


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--algorithm", default="gradient_allreduce", choices=FAMILIES)
    ap.add_argument("--data", choices=("digits", "synthetic"), default="digits",
                    help="real vendored digit scans (default) or the synthetic "
                         "fixed-teacher task")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch-per-device", type=int, default=None,
                    help="synthetic mode only (default 32); digits mode trains full-batch")
    ap.add_argument("--lr", type=float, default=None,
                    help="default: 2e-3 (adam) on digits, 0.05 (sgd+mom) synthetic")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--train-multiple-of", type=int, default=None,
                    help="digits mode: cut the train set to a multiple of this many rows "
                         "(default: the world size)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def run(args, params=None) -> dict:
    """Train ``args.steps`` steps.  ``params``: a flax param tree of the JAX
    example's ``MLP`` as numpy arrays, loaded through
    ``models.convert.params_from_jax``; None draws from ``--seed``.
    Returns the losses (every step) and the test accuracy (digits)."""
    if args.data == "digits" and args.batch_per_device is not None:
        raise SystemExit("--batch-per-device only applies to --data synthetic "
                         "(digits trains full-batch)")
    device = resolve_device(args.device)
    bt.init_process_group(device=device)
    world = bt.get_world_size()
    x_test = y_test = None
    if args.data == "digits":
        from bagua_tpu_torch.contrib.digits_data import load_digits_dataset

        x, y, x_test, y_test = load_digits_dataset(
            train_multiple_of=args.train_multiple_of or world)
        lr = 2e-3 if args.lr is None else args.lr
        opt = functools.partial(torch.optim.Adam, lr=lr, eps=1e-8)
    else:
        rng = np.random.default_rng(args.seed)
        batch = (args.batch_per_device or 32) * world
        x = rng.standard_normal((batch, 28 * 28)).astype(np.float32)
        teacher = rng.standard_normal((28 * 28, 10)).astype(np.float32)
        y = np.argmax(x @ teacher, axis=-1)
        lr = 0.05 if args.lr is None else args.lr
        opt = functools.partial(torch.optim.SGD, lr=lr, momentum=0.9)
    model = MLP(x.shape[1], features=(128, 64, 10), device=device, seed=args.seed)
    if params is not None:
        from bagua_tpu_torch.models.convert import params_from_jax

        model.load_state_dict(params_from_jax(params, model))
    algo = make_algorithm(args.algorithm)
    trainer = bt.BaguaTrainer(loss_fn, None if algo.owns_optimizer else opt, algo,
                              device=device, model_name="mnist_mlp")
    state = trainer.init(model)
    batch = trainer.shard_batch({"x": x, "y": y}, global_batch=True)
    losses = []
    for step in range(args.steps):
        state, loss = trainer.train_step(state, batch)
        losses.append(loss.item())
        if step % 20 == 0 or step == args.steps - 1:
            print(f"step {step} loss {losses[-1]:.6f}", flush=True)
    print(f"final_loss {losses[-1]:.6f}", flush=True)
    out = {"losses": losses, "world": world}
    if x_test is not None:
        with torch.no_grad():
            logits = state.model(torch.from_numpy(x_test).to(device))
        acc = (logits.argmax(-1).cpu().numpy() == y_test).mean().item()
        print(f"test_accuracy {acc:.4f}", flush=True)
        out["test_accuracy"] = acc
    return out


def main(argv=None):
    run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
