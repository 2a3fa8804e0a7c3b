"""Elastic training on the port (counterpart of ``examples/elastic_training.py``
and the reference Bagua's ``examples/elastic_training/main.py``): checkpoint
every N steps, resume from the newest checkpoint on (re)start.  The
launcher's gang restart (``bagua-tpu-torch-run --max_restarts``) makes this
the recovery path after any worker failure.

    bagua-tpu-torch-run --nproc_per_node 2 --max_restarts 1 \\
        examples/torch/elastic_training.py --ckpt-dir /tmp/ck --device cpu

Crash injection for tests: with ``BAGUA_TEST_CRASH_AT_STEP=k`` the process
exits 1 at step k on the FIRST attempt (a marker file of the rank's in
``--ckpt-dir`` suppresses repeats; one a rank, so every rank crashes on the
first attempt and none waits in a collective for a crashed peer).
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
from bagua_tpu_torch.checkpoint import BaguaCheckpointManager  # noqa: E402
from bagua_tpu_torch.device import resolve_device  # noqa: E402
from bagua_tpu_torch.models.mlp import MLP  # noqa: E402


def loss_fn(model, batch):
    return F.cross_entropy(model(batch["x"]), batch["y"].long())


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--save-every", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def run(args, params=None) -> dict:
    """Train to ``args.steps``, resuming from ``--ckpt-dir``'s newest
    checkpoint if there is one.  ``params``: a flax param tree of the JAX
    example's ``MLP`` (numpy), loaded through ``params_from_jax``; None
    draws from ``--seed``.  Returns the losses of this call's steps, the
    step it started from and the step it resumed (None: a fresh start)."""
    device = resolve_device(args.device)
    bt.init_process_group(device=device)
    world = bt.get_world_size()
    rng = np.random.default_rng(args.seed)
    x = rng.standard_normal((8 * world, 16)).astype(np.float32)
    y = np.argmax(x @ rng.standard_normal((16, 8)).astype(np.float32), axis=-1)
    model = MLP(16, features=(32, 16, 8), device=device, seed=args.seed)
    if params is not None:
        from bagua_tpu_torch.models.convert import params_from_jax

        model.load_state_dict(params_from_jax(params, model))
    trainer = bt.BaguaTrainer(loss_fn, functools.partial(torch.optim.SGD, lr=0.1),
                              bt.GradientAllReduceAlgorithm(), device=device)
    state = trainer.init(model)
    batch = trainer.shard_batch({"x": x, "y": y}, global_batch=True)

    mgr = BaguaCheckpointManager(args.ckpt_dir, max_to_keep=2)
    # the trainer's layout sidecar rides every save: a restart at another
    # world size converts the state, or refuses a plan-locked layout with
    # an actionable error
    resumed = None
    if mgr.latest_step() is not None:
        resumed, state = trainer.restore_checkpoint(mgr, state)
        print(f"resumed from checkpoint step {resumed}", flush=True)
    start = 0 if resumed is None else resumed + 1

    crash_at = int(os.environ.get("BAGUA_TEST_CRASH_AT_STEP", -1))
    marker = os.path.join(args.ckpt_dir, f"crashed.rank{bt.get_rank()}.marker")
    losses = []
    for step in range(start, args.steps):
        if step == crash_at and not os.path.exists(marker):
            open(marker, "w").close()
            mgr.wait()
            print("injected crash", flush=True)
            sys.exit(1)
        state, loss = trainer.train_step(state, batch)
        losses.append(loss.item())
        if step % args.save_every == 0 or step == args.steps - 1:
            trainer.save_checkpoint(mgr, step, state)
        print(f"step {step} loss {losses[-1]:.6f}", flush=True)
    mgr.close()
    if losses:
        print(f"final_loss {losses[-1]:.6f}", flush=True)
    return {"losses": losses, "start": start, "resumed": resumed, "world": world}


def main(argv=None):
    run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
