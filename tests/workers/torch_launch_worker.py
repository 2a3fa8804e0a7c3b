"""A training script for the port's launcher (tests/test_torch_launcher.py).

    python -m bagua_tpu_torch.distributed.run [launcher flags] \
        torch_launch_worker.py --data DATA_NPZ --params PARAMS_NPZ \
        --ckpt-dir DIR --out OUT_DIR [--steps N] [--save-every K] \
        [--algo ga|bytegrad] [--device cpu] [--crash-at-step S] [--wedge-at-step S]

The port's counterpart of ``examples/elastic_training.py`` and
``tests/workers/watchdog_drill_worker.py``: the golden-task MLP (the flax
params of ``PARAMS_NPZ``, ``torch_trainer_worker.FlaxLayoutMLP``) trained
with SGD 0.1 on this rank's contiguous slice
(``bagua_tpu_torch.elastic.shard_bounds``) of the one fixed batch of
``DATA_NPZ``, so a run resized between worlds follows the same trajectory up
to the reassociation of the sums.  It joins the launcher's rendezvous
(``init_process_group`` with no ``init_method``), restores the newest
checkpoint of ``--ckpt-dir`` if there is one (``resumed from checkpoint step
K``), saves every ``--save-every`` steps (async), and writes
``OUT_DIR/final_rank{RANK}.json`` (the losses by step, the last loss, the
parameters' digest) at the end.  Each step appends a line
``{"world", "rank", "step", "loss", "epoch"}`` to
``OUT_DIR/steps_rank{RANK}.jsonl``.

Failures, on the first attempt only (a marker file in ``OUT_DIR`` per rank;
``BAGUA_TEST_CRASH_EVERY=1`` repeats the crash on every attempt):

- ``--crash-at-step S[,S2...]`` (or ``BAGUA_TEST_CRASH_AT_STEP``): exit 1
  before step S (each step once: ``3,7`` restarts twice);
- ``--wedge-at-step S`` (or ``BAGUA_TEST_WEDGE_AT_STEP``): a host wedge
  before step S, where a hung collective would block: an armed
  ``collective.hang`` fault (``bagua_tpu_torch.faults.inject.maybe_hang``)
  inside a section of the trainer's hang watchdog, which must end the
  process with exit code 3 after ``BAGUA_COMM_TIMEOUT_S``.

``BAGUA_TEST_STEP_DELAY`` sleeps that many seconds after each step (the
elastic test kills a node mid-run).  Imports only torch, numpy and the port.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

import bagua_tpu_torch as bt
from bagua_tpu_torch.checkpoint import compute_state_digest
from bagua_tpu_torch.elastic import ElasticContext, shard_bounds
from bagua_tpu_torch.faults import inject

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_trainer_worker import FlaxLayoutMLP  # noqa: E402


def _first_attempt(out, what, rank):
    """True the first time (a marker per rank), always with
    ``BAGUA_TEST_CRASH_EVERY=1``."""
    marker = os.path.join(out, f"{what}_rank{rank}.marker")
    if os.environ.get("BAGUA_TEST_CRASH_EVERY") == "1":
        return True
    if os.path.exists(marker):
        return False
    with open(marker, "w") as f:
        f.write("1")
    return True


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True)
    ap.add_argument("--params", required=True)
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--save-every", type=int, default=2)
    ap.add_argument("--algo", default="ga", choices=("ga", "bytegrad"))
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--crash-at-step", default=os.environ.get("BAGUA_TEST_CRASH_AT_STEP", ""))
    ap.add_argument("--wedge-at-step", type=int,
                    default=int(os.environ.get("BAGUA_TEST_WEDGE_AT_STEP", "-1")))
    args = ap.parse_args()
    crash_at = {int(v) for v in args.crash_at_step.split(",") if v}
    # leave the CPU to the tests that run beside this one
    os.nice(10)
    torch.set_num_threads(1)
    ctx = ElasticContext.from_env()
    ctx.init_process_group(device=args.device)
    rank, world = bt.get_rank(), bt.get_world_size()
    print(f"worker rank {rank}: world {world} (epoch {ctx.epoch})", flush=True)

    data = np.load(args.data)
    lo, hi = shard_bounds(data["x"].shape[0], rank, world)
    batch = {"x": torch.from_numpy(data["x"][lo:hi]),
             "y": torch.from_numpy(data["y"][lo:hi].astype(np.int64))}
    algo = (bt.ByteGradAlgorithm(hierarchical=False) if args.algo == "bytegrad"
            else bt.GradientAllReduceAlgorithm())
    trainer = bt.BaguaTrainer(
        lambda m, b: torch.nn.functional.cross_entropy(m(b["x"]), b["y"]),
        lambda p: torch.optim.SGD(p, lr=0.1), algo, device=args.device, bucket_bytes=256)
    state = trainer.init(FlaxLayoutMLP(np.load(args.params)))
    mgr = bt.BaguaCheckpointManager(args.ckpt_dir, async_save=True, max_to_keep=100)
    step, state = trainer.restore_checkpoint(mgr, state) if mgr.latest_step() is not None \
        else (None, state)
    if step is not None:
        print(f"resumed from checkpoint step {step}", flush=True)
    losses = {}
    log_path = os.path.join(args.out, f"steps_rank{rank}.jsonl")
    delay = float(os.environ.get("BAGUA_TEST_STEP_DELAY", "0"))
    while state.step < args.steps:
        i = state.step
        if i in crash_at and _first_attempt(args.out, f"crash{i}", rank):
            print(f"injected crash at step {i}", flush=True)
            sys.stdout.flush()
            os._exit(1)
        if i == args.wedge_at_step and _first_attempt(args.out, "wedge", rank):
            print(f"injecting host wedge at step {i}", flush=True)
            inject.set_plan(inject.FaultPlan([inject.FaultSpec("collective.hang",
                                                                duration_s=600.0, count=-1)]))
            with trainer._watchdog.watch(f"train_step[{i}]"):
                inject.maybe_hang()
            raise AssertionError("the watchdog did not end the wedged worker")
        state, loss = trainer.train_step(state, batch)
        losses[i] = float(loss)
        with open(log_path, "a") as f:
            f.write(json.dumps({"world": world, "rank": rank, "step": i, "loss": losses[i],
                                "epoch": ctx.epoch}) + "\n")
        if state.step % args.save_every == 0:
            trainer.save_checkpoint(mgr, state.step, state)
        if delay:
            time.sleep(delay)
    mgr.close()
    digest = compute_state_digest({n: p.detach() for n, p in state.model.named_parameters()})
    with open(os.path.join(args.out, f"final_rank{rank}.json"), "w") as f:
        json.dump({"losses": losses, "final_loss": losses.get(args.steps - 1),
                   "digest": digest["digest"], "world": world, "resumed_from": step}, f)
    print(f"final_loss {losses.get(args.steps - 1)}", flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
