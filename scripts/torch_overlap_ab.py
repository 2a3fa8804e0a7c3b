"""Serialized against overlapped steps of the port's trainer, A B B A in one
call, on one NVIDIA GPU.

    python3 scripts/torch_overlap_ab.py [--algo gradient_allreduce|bytegrad] [--accum 2]
                                        [--steps 5]

Starts itself as two ranks sharing the card over gloo, as ``chip_smoke.py``'s
multi-rank phases do.  Each rank trains four fresh trainers over the full
BERT-Large of ``chip_smoke._build_run`` (the same weights, batch and AdamW
1e-4), with ``overlap`` off, on, on, off, ``--steps`` steps each, the
backward and the communication timed by ``chip_smoke._stage_timers``.  Rank 0
prints each run's step time (steps 2 to the last as one window), the medians
of its backward and of its communication (serialized) or of the main thread's
wait after the backward (overlapped), then one JSON line: the medians over
the two runs of each kind and the share of the serialized communication the
overlap hides.  The order balances the drift of a call (gloo through the
host varies between runs).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ORDER = ("off", "on", "on", "off")
WORKER_TIMEOUT = 600


def rank_main(rank, init, out, algo, accum, steps, device="cuda"):
    import bagua_tpu_torch as bt
    import chip_smoke as cs
    from bagua_tpu_torch.ops import codec as cd
    from bagua_tpu_torch.ops import flash_attention as fa

    device = torch.device(device)
    bt.init_process_group(init, world_size=2, rank=rank, device=device, backend="gloo")
    runs = []
    for i, overlap in enumerate(ORDER):
        kw = {"overlap": overlap, "accum_steps": accum}
        cfg, model, _, trainer, state, batch, _ = cs._build_run(
            rank, 2, (f"{overlap}{i}", None, algo, kw), device)
        times = cs._stage_timers(trainer)
        _, _, st, _ = cs.train_steps(trainer, state, batch, cs.BERT["b"] * cfg.max_seq_len,
                                     [fa, cd], steps=steps)
        runs.append({"overlap": overlap, "step_ms": st["step_ms"],
                     "backward_ms": statistics.median(times["backward_ms"][1:]),
                     "comm_ms": statistics.median(times["comm_ms"][1:])})
        del model, trainer, state
        cs.release()
    with open(out, "w") as f:
        json.dump(runs, f)
    torch.distributed.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--algo", default="gradient_allreduce",
                    choices=("gradient_allreduce", "bytegrad"))
    ap.add_argument("--accum", type=int, default=2)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--rank", type=int)
    ap.add_argument("--init")
    ap.add_argument("--out")
    args = ap.parse_args()
    if args.rank is not None:
        rank_main(args.rank, args.init, args.out, args.algo, args.accum, args.steps)
        return
    if not torch.cuda.is_available():
        sys.exit("torch_overlap_ab.py needs a CUDA card")
    import chip_smoke as cs

    card = cs.phase_device()
    cs.phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r), "--init",
             f"file://{os.path.join(tmp, 'store')}", "--out", outs[r], "--algo", args.algo,
             "--accum", str(args.accum), "--steps", str(args.steps)]) for r in range(2)]
        try:
            codes = [p.wait(timeout=WORKER_TIMEOUT) for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        if codes != [0, 0]:
            sys.exit(f"ranks exited with {codes}")
        with open(outs[0]) as f:
            runs = json.load(f)
    for r in runs:
        print(f"{args.algo} overlap={r['overlap']}: step {r['step_ms']:.3f} ms, backward "
              f"{r['backward_ms']:.3f} ms, {'wait' if r['overlap'] == 'on' else 'communication'} "
              f"{r['comm_ms']:.3f} ms (rank 0, medians of steps 2-{args.steps})")
    summary = {"card": card, "algo": args.algo, "accum_steps": args.accum, "steps": args.steps,
               "order": list(ORDER), "runs": runs}
    for kind in ("off", "on"):
        mine = [r for r in runs if r["overlap"] == kind]
        summary[kind] = {k: statistics.median(r[k] for r in mine)
                         for k in ("step_ms", "backward_ms", "comm_ms")}
    summary["hidden_share"] = 1 - summary["on"]["comm_ms"] / summary["off"]["comm_ms"]
    print(card)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
