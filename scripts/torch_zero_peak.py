"""The peak memory of ZeRO serialized against overlapped, on one NVIDIA GPU.

    python3 scripts/torch_zero_peak.py

Two ranks on the one card over gloo, as ``chip_smoke.py``'s zero and overlap
phases run them: the full BERT-Large (random weights from a seed) with
``ZeroOptimizerAlgorithm`` over AdamW, serialized (the zero phase's ``zero``
run) and with ``overlap="on"`` (the overlap phase's ``zero_overlap`` run),
``FULL_STEPS`` steps each, in the order A B B A in one process a rank, the
allocator's cache emptied before each run.  Prints, for each rank and run,
the allocated peak (``max_memory_allocated``: the blocks the caching
allocator handed out, each rounded up) and the requested peak
(``requested_bytes.all.peak``: the bytes the program asked for), the step
time and the per-step parameter fingerprints, then one JSON line with every
run.  Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

SERIAL = ("zero", None, "zero", {"steps": cs.FULL_STEPS})
OVERLAP = ("zero_overlap", None, "zero", {"overlap": "on", "steps": cs.FULL_STEPS})
ORDER = ((cs.compressed_run, SERIAL), (cs.overlap_run, OVERLAP), (cs.overlap_run, OVERLAP),
         (cs.compressed_run, SERIAL))


def worker(rank: int, init: str, out: str) -> None:
    import bagua_tpu_torch as bt

    cs._die_with_parent()
    device = torch.device("cuda")
    bt.init_process_group(init, world_size=2, rank=rank, device=device, backend="gloo")
    records = []
    for fn, run in ORDER:
        cs.release()
        rec = fn(rank, 2, run, device, "zero peak")
        st = rec["stats"]
        records.append({"run": run[0], "allocated_peak": round(st["peak_gb"] * 1e9),
                        "requested_peak": st["requested_peak_bytes"],
                        "step_ms": st["step_ms"],
                        "fingerprints": [cs._fp_total(fp) for fp in rec["param_fingerprints"]]})
    with open(out, "w") as f:
        json.dump(records, f)
    torch.distributed.destroy_process_group()


def main() -> int:
    if sys.argv[1:2] == ["--worker"]:
        worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        return 0
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(cs.phase_device(), flush=True)   # the card's name and power limit
    cs.phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{os.path.join(tmp, 'store')}"
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(2)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker",
                                   str(r), init, outs[r]]) for r in range(2)]
        try:
            codes = [p.wait(timeout=cs.WORKER_TIMEOUT) for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        if codes != [0, 0]:
            print(f"ranks exited with {codes}", file=sys.stderr)
            return 1
        ranks = []
        for path in outs:
            with open(path) as f:
                ranks.append(json.load(f))
    for r, records in enumerate(ranks):
        for i, rec in enumerate(records):
            print(f"rank {r} run {i} {rec['run']}: allocated peak {rec['allocated_peak']} bytes, "
                  f"requested peak {rec['requested_peak']} bytes, step {rec['step_ms']:.3f} ms, "
                  f"fingerprints {rec['fingerprints']}")
    print(json.dumps({"ranks": ranks}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
