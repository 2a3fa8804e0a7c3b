"""Where the time of one port training step goes, on one NVIDIA GPU.

    python3 scripts/torch_step_profile.py [--slice longctx|moe]

Builds one of chip_smoke.py's slices with its ``build_slice`` (BaguaTrainer +
GradientAllReduceAlgorithm, random weights from a seed): ``longctx`` (the
default) the long-context TransformerLM with AdamW, ``moe`` the dropless MoE
TransformerLM of ``bench_moe_longseq`` with Adam.  Runs three warm-up steps,
times five steps on the host clock, then traces five more with
``torch.profiler``.  Prints the device time per kernel class per step (the
package's classifier, ``bagua_tpu_torch.profiling.classify_kernel``), the
ten most expensive kernels, and the device busy share of the traced window
alone: the union of its kernels' intervals over the span from the
first kernel's start to the last kernel's end, and over the window's host
wall time.  The profiler records device activity only, so the traced steps'
host time stays close to the untraced ones' (both are printed).  Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STEPS = 5


def union_us(spans) -> float:
    """Length of the union of ``(start, end)`` intervals: time the device
    ran at least one kernel."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--slice", choices=("longctx", "moe"), default="longctx")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    import bagua_tpu_torch as bt
    from bagua_tpu_torch.profiling import classify_kernel
    from chip_smoke import build_slice

    bt.init_process_group()
    _, trainer, state, batch = build_slice(args.slice)
    for _ in range(3):
        state, loss = trainer.train_step(state, batch)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    for _ in range(STEPS):
        state, loss = trainer.train_step(state, batch)
    loss.item()
    wall_ms = (time.perf_counter() - t0) * 1e3

    # device activity only: recording every host op as well nearly doubles
    # the host's time per step and with it the device's idle gaps
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            state, loss = trainer.train_step(state, batch)
        loss.item()
        traced_wall_ms = (time.perf_counter() - t0) * 1e3
    per_class = defaultdict(float)
    per_kernel = defaultdict(float)
    spans = []
    for evt in prof.events():
        # device events only; skip the ranges user annotations draw there
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)
                and "#" not in evt.name):
            us = evt.time_range.elapsed_us()
            per_kernel[evt.name] += us / 1e3
            per_class[classify_kernel(evt.name)] += us / 1e3
            spans.append((evt.time_range.start, evt.time_range.end))
    busy_ms = union_us(spans) / 1e3
    kernel_span_ms = (max(e for _, e in spans) - min(s for s, _ in spans)) / 1e3
    out = {
        "slice": args.slice,
        "card": torch.cuda.get_device_name(0),
        "steps": STEPS,
        "wall_ms_per_step": wall_ms / STEPS,
        "traced_wall_ms_per_step": traced_wall_ms / STEPS,
        "device_ms_per_step": {k: v / STEPS for k, v in
                               sorted(per_class.items(), key=lambda kv: -kv[1])},
        "device_busy_ms_per_step": busy_ms / STEPS,
        "device_busy_share_of_kernel_span": busy_ms / kernel_span_ms,
        "device_busy_share_of_traced_wall": busy_ms / traced_wall_ms,
        "top_kernels_ms_per_step": {k[:90]: v / STEPS for k, v in
                                    sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]},
    }
    print(json.dumps(out, indent=1))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
