"""Cluster-level system probe: run a perf microbenchmark on every host.

Port of ``bagua_tpu/service/autotune_system.py`` (the reference's
``sysperf``: parallel-ssh to all hosts, each running a probe, collecting
per-host throughput to spot slow nodes before a training run).  Here the
probe is the port's overlap A/B (``scripts/torch_overlap_ab.py``, two ranks
on the host's card) or its step profile (``scripts/torch_step_profile.py``),
over plain ssh subprocesses (``--ssh_cmd`` shim-able, as in ``baguarun``);
a host scores the largest ``busbw_GBps`` or ``value`` its JSON lines carry.

    bagua-tpu-torch-sysperf --host_list 10.0.0.1,10.0.0.2
    -> one JSON line per host: {"host", "ok", "records" | "error"}
    exit code 1 when any host underperforms the fleet median by
    ``--straggler_pct`` or fails.
"""

from __future__ import annotations

import argparse
import json
import logging
import shlex
import statistics
import subprocess
import sys
from typing import Dict, List

logger = logging.getLogger("bagua_tpu_torch.sysperf")

PROBES = {
    "collective": "scripts/torch_overlap_ab.py --steps 3",
    "train": "scripts/torch_step_profile.py",
}


def parse_args(argv=None):
    p = argparse.ArgumentParser("bagua-tpu-torch-sysperf")
    p.add_argument("--host_list", type=str, required=True)
    p.add_argument("--ssh_port", type=int, default=22)
    p.add_argument("--ssh_cmd", type=str, default="ssh -p {port} {host}")
    p.add_argument("--probe", choices=sorted(PROBES), default="collective")
    p.add_argument("--python", type=str, default="python")
    p.add_argument("--cwd", type=str, default=None)
    p.add_argument("--timeout_s", type=float, default=1800)
    p.add_argument("--straggler_pct", type=float, default=20.0,
                   help="flag hosts slower than median by this percent")
    return p.parse_args(argv)


def probe_host(args, host: str) -> Dict:
    ssh = shlex.split(args.ssh_cmd.format(port=args.ssh_port, host=host))
    cmd = f"{args.python} {PROBES[args.probe]}"
    if args.cwd:
        cmd = f"cd {shlex.quote(args.cwd)} && {cmd}"
    try:
        out = subprocess.run(
            ssh + [cmd], capture_output=True, text=True,
            timeout=args.timeout_s,
        )
    except subprocess.TimeoutExpired:
        return {"host": host, "ok": False, "error": "timeout"}
    if out.returncode != 0:
        return {"host": host, "ok": False,
                "error": (out.stderr or out.stdout)[-500:]}
    records = []
    for line in out.stdout.splitlines():
        line = line.strip()
        if line.startswith("{"):
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                pass
    return {"host": host, "ok": bool(records), "records": records}


def _score(result: Dict) -> float:
    """One comparable throughput number per host."""
    vals = [
        r.get("busbw_GBps") or r.get("value") or 0.0
        for r in result.get("records", [])
    ]
    return float(max(vals)) if vals else 0.0


def sysperf(args) -> int:
    from concurrent.futures import ThreadPoolExecutor

    hosts = [h.strip() for h in args.host_list.split(",") if h.strip()]
    if not hosts:
        return 0
    # probe all hosts concurrently (the reference fans out with parallel-ssh;
    # serial probing would serialize per-host timeouts on a hung fleet)
    with ThreadPoolExecutor(max_workers=min(len(hosts), 64)) as pool:
        results = list(pool.map(lambda h: probe_host(args, h), hosts))
    scores = {r["host"]: _score(r) for r in results if r["ok"]}
    median = statistics.median(scores.values()) if scores else 0.0
    rc = 0
    for r in results:
        if not r["ok"]:
            r["straggler"] = True
            rc = 1
        else:
            s = scores[r["host"]]
            r["score"] = s
            r["straggler"] = (
                median > 0 and s < median * (1 - args.straggler_pct / 100.0)
            )
            if r["straggler"]:
                rc = 1
        print(json.dumps(r), flush=True)
    if rc:
        logger.error("stragglers or failures detected (median score %.2f)",
                     median)
    return rc


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    return sysperf(parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
