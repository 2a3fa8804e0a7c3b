"""Multi-node launcher: run the per-node launcher on every host over ssh.

Port of ``bagua_tpu/script/baguarun.py`` (``:33-117``), the counterpart of
the reference's ``baguarun`` (pssh to all hosts, each running the per-node
launcher with its node_rank).  Plain ``ssh`` subprocesses instead of
parallel-ssh; ``--ssh_cmd`` takes any other remote-shell template.

Example::

    bagua-tpu-torch-baguarun --host_list 10.0.0.1,10.0.0.2 --nproc_per_node 1 \
        --master_port 29400 train.py --lr 1e-3

Each host gets ``python -m bagua_tpu_torch.distributed.run --nnodes N
--node_rank i --master_addr <host0> ...``; any host failing kills the rest
(the gang semantics of the per-node launcher, lifted to node level).
"""

from __future__ import annotations

import argparse
import logging
import shlex
import signal
import subprocess
import sys
import time
from typing import List

logger = logging.getLogger("bagua_tpu_torch.baguarun")


def parse_args(argv=None):
    p = argparse.ArgumentParser("bagua-tpu-torch-baguarun")
    p.add_argument("--host_list", type=str, required=True,
                   help="comma-separated hosts; first is the coordinator")
    p.add_argument("--ssh_port", type=int, default=22)
    p.add_argument("--ssh_cmd", type=str, default="ssh -p {port} {host}",
                   help="ssh command template ({port}, {host} substituted); "
                        "override for other remote shells / test shims")
    p.add_argument("--nproc_per_node", type=int, default=1)
    p.add_argument("--master_port", type=int, default=29400)
    p.add_argument("--bagua_service_port", type=int, default=29500)
    p.add_argument("--autotune_level", type=int, default=0)
    p.add_argument("--python", type=str, default="python")
    p.add_argument("--cwd", type=str, default=None,
                   help="remote working directory (default: current)")
    p.add_argument("training_script", type=str)
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def node_command(args, node_rank: int, master_addr: str) -> str:
    nnodes = len(args.host_list.split(","))
    parts = [
        args.python, "-m", "bagua_tpu_torch.distributed.run",
        "--nnodes", str(nnodes),
        "--node_rank", str(node_rank),
        "--nproc_per_node", str(args.nproc_per_node),
        "--master_addr", master_addr,
        "--master_port", str(args.master_port),
        "--bagua_service_port", str(args.bagua_service_port),
        "--autotune_level", str(args.autotune_level),
        args.training_script, *args.training_script_args,
    ]
    cmd = " ".join(shlex.quote(x) for x in parts)
    if args.cwd:
        cmd = f"cd {shlex.quote(args.cwd)} && {cmd}"
    return cmd


def launch(args) -> int:
    hosts = [h.strip() for h in args.host_list.split(",") if h.strip()]
    if not hosts:
        raise SystemExit("empty --host_list")
    master = hosts[0]
    procs: List[subprocess.Popen] = []
    for rank, host in enumerate(hosts):
        ssh = shlex.split(
            args.ssh_cmd.format(port=args.ssh_port, host=host)
        )
        remote_cmd = node_command(args, rank, master)
        logger.info("launching node %d on %s: %s", rank, host, remote_cmd)
        procs.append(subprocess.Popen(ssh + [remote_cmd]))

    rc = 0
    try:
        while procs:
            for p in list(procs):
                code = p.poll()
                if code is None:
                    continue
                procs.remove(p)
                if code != 0 and rc == 0:
                    rc = code
                    logger.error("a node failed (exit %d); killing the rest",
                                 code)
                    for q in procs:
                        q.send_signal(signal.SIGTERM)
            if procs:
                time.sleep(0.5)
    except KeyboardInterrupt:
        for p in procs:
            p.send_signal(signal.SIGTERM)
        rc = 130
    for p in procs:
        p.wait()
    return rc


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    return launch(parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
