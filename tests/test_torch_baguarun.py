"""The port's multi-node launcher (``bagua_tpu_torch/script/baguarun.py``)
against the JAX package's.

Mirrors ``tests/test_baguarun.py``: each host's launch line names the port's
per-node launcher with its rendezvous flags, a local ``bash -c`` shim stands
in for ssh, one failing node fails the launch, and the module runs as a
console entry.  The launch line equals the JAX package's with the module
name changed.
"""

import subprocess
import sys

import pytest

from bagua_tpu.script import baguarun as jbaguarun
from bagua_tpu_torch.script.baguarun import launch, node_command, parse_args

ARGV = ["--host_list", "10.0.0.1,10.0.0.2", "--nproc_per_node", "4",
        "--master_port", "12345", "train.py", "--lr", "0.1"]


def test_node_command_contains_rendezvous():
    cmd = node_command(parse_args(ARGV), 1, "10.0.0.1")
    assert "-m bagua_tpu_torch.distributed.run" in cmd
    assert "--nnodes 2" in cmd
    assert "--node_rank 1" in cmd
    assert "--master_addr 10.0.0.1" in cmd
    assert "--master_port 12345" in cmd
    assert cmd.endswith("train.py --lr 0.1")


@pytest.mark.parametrize("extra", [[], ["--cwd", "/srv/job dir"], ["--python", "python3.12"],
                                   ["--autotune_level", "1", "--bagua_service_port", "9"]])
@pytest.mark.parametrize("node", [0, 1])
def test_node_command_equals_jax(extra, node):
    args, jargs = parse_args(extra + ARGV), jbaguarun.parse_args(extra + ARGV)
    assert vars(args) == vars(jargs)
    mine = node_command(args, node, "10.0.0.1")
    theirs = jbaguarun.node_command(jargs, node, "10.0.0.1")
    assert mine == theirs.replace("bagua_tpu.distributed.run",
                                  "bagua_tpu_torch.distributed.run")


def test_launch_all_nodes_via_shim(capfd):
    args = parse_args(["--host_list", "hostA,hostB", "--ssh_cmd", "bash -c",
                       "--python", "echo", "train.py"])
    rc = launch(args)
    out, _ = capfd.readouterr()
    assert rc == 0
    assert "--node_rank 0" in out
    assert "--node_rank 1" in out
    assert out.count("-m bagua_tpu_torch.distributed.run") == 2


def test_launch_failure_kills_gang():
    args = parse_args(["--host_list", "hostA", "--ssh_cmd", "bash -c", "--python", "false",
                       "train.py"])
    assert launch(args) != 0


def test_console_entry_exists():
    out = subprocess.run([sys.executable, "-m", "bagua_tpu_torch.script.baguarun", "--help"],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0
    assert "--host_list" in out.stdout
