"""``scripts/torch_failover_drill.py``: the port's counterpart of
``scripts/failover_drill.py``, run as a user runs it (a subprocess of its
own, through the simulator's torch-free bootstrap).

- ``partition_fence``, ``store_flake`` and ``heartbeat_loss`` at world 4:
  every check of the JAX drill true (the ex-primary exits ``EXIT_DEMOTED``
  and the lease stays with the standby; every verdict reached under the
  armed ``store.failover`` plan with the primary keeping its lease; a
  ``lease_expired`` stop naming the stopped worker, a regroup at n-1 and
  its orderly exit), and the drill process never loaded torch or the JAX
  package.
- ``--smoke``: the SIGKILL of the primary coordinator at world 4.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "torch_failover_drill.py")
CHECKS = {
    "partition_fence": {"standby_promoted", "ex_primary_demoted_exit",
                        "lease_stays_with_standby", "promoted_still_acting", "no_stop_event",
                        "workers_all_alive", "workers_exit_clean"},
    "store_flake": {"all_verdicts_under_faults", "primary_kept_leadership", "no_stop_event",
                    "workers_exit_clean"},
    "heartbeat_loss": {"stop_is_lease_expired", "stopped_node_named", "regrouped_at_n_minus_1",
                       "survivors_all_ok", "survivor_exits_clean",
                       "expired_worker_orderly_exit"},
}


def _run(args, timeout=240):
    env = {k: v for k, v in os.environ.items() if not k.startswith("BAGUA_FAULT")}
    return subprocess.run([sys.executable, SCRIPT, *args], cwd="/", env=env, timeout=timeout,
                          capture_output=True, text=True)


@pytest.mark.parametrize("scenario", sorted(CHECKS))
def test_scenario_at_world_4(tmp_path, scenario):
    out_path = tmp_path / "drill.json"
    out = _run(["--world", "4", "--only", scenario, "--out", str(out_path)])
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    record = json.loads(out_path.read_text())
    result = record["scenarios"][scenario]
    assert set(result["checks"]) == CHECKS[scenario]
    assert all(result["checks"].values()), result["checks"]
    assert record["checks"]["process/torch_free"] is True
    assert record["package"] == "bagua_tpu_torch" and record["ok"] is True
    if scenario == "partition_fence":
        assert result["ex_primary_exit"] == 5
    if scenario == "heartbeat_loss":
        assert result["stop"]["kind"] == "lease_expired" and 3 in result["stop"]["nodes"]
        assert result["regrouped_nnodes"] == 3


def test_smoke_kills_the_primary_coordinator():
    out = _run(["--smoke"])
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    verdict = json.loads(out.stdout[out.stdout.index("{"):])
    assert verdict["ok"] and verdict["torch_free"] and all(verdict["checks"].values())
    assert verdict["takeover_s"] <= 3.0
