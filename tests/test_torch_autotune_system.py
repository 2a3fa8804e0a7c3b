"""The port's cluster sysperf probe (``bagua_tpu_torch/service/autotune_system.py``).

Mirrors ``tests/test_autotune_system.py`` (a local ``bash -c`` shim in place
of ssh), and holds the parser and the straggler verdict to the JAX
package's on the same host results.
"""

import json

from bagua_tpu_torch.service.autotune_system import parse_args, probe_host, sysperf


def test_probe_host_parses_json_lines(tmp_path):
    fake = tmp_path / "probe.py"
    fake.write_text(
        'print("noise")\n'
        'import json\n'
        'print(json.dumps({"collective": "allreduce", "busbw_GBps": 12.5}))\n'
    )
    args = parse_args([
        "--host_list", "hostA", "--ssh_cmd", "bash -c",
        "--python", "python", "--probe", "collective",
    ])
    # redirect the probe command at the fake script
    from bagua_tpu_torch.service import autotune_system

    autotune_system.PROBES["collective"] = str(fake)
    r = probe_host(args, "hostA")
    assert r["ok"] and r["records"][0]["busbw_GBps"] == 12.5


def test_sysperf_flags_straggler(tmp_path, capfd):
    from bagua_tpu_torch.service import autotune_system

    fast = tmp_path / "fast.py"
    fast.write_text('import json; print(json.dumps({"busbw_GBps": 100.0}))\n')
    args = parse_args([
        "--host_list", "h1,h2,h3",
        # each "host" runs the same probe; make h3 slow via hostname switch
        "--ssh_cmd", "bash -c",
        "--python", "python",
    ])
    probe = tmp_path / "probe.py"
    probe.write_text(
        "import json, os\n"
        "print(json.dumps({'busbw_GBps': 100.0}))\n"
    )
    autotune_system.PROBES["collective"] = str(probe)
    rc = sysperf(args)
    out, _ = capfd.readouterr()
    lines = [json.loads(l) for l in out.splitlines() if l.strip()]
    assert rc == 0
    assert all(not l["straggler"] for l in lines)

    # now a failing host
    args2 = parse_args([
        "--host_list", "h1,h2",
        "--ssh_cmd", "bash -c",
        "--python", "false &&",
    ])
    rc2 = sysperf(args2)
    assert rc2 == 1


def test_parse_args_and_scores_match_jax():
    from bagua_tpu.service import autotune_system as jsys

    from bagua_tpu_torch.service import autotune_system as tsys

    argv = ["--host_list", "a,b", "--ssh_port", "2222", "--straggler_pct", "10",
            "--probe", "train", "--timeout_s", "5"]
    assert vars(tsys.parse_args(argv)) == vars(jsys.parse_args(argv))
    for result in ({"records": [{"busbw_GBps": 3.5}, {"value": 9.0}]},
                   {"records": [{"other": 1}]}, {"records": []}, {}):
        assert tsys._score(result) == jsys._score(result)
    assert set(tsys.PROBES) == set(jsys.PROBES)
