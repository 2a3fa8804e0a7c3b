"""The port's chaos drill, the drills that run in ranks of their own
(``scripts/torch_chaos_drill.py``'s ``RANKS_2`` and ``RANKS_4``), on the CPU
over gloo: the goldens under the guard, the straggler (sync against async,
the detector on both sides of the fault, the fleet snapshot and timeline
over the ranks), the async partition's catch-up and the autopilot's victim
retune hint at two ranks; the autopilot's ``compress_dcn`` hint on the
``{inter: 2, intra: 2}`` mesh at four, its inter-node wire bytes down 3x or
more.  Every drill injected, detected and recovered, with its flight record
and its badput class.  (The drills of one process and the comparison with
the JAX drill: ``test_torch_chaos_drill.py``.)
"""

from test_torch_chaos_drill import _load_drill, check_record, run_drill


def test_rank_drills_on_the_cpu(tmp_path):
    drill = _load_drill()
    names = drill.RANKS_2 + drill.RANKS_4
    proc, record = run_drill(tmp_path, names)
    check_record(proc, record, names, world=4)
    faults = record["faults"]
    assert {faults[n]["world"] for n in drill.RANKS_2} == {2}
    codec = faults["autopilot_compress_actuates_codec"]
    assert codec["world"] == 4 and codec["dcn_reduction_ratio"] >= 3.0
    straggler = faults["straggler_throughput_degrades"]
    assert straggler["timeline"]["aligned"] and straggler["timeline"]["ranks"] == ["0", "1"]
    assert straggler["anomaly"]["fleet_names_straggler_rank"] == [1]
    assert len(faults["grad_guard_on_goldens_unchanged"]["goldens"]) == 7
