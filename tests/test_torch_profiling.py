"""The port's profiler capture and its trace parsers
(``bagua_tpu/profiling.py``, ``bagua_tpu/obs/attribution.py``).

- ``StepProfiler`` on the CPU activities, through the trainer: with
  ``BAGUA_PROFILE_DIR`` set, steps 2:5 are captured into one Chrome trace
  whose ``"bagua"`` object counts 3 steps, the bucket collectives open
  their ``bagua/bucket_collective#<i>`` ranges, and the closed window's
  device attribution lands in the obs summary as null-with-rationale (the
  CPU runs no device work).
- The parsers on a synthetic Chrome trace of Kineto's shape: the op profile
  by kernel class, the device communication work tied to its bucket
  through the launching range (gloo's staging copies and NCCL kernels),
  per-bucket attribution by transport, the overlap fraction, and the
  one kernel classifier (``scripts/torch_step_profile.py`` calls it).
"""

import functools
import json
import os
import time

import pytest
import torch

import bagua_tpu_torch as bt
from bagua_tpu_torch import profiling as prof
from bagua_tpu_torch.models.transformer import lm_loss_fn
from bagua_tpu_torch.obs import attribution
from bagua_tpu_torch.obs import export as obs_export
from bagua_tpu_torch.obs import spans as obs_spans

torch.set_num_threads(1)


def _x(cat, name, ts, dur, pid=1, tid=10, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _synthetic(steps=2):
    """Two steps: bucket 0 on the main thread (a codec kernel and two
    staging copies: gloo), bucket 1 on the comm worker's thread (an NCCL
    kernel), bucket 2 with no device work, compute kernels outside any
    range, and a readback copy outside any range (not communication)."""
    ev = []
    corr = 0
    for s in range(steps):
        base = s * 1000.0
        ev.append(_x("kernel", "fwd_wgmma_kernel<128>", base, 100, pid=0, tid=7))
        ev.append(_x("kernel", "void at::native::elementwise_kernel<128>", base + 100, 50,
                     pid=0, tid=7))
        ev.append(_x("user_annotation", "bagua/bucket_collective#0", base + 200, 100))
        for name, cat, dur in (("minmax_compress_kernel", "kernel", 4),
                               ("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 10),
                               ("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 6)):
            corr += 1
            ev.append(_x("cuda_runtime", "cudaLaunchKernel", base + 210 + corr % 7, 2, corr=corr))
            ev.append(_x(cat, name, base + 250 + corr % 7, dur, pid=0, tid=7, corr=corr))
        ev.append(_x("user_annotation", "bagua/bucket_collective#1", base + 300, 100, tid=11))
        corr += 1
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", base + 310, 2, tid=11, corr=corr))
        ev.append(_x("kernel", "ncclDevKernel_AllReduce_Sum_f32_RING_LL", base + 320, 20,
                     pid=0, tid=8, corr=corr))
        ev.append(_x("user_annotation", "bagua/bucket_collective#2", base + 400, 10))
        corr += 1
        ev.append(_x("cuda_runtime", "cudaMemcpyAsync", base + 500, 2, corr=corr))
        ev.append(_x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", base + 520, 3,
                     pid=0, tid=7, corr=corr))
    return {"traceEvents": ev, "bagua": {"steps": steps}}


LAUNCHES = [{"bucket": b, "bytes": 4096 * (b + 1), "tier": "flat", "ici_bytes": 0,
             "dcn_bytes": 0} for b in range(3)]


def test_classifier():
    assert prof.classify_kernel("fwd_wgmma_kernel<128, 3>") == "flash_fwd"
    assert prof.classify_kernel("dkv_wgmma_kernel") == "flash_bwd_dkv"
    assert prof.classify_kernel("dq_wide_kernel") == "flash_bwd_dq"
    assert prof.classify_kernel("gmm_drhs_wgmma_kernel") == "gmm_drhs"
    assert prof.classify_kernel("gmm_wgmma_kernel") == "gmm"
    assert prof.classify_kernel("sign_compress_kernel") == "codec"
    assert prof.classify_kernel("ncclDevKernel_AllReduce") == "nccl"
    assert prof.classify_kernel("nvjet_tst_128x256") == "gemm"
    assert prof.classify_kernel("multi_tensor_apply_kernel") == "optimizer"
    assert prof.classify_kernel("something_else") == "other"
    assert prof.is_comm_op("ncclDevKernel_AllGather") and not prof.is_comm_op("gemm")


def test_op_profile_of_a_synthetic_trace():
    p = prof.parse_trace_op_profile(_synthetic())
    assert p["n_steps"] == 2
    assert p["ops"]["fwd_wgmma_kernel<128>"] == {"time_s": pytest.approx(200e-6), "count": 2,
                                                 "class": "flash_fwd"}
    assert p["classes"]["codec"] == pytest.approx(8e-6)
    assert p["classes"]["gpu_memcpy"] == pytest.approx(38e-6)
    assert p["total_time_s"] == pytest.approx(2 * (100 + 50 + 4 + 10 + 6 + 20 + 3) * 1e-6)


def test_comm_events_tied_to_their_bucket():
    c = prof.parse_trace_comm_events(_synthetic())
    assert c["transport"] == "nccl" and c["n_steps"] == 2
    by = {}
    for e in c["events"]:
        by.setdefault((e["bucket"], e["kind"]), []).append(e["dur_s"])
    assert sorted(by) == [(0, "staging_copy"), (1, "nccl")]
    assert sum(by[(0, "staging_copy")]) == pytest.approx(32e-6)
    # the readback outside every range is not communication
    assert all(e["name"] != "Memcpy DtoH (Device -> Pageable)" for e in c["events"])
    assert [e["name"] for e in c["bucket_compute"]] == ["minmax_compress_kernel"] * 2
    o = prof.parse_trace_overlap(_synthetic())
    assert o["comm_s_per_step"] == pytest.approx(36e-6)
    assert 0.0 <= o["overlap_fraction"] <= 1.0


def test_attribution_per_bucket_by_transport(tmp_path):
    path = tmp_path / "t.pt.trace.json"
    json.dump(_synthetic(), open(path, "w"))
    rec = attribution.attribute_device_comm(str(tmp_path), bucket_launches=LAUNCHES)
    assert rec["available"] and rec["transport"] == "nccl"
    rows = {r["bucket"]: r for r in rec["per_bucket"]}
    assert rows[0]["transport"] == "gloo"
    assert rows[0]["device_comm_s"] == pytest.approx(16e-6)
    assert rows[0]["device_codec_s"] == pytest.approx(4e-6)
    assert rows[1]["transport"] == "nccl" and rows[1]["device_comm_s"] == pytest.approx(20e-6)
    assert rows[2]["transport"] is None and rows[2]["device_comm_s"] is None
    # the host's schedule deduped by bucket, newest launch wins
    spans = [{"name": "trace/bucket_collective", "t0": t, "attrs": {"bucket": b, "bytes": 8}}
             for t, b in ((1.0, 0), (2.0, 1), (3.0, 0))]
    assert [e["bucket"] for e in attribution.bucket_launches_from_ring(spans)] == [1, 0]


def test_attribution_null_with_rationale(tmp_path):
    trace = _synthetic()
    trace["traceEvents"] = [e for e in trace["traceEvents"]
                            if "nccl" not in e["name"] and e.get("cat") != "gpu_memcpy"]
    json.dump(trace, open(tmp_path / "t.pt.trace.json", "w"))
    rec = attribution.attribute_device_comm(str(tmp_path), bucket_launches=LAUNCHES)
    assert rec == {"available": False, "rationale": attribution.UNAVAILABLE_RATIONALE}
    assert attribution.attribute_device_comm(str(tmp_path / "none"))["available"] is False
    assert prof.trace_memory_traffic() == {"available": False,
                                           "rationale": prof.MEMORY_TRAFFIC_RATIONALE}


def test_step_profiler_through_the_trainer(tmp_path, monkeypatch):
    monkeypatch.setenv("BAGUA_PROFILE_DIR", str(tmp_path))
    monkeypatch.setenv("BAGUA_PROFILE_STEPS", "2:5")
    bt.init_process_group(device="cpu")
    obs_spans.set_enabled(True)
    obs_export.reset_local_summary()
    try:
        cfg = bt.TransformerConfig(vocab_size=61, d_model=32, n_heads=4, n_layers=1, d_ff=64,
                                   max_seq_len=16, dtype=torch.float32)
        trainer = bt.BaguaTrainer(lm_loss_fn, functools.partial(torch.optim.SGD, lr=0.1),
                                  bt.algorithms.GradientAllReduceAlgorithm(), device="cpu",
                                  bucket_bytes=4096)
        assert trainer._profiler is not None
        state = trainer.init(bt.TransformerLM(cfg, device="cpu", seed=0))
        batch = {"tokens": torch.randint(0, 61, (2, 9),
                                         generator=torch.Generator().manual_seed(0))}
        for _ in range(7):
            state, _ = trainer.train_step(state, batch)
        path = trainer._profiler.path
        assert path and os.path.dirname(path) == str(tmp_path)
        trace = prof.load_trace(path)
        assert trace["bagua"]["steps"] == 3
        ranges = [e["name"] for e in trace["traceEvents"]
                  if e.get("cat") == "user_annotation"
                  and e.get("name", "").startswith(prof.BUCKET_ANNOTATION)]
        assert len(ranges) == 3 * len(trainer.plan.buckets)
        assert prof.parse_trace_op_profile(trace) == {}   # no device events on the CPU
        rec = None
        for _ in range(300):   # the attribution thread publishes when done
            rec = obs_export.last_device_attribution()
            if rec is not None:
                break
            time.sleep(0.1)
        assert rec == {"available": False, "rationale": attribution.UNAVAILABLE_RATIONALE}
        assert obs_export.local_obs_summary()["device_comm_s_per_step"] is None
    finally:
        obs_spans.set_enabled(None)
        obs_export.reset_local_summary()


def test_trace_context_manager(tmp_path):
    with prof.trace(str(tmp_path), steps=1) as holder:
        with prof.annotate(prof.BUCKET_ANNOTATION + "0"):
            torch.ones(4).sum()
    trace = prof.load_trace(holder["path"])
    assert trace["bagua"]["steps"] == 1
    assert any(e.get("name") == prof.BUCKET_ANNOTATION + "0" for e in trace["traceEvents"])
    assert prof.annotate("x") is prof._NULL   # no capture open: no range
