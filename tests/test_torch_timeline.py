"""The port's fleet timeline against the JAX package's
(``tests/test_timeline.py``).

Two ranks' span dumps are made in this process (in-process fakes of a
rank's dump, as the JAX tests make theirs): each records its spans through
a package's own tracer and ``dump_span_ring``, and the second rank's clock
is moved by an hour and a half, as another process's monotonic epoch would
be.  The port's dumps assembled by the JAX package's ``assemble_timeline``
and the JAX package's dumps by the port's both pass both packages'
``validate_timeline``; the two packages assemble the same dumps into the
same trace events and the same per-rank alignment, exactly, but for the
``generated_by`` line of the metadata.
"""

import json

import pytest

from bagua_tpu.obs import spans as jspans
from bagua_tpu.obs import timeline as jtl
from bagua_tpu_torch.obs import spans as obs_spans
from bagua_tpu_torch.obs import timeline as tl

SKEW = 5400.0


def _dump(spans_mod, tl_mod, tmp_path, rank, lag):
    """One rank's ring: three steps, a nested bucket collective, and the
    async negotiation each ends at one shared instant (the anchor)."""
    spans_mod.set_enabled(True)
    spans_mod.recorder.clear()
    try:
        for i in range(3):
            spans_mod.set_current_step(i)
            with spans_mod.trace_span("step/dispatch"):
                with spans_mod.trace_span("trace/bucket_collective", bucket=0, bytes=1024):
                    pass
            with spans_mod.trace_span("async/negotiate", launched=i, applied=i):
                pass
        path = tl_mod.dump_span_ring(str(tmp_path / f"spans_rank{rank}.json"), rank=rank)
    finally:
        spans_mod.recorder.clear()
        spans_mod.set_current_step(None)
        spans_mod.set_enabled(None)
    rec = json.load(open(path))
    for s in rec["spans"]:
        s["t0"] += lag
        s["t1"] += lag
    json.dump(rec, open(path, "w"))
    return rec


def _strip(trace):
    out = json.loads(json.dumps(trace))
    out["metadata"].pop("generated_by", None)
    return out


@pytest.mark.parametrize("maker", ["port", "jax"])
def test_dumps_assemble_in_both_packages(tmp_path, maker):
    spans_mod, tl_mod = (obs_spans, tl) if maker == "port" else (jspans, jtl)
    recs = [_dump(spans_mod, tl_mod, tmp_path, 0, 0.0),
            _dump(spans_mod, tl_mod, tmp_path, 1, SKEW)]
    port = tl.assemble_timeline(recs)
    jax_side = jtl.assemble_timeline(recs)
    for trace in (port, jax_side):
        assert tl.validate_timeline(trace) == []
        assert jtl.validate_timeline(trace) == []
    assert _strip(port) == _strip(jax_side)
    ranks = port["metadata"]["ranks"]
    assert ranks["1"]["aligned"] is True and ranks["1"]["anchor_spans"] == 3
    # the skew is taken out: rank 1's offset within the in-process spread
    assert abs(ranks["1"]["clock_offset_s"] + SKEW) < 5.0
    names = {e["name"] for e in port["traceEvents"] if e.get("ph") == "X"}
    assert {"step/dispatch", "trace/bucket_collective", "async/negotiate"} <= names


def test_cli_end_to_end(tmp_path):
    d = tmp_path / "dumps"
    d.mkdir()
    _dump(obs_spans, tl, d, 0, 0.0)
    _dump(obs_spans, tl, d, 1, SKEW)
    out = tmp_path / "timeline.json"
    assert tl.main([str(d), "--out", str(out), "--check"]) == 0
    trace = json.load(open(out))
    assert jtl.validate_timeline(trace) == []
    assert trace["metadata"]["generated_by"] == "python -m bagua_tpu_torch.obs.timeline"
    empty = tmp_path / "empty"
    empty.mkdir()
    assert tl.main([str(empty), "--out", str(out)]) == 2


def test_validate_rejects_malformed(tmp_path):
    rec = _dump(obs_spans, tl, tmp_path, 0, 0.0)
    bad = tl.assemble_timeline([rec])
    bad["traceEvents"].append({"ph": "X", "name": "no-ts", "pid": 0})
    assert tl.validate_timeline(bad) == jtl.validate_timeline(bad) != []
    with pytest.raises(ValueError):
        tl.assemble_timeline([])
