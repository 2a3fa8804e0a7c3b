"""The port's codec rings chunked into sub-rings, ZeRO's forced-codec and
chunked scatter/gather pair, and the byte accounting and launch order of the
overlap scheduler, against the JAX package.

Mirrors ``tests/test_compressed_ring.py`` (``:227-290``, ``:574-656``) and
``tests/test_hierarchical.py``'s launch-order case (``:412-440``):

- the compressed ring allreduce at 1 and 4 sub-rings over gloo at world 2
  and 4 (``tests/workers/torch_overlap_worker.py``): every rank decodes the
  same bytes (ranks bitwise equal); the uniform codecs within JAX's bound of
  the mean and within one quantization step of each rank block of the JAX
  ring's result (a one-ulp difference between the two can move a level),
  the 1-bit and top-k codecs finite and nonzero; the codec scatter/gather
  pair within JAX's bound of the sum;
- ZeRO's pair through ``AlgorithmContext``: a forced flat codec reaches its
  reduce-scatter and allgather (the result moves off the exact one, within
  one int8 step of JAX's), and a chunk target sizes both halves into the
  same sub-rings (exact against the fused pair and JAX's, within 1e-6);
- ``bucket_tier_bytes`` reports compressed bytes where a codec resolves, the
  tier knobs overriding the family's codec both ways, equal to JAX's on a
  2 x 4 hierarchy (but for a forced flat codec on the flat path there: the
  port's world is one process group, whose ring carries it, where JAX's
  two-axis world has no ring); ``bucket_launch_order`` on a 2 x 2 hierarchy streams the
  buckets with the most inter-node bytes first under the scheduler and keeps
  the plan's order elsewhere, as JAX's does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bagua_tpu.algorithms.base import AlgorithmContext as JContext
from bagua_tpu.bucket import BucketPlan as JPlan
from bagua_tpu.communication import BaguaCommunicator as JComm
from bagua_tpu.communication import ReduceOp as JReduceOp
from bagua_tpu.communication import collapse_trivial_axes
from bagua_tpu.parallel.mesh import build_mesh
from bagua_tpu.tensor import build_params as jbuild_params
from bagua_tpu_torch.algorithms import AlgorithmContext
from bagua_tpu_torch.bucket import BucketPlan
from bagua_tpu_torch.tensor import NamedParam

from test_torch_overlap import WORLDS, jax_rows, worker_inputs, worker_run

UNIFORM = ("minmax_uint8", "int8", "fp8_e4m3", "fp8_e5m2")
#: JAX's bound of the ring's error against the mean, in units of the largest
#: |x| a rank (``test_compressed_ring.py:246-251``)
REL = {"minmax_uint8": 2 / 255.0, "int8": 2 / 127.0, "fp8_e4m3": 0.0625, "fp8_e5m2": 0.25}


def _step(kind, block):
    """One quantization step of a rank block of the result."""
    if kind == "minmax_uint8":
        return (block.max() - block.min()) / 255.0
    return np.abs(block).max() / {"int8": 127.0, "fp8_e4m3": 8.0, "fp8_e5m2": 4.0}[kind]


def _within_a_step(got, want, kind, world):
    for g, w in zip(got, want):
        for gb, wb in zip(np.array_split(g, world), np.array_split(w, world)):
            assert np.abs(gb - wb).max() <= _step(kind, wb) * (1 + 1e-6), kind


def _ranks_agree(got):
    for g in got[1:]:
        np.testing.assert_array_equal(g.view(np.uint32), got[0].view(np.uint32))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("num_chunks", [1, 4])
@pytest.mark.parametrize("name", UNIFORM)
def test_codec_ring_chunks_match_jax(world, num_chunks, name, tmp_path_factory):
    got = worker_run(world, tmp_path_factory)[f"codec/{name}/{num_chunks}"]
    _ranks_agree(got)
    xs = worker_inputs(world)["c"]
    assert np.abs(got[0] - xs.mean(0)).max() <= world * np.abs(xs).max() * REL[name]
    want = jax_rows(world, lambda c, v: c.ring_allreduce(v, JReduceOp.AVG,
                                                         num_chunks=num_chunks, codec=name), xs)
    _within_a_step(got, want, name, world)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("num_chunks", [1, 4])
@pytest.mark.parametrize("name", ["onebit_ef", "topk"])
def test_lossy_codec_ring_chunks_ranks_identical(world, num_chunks, name, tmp_path_factory):
    got = worker_run(world, tmp_path_factory)[f"codec/{name}/{num_chunks}"]
    _ranks_agree(got)
    assert np.isfinite(got).all() and np.abs(got).max() > 0


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["minmax_uint8", "int8"])
def test_codec_scatter_gather_pair_layout(world, name, tmp_path_factory):
    got = worker_run(world, tmp_path_factory)[f"codec_pair/{name}"]
    _ranks_agree(got)
    xs = worker_inputs(world)["c"]
    assert np.abs(got[0] - xs.sum(0)).max() <= world * np.abs(xs).sum(0).max() * REL[name]


def _jax_bucket_pair(world, **kw):
    def fn(c, v):
        ctx = JContext(comm=c, internode=None, intranode=None, plan=None, world_size=world, **kw)
        chunk = ctx.bucket_reduce_scatter(v, JReduceOp.AVG)
        return jnp.concatenate([chunk, ctx.bucket_allgather(chunk)])
    return fn


@pytest.mark.parametrize("world", WORLDS)
def test_zero_pair_honors_a_forced_codec(world, tmp_path_factory):
    got = worker_run(world, tmp_path_factory)
    xs = worker_inputs(world)["c"]
    rs, ag = got["bucket/forced/rs"], got["bucket/forced/ag"]
    _ranks_agree(ag)
    # the codec rode the rings: not the exact scatter, within a step of JAX's
    exact = xs.mean(0).reshape(world, -1)
    assert not np.array_equal(rs, exact)
    want = jax_rows(world, _jax_bucket_pair(world, intra_codec="int8"), xs)
    m = 64 // world
    _within_a_step(rs, want[:, :m], "int8", 1)
    _within_a_step(ag, want[:, m:], "int8", world)
    # and the bucket allreduce through the same ring
    _ranks_agree(got["bucket/forced/allreduce"])


@pytest.mark.parametrize("world", WORLDS)
def test_zero_pair_chunked_matches_fused_and_jax(world, tmp_path_factory):
    got = worker_run(world, tmp_path_factory)
    xs = worker_inputs(world)["c"]
    np.testing.assert_allclose(got["bucket/chunked/rs"], xs.mean(0).reshape(world, -1),
                               rtol=1e-6, atol=1e-6)
    for row in got["bucket/chunked/ag"]:
        np.testing.assert_allclose(row, xs.mean(0), rtol=1e-6, atol=1e-6)
    want = jax_rows(world, _jax_bucket_pair(world, overlap=True, overlap_chunk_bytes=64), xs)
    m = 64 // world
    np.testing.assert_allclose(got["bucket/chunked/rs"], want[:, :m], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["bucket/chunked/ag"], want[:, m:], rtol=1e-6, atol=1e-6)
    for row in got["bucket/chunked/allreduce"]:
        np.testing.assert_allclose(row, xs.mean(0), rtol=1e-6, atol=1e-6)


# ---- byte accounting and launch order (host side) ------------------------------


class _Group:
    """A communicator's size alone: what the accounting reads."""

    def __init__(self, n):
        self.n = n

    def nranks(self):
        return self.n

    def rank(self):
        return 0


def _plans(sizes, alignment):
    named = [NamedParam(n, (s,), torch.float32) for n, s in sizes]
    plan = BucketPlan.from_declaration_buckets([[p.declaration()] for p in named], named,
                                               alignment=alignment)
    jnamed = jbuild_params({n: jnp.zeros((s,), jnp.float32) for n, s in sizes})
    by_name = {p.name: p for p in jnamed}
    jplan = JPlan.from_declaration_buckets([[by_name[n].declaration()] for n, _ in sizes],
                                           jnamed, alignment=alignment)
    return plan, jplan


def _contexts(inter, intra, plan, jplan, **kw):
    world = inter * intra
    port = AlgorithmContext(comm=_Group(world), plan=plan, world_size=world,
                            intranode=_Group(intra), internode=_Group(inter), **kw)
    mesh = build_mesh({"inter": inter, "intra": intra}, jax.devices()[:world])
    comm = JComm(collapse_trivial_axes(mesh, ("inter", "intra")), mesh)
    jax_ctx = JContext(comm=comm, internode=JComm("inter", mesh), intranode=JComm("intra", mesh),
                       plan=jplan, world_size=world, **kw)
    return port, jax_ctx


def test_bucket_tier_bytes_codec_aware():
    plan, jplan = _plans([("a", 1024)], 8)
    ctx = lambda **kw: _contexts(2, 4, plan, jplan, **kw)  # noqa: E731
    calls = [({}, (0, True), {}), ({}, (0, True), {"dcn_codec": "minmax_uint8"}),
             ({"inter_codec": "off"}, (0, True), {"dcn_codec": "minmax_uint8"}),
             ({"inter_codec": "fp8_e4m3"}, (0, True), {}),
             ({"intra_codec": "int8"}, (0, True), {}),
             ({}, (0, False), {"flat_codec": "minmax_uint8"}), ({}, (0, False), {}),
             ({"intra_codec": "off"}, (0, False), {"flat_codec": "minmax_uint8"})]
    results = []
    for kw, args, codecs in calls:
        port, jax_ctx = ctx(**kw)
        got = port.bucket_tier_bytes(*args, **codecs)
        assert got == jax_ctx.bucket_tier_bytes(*args, **codecs), (kw, args, codecs)
        results.append(got)
    full, comp, forced_off, forced_fp8 = results[:4]
    assert full["dcn_codec"] is None and comp["dcn_codec"] == "minmax_uint8"
    assert full["dcn_bytes"] / comp["dcn_bytes"] >= 3.0
    assert comp["ici_bytes"] == full["ici_bytes"]
    assert forced_off["dcn_bytes"] == full["dcn_bytes"]
    assert forced_fp8["dcn_codec"] == "fp8_e4m3"
    flat_comp, flat_full = results[5], results[6]
    assert flat_full["dcn_bytes"] / flat_comp["dcn_bytes"] >= 3.0
    # the flat path on two tiers under a forced flat codec: the port's world
    # is one process group, whose ring carries the codec; JAX's ring permutes
    # over one mesh axis, so its two-axis world keeps full precision there
    port, _ = ctx(intra_codec="int8")
    forced = port.bucket_tier_bytes(0, False)
    assert forced["flat_codec"] == forced["dcn_codec"] == "int8"
    assert forced["ici_bytes"] == 1024 + 4 and forced["dcn_bytes"] == 1028
    # no tiers: nothing crosses nodes; a forced flat codec is what it reports
    port = AlgorithmContext(comm=_Group(8), plan=plan, world_size=8, intra_codec="int8")
    flat = port.bucket_tier_bytes(0, True)
    assert (flat["tier"], flat["dcn_bytes"], flat["flat_codec"]) == ("flat", 0, "int8")


def test_bucket_launch_order_on_two_by_two():
    sizes = [("a", 8), ("b", 256), ("c", 64), ("d", 256), ("e", 1)]
    plan, jplan = _plans(sizes, 1)
    port, jax_ctx = _contexts(2, 2, plan, jplan, overlap=True)
    want = sorted(range(len(sizes)), key=lambda i: -plan.buckets[i].padded_numel)
    assert port.bucket_launch_order(True) == jax_ctx.bucket_launch_order(True) == want
    assert want == [1, 3, 2, 0, 4]   # stable among equal sizes
    # a codec on the inter-node tier orders by its compressed bytes
    assert (port.bucket_launch_order(True, dcn_codec="onebit_ef")
            == jax_ctx.bucket_launch_order(True, dcn_codec="onebit_ef"))
    # the plan's order elsewhere: not hierarchical, or not under the scheduler
    assert port.bucket_launch_order(False) == list(range(len(sizes)))
    serialized, _ = _contexts(2, 2, plan, jplan, overlap=False)
    assert serialized.bucket_launch_order(True) == list(range(len(sizes)))
    tiers = port.bucket_tier_bytes(want[0], True)
    assert tiers["tier"] == "two_level" and tiers["dcn_bytes"] <= tiers["bytes"] // 2
    assert port.bucket_tier_bytes(want[0], False)["dcn_bytes"] > tiers["dcn_bytes"]
    # the chunk targets by link class, as the tiers size their rings
    port, jax_ctx = _contexts(2, 2, plan, jplan, overlap=True, overlap_chunk_bytes=64,
                              inter_chunk_bytes=256)
    for link in ("ici", "dcn"):
        assert port.chunk_bytes_for(link) == jax_ctx.chunk_bytes_for(link)
    assert port._comm_chunks(port.intranode, 1024, 4, "ici") == jax_ctx._comm_chunks(
        jax_ctx.intranode, 1024, 4, "ici") == 32
