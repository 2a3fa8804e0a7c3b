"""The port's pod simulator, unit layer: no subprocess.

Each test of ``tests/test_podsim.py`` on ``bagua_tpu_torch.podsim`` (the
shaping maths, link classification pinned to the port's communicator,
``podsim.link`` faults through the port's fault plane, the wire codecs, the
ring collectives over in-memory queue rings, the port allocator), then the
port held against the JAX package on the same seeded numpy inputs: the
frames of every codec byte for byte, ``wire_bytes`` and
``quantization_atol``, the shaping maths, ``hierarchical_allreduce`` bitwise,
and one ring whose positions alternate between the two packages.
"""

import json
import queue
import socket
import threading

import numpy as np
import pytest

from bagua_tpu.podsim import collectives as JC
from bagua_tpu.podsim import shaping as JS
from bagua_tpu_torch.faults.inject import FaultSpec, fault_scope
from bagua_tpu_torch.podsim import collectives as C
from bagua_tpu_torch.podsim.shaping import (
    LINK_DCN,
    LINK_ICI,
    SHAPE_PRESETS,
    LinkDropped,
    LinkSevered,
    LinkShaper,
    LinkSpec,
    ShapeSpec,
    classify_link,
    deterministic_jitter,
    resolve_shape,
    transfer_time_s,
)
from bagua_tpu_torch.podsim.util import reserve_port, reserve_ports

CODECS = ("f32", "minmax_uint8", "onebit_ef", "topk")

# ---- link classification --------------------------------------------------


def test_link_class_constants_match_communicator():
    """The simulator declares the link-class literals itself to stay
    torch-free; they must never drift from the port's communicator's."""
    from bagua_tpu_torch import communication as comm

    assert LINK_ICI == comm.LINK_ICI
    assert LINK_DCN == comm.LINK_DCN


def test_classify_link_contiguous_slices():
    assert classify_link(0, 3, 4) == LINK_ICI
    assert classify_link(3, 4, 4) == LINK_DCN
    assert classify_link(4, 7, 4) == LINK_ICI
    assert classify_link(0, 7, 4) == LINK_DCN
    assert classify_link(5, 5, 4) == LINK_ICI
    assert classify_link(0, 99, 0) == LINK_ICI


# ---- shaping maths --------------------------------------------------------


def test_deterministic_jitter_is_deterministic_and_uniform_range():
    u1 = deterministic_jitter(7, 3, 4, 0)
    assert u1 == deterministic_jitter(7, 3, 4, 0)
    assert 0.0 <= u1 < 1.0
    assert u1 != deterministic_jitter(8, 3, 4, 0)
    assert u1 != deterministic_jitter(7, 3, 4, 1)


def test_transfer_time_components():
    link = LinkSpec(latency_s=1e-3, bandwidth_Bps=1e6, jitter_s=2e-3)
    assert transfer_time_s(1000, link, u=0.5) == pytest.approx(1e-3 + 1000 / 1e6 + 0.5 * 2e-3)
    assert transfer_time_s(10**9, LinkSpec(latency_s=1e-3), u=0.0) == pytest.approx(1e-3)


def test_shaper_delay_asymmetry_and_stats():
    shape = resolve_shape("pod", slice_size=4, seed=0)
    slept = []
    shaper = LinkShaper(shape, 8, sleep=slept.append)
    d_ici = shaper.traverse(0, 1, 10**6, hop=0)
    d_dcn = shaper.traverse(3, 4, 10**6, hop=0)
    assert d_dcn > d_ici * 10
    assert slept == [d_ici, d_dcn]
    assert shaper.stats[LINK_ICI] == {"hops": 1, "bytes": 10**6, "slept_s": d_ici}
    assert shaper.stats[LINK_DCN]["hops"] == 1
    assert shaper.delay_s(0, 1, 10**6, hop=0) == d_ici


def test_resolve_shape_presets_json_dict_and_overrides():
    assert resolve_shape(None).name == "off"
    assert resolve_shape("").name == "off"
    assert resolve_shape("wan") is SHAPE_PRESETS["wan"]
    spec = resolve_shape("pod", slice_size=16, seed=9)
    assert (spec.slice_size, spec.seed) == (16, 9)
    assert spec.ici == SHAPE_PRESETS["pod"].ici
    from_json = resolve_shape(json.dumps({"name": "x", "slice_size": 2, "dcn": {"latency_s": 0.5}}))
    assert from_json.dcn.latency_s == 0.5 and from_json.ici.latency_s == 0.0
    assert resolve_shape({"name": "y"}).name == "y"
    passthrough = ShapeSpec(name="z")
    assert resolve_shape(passthrough) is passthrough
    with pytest.raises(ValueError, match="unknown link shape"):
        resolve_shape("no-such-preset")


# ---- fault composition ----------------------------------------------------


def test_link_drop_fault_fires_as_connection_error():
    shaper = LinkShaper(resolve_shape("off"), 8)
    with fault_scope(FaultSpec("podsim.link", kind="drop", count=1)):
        with pytest.raises(LinkDropped):
            shaper.traverse(0, 1, 100)
        shaper.traverse(0, 1, 100)
    assert issubclass(LinkDropped, ConnectionError)


def test_link_partition_severs_dcn_not_ici_until_expiry():
    clock = [100.0]
    shaper = LinkShaper(resolve_shape("off", slice_size=4), 8, sleep=lambda s: None,
                        clock=lambda: clock[0])
    with fault_scope(FaultSpec("podsim.link", kind="partition", rank=1, duration_s=5.0,
                               count=1)):
        with pytest.raises(LinkSevered):
            shaper.traverse(3, 4, 100)
    # the cut outlives the armed plan
    with pytest.raises(LinkSevered):
        shaper.traverse(7, 0, 100)
    shaper.traverse(4, 5, 100)
    shaper.traverse(0, 1, 100)
    clock[0] += 6.0
    shaper.traverse(3, 4, 100)


# ---- wire codecs ----------------------------------------------------------


def test_codec_f32_roundtrip_exact():
    x = np.linspace(-3, 3, 101, dtype=np.float32)
    idx, y = C.decode_chunk(C.encode_chunk(5, x, "f32"))
    assert idx == 5
    np.testing.assert_array_equal(x, y)


def test_codec_minmax_uint8_error_bound_and_wire_bytes():
    rng = np.random.default_rng(0)
    x = rng.uniform(-2, 2, 4096).astype(np.float32)
    _, y = C.decode_chunk(C.encode_chunk(0, x, "minmax_uint8"))
    span = float(x.max() - x.min())
    assert float(np.max(np.abs(x - y))) <= span / 255.0 * 0.5 + 1e-6
    assert C.wire_bytes(4096, "minmax_uint8") == 5 + 8 + 4096
    assert C.wire_bytes(4096, "f32") == 5 + 4 * 4096
    _, y = C.decode_chunk(C.encode_chunk(1, np.full(8, 2.5), "minmax_uint8"))
    np.testing.assert_allclose(y, 2.5, atol=1e-6)


def test_codec_onebit_sign_scale_and_wire_bytes():
    rng = np.random.default_rng(3)
    x = rng.uniform(-2, 2, 1000).astype(np.float32)
    idx, y = C.decode_chunk(C.encode_chunk(7, x, "onebit_ef"))
    assert idx == 7 and y.shape == x.shape
    np.testing.assert_allclose(y, np.sign(x) * float(np.mean(np.abs(x))), atol=1e-6)
    assert C.wire_bytes(4096, "onebit_ef") == 5 + 8 + 512
    assert len(C.encode_chunk(0, x, "onebit_ef")) == C.wire_bytes(x.size, "onebit_ef")
    x[13] = np.nan
    _, y = C.decode_chunk(C.encode_chunk(0, x, "onebit_ef"))
    assert not np.isfinite(y).any()


def test_codec_topk_sparse_roundtrip_and_wire_bytes():
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, 1000).astype(np.float32)
    x[37] = 50.0
    idx, y = C.decode_chunk(C.encode_chunk(2, x, "topk"))
    assert idx == 2 and y.shape == x.shape
    kk = max(1, int(np.ceil(x.size * 0.01)))
    sel = np.nonzero(y)[0]
    assert len(sel) == kk and 37 in sel
    np.testing.assert_array_equal(y[sel], x[sel])
    assert C.wire_bytes(1000, "topk") == 5 + 8 + 8 * kk
    assert len(C.encode_chunk(0, x, "topk")) == C.wire_bytes(x.size, "topk")
    x[5] = np.nan
    _, y = C.decode_chunk(C.encode_chunk(0, x, "topk"))
    assert not np.isfinite(y[5])


# ---- ring collectives over in-memory rings --------------------------------


class _MemRing:
    """Queue-backed stand-in for RingTransport: position p's hop pushes to
    p+1's inbox and pops its own: the same frame bytes, no sockets."""

    def __init__(self, size):
        self.size = size
        self._inboxes = [queue.Queue() for _ in range(size)]

    def hop_fn(self, pos):
        if self.size == 1:
            return lambda payload, hop_index=0: payload

        def hop(payload, hop_index=0):
            self._inboxes[(pos + 1) % self.size].put(payload)
            return self._inboxes[pos].get(timeout=30)

        return hop


def _run_world(world, fn):
    """fn(rank) on one thread per rank; the results, the first error
    re-raised."""
    results, errors = [None] * world, []

    def run(rank):
        try:
            results[rank] = fn(rank)
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append((rank, e))

    threads = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    if errors:
        raise errors[0][1]
    return results


def _vecs(seed, world, n):
    return [np.random.default_rng([seed, r]).uniform(-1, 1, n).astype(np.float32)
            for r in range(world)]


def _hier_world(vecs, intra, inter, dcn_codec, mod_of=lambda rank: C):
    """``hierarchical_allreduce`` on every rank of an in-memory two-level
    world; ``mod_of(rank)`` picks the collectives module each rank runs."""
    intra_rings = [_MemRing(intra) for _ in range(inter)]
    inter_rings = [_MemRing(inter) for _ in range(intra)]

    def run(rank):
        s, p = rank // intra, rank % intra
        return mod_of(rank).hierarchical_allreduce(
            vecs[rank], intra_rings[s].hop_fn(p), p, intra,
            inter_rings[p].hop_fn(s), s, inter, dcn_codec=dcn_codec)

    return _run_world(intra * inter, run)


def test_flat_ring_allreduce_f32_exact():
    world, n = 4, 103
    vecs = _vecs(1, world, n)
    expected = np.sum(vecs, axis=0)
    ring = _MemRing(world)

    def run(rank):
        out, hops = C.ring_allreduce(vecs[rank], rank, world, ring.hop_fn(rank), codec="f32")
        assert hops == 2 * (world - 1)
        return out

    for out in _run_world(world, run):
        np.testing.assert_allclose(out, expected, rtol=1e-6, atol=1e-5)


def test_hierarchical_allreduce_compressed_dcn_within_tolerance():
    intra, inter = 4, 2
    vecs = _vecs(2, intra * inter, 512)
    expected = np.mean(vecs, axis=0)
    atol = C.quantization_atol(2.0 * intra, 2 * (inter - 1))
    for out, hops in _hier_world(vecs, intra, inter, "minmax_uint8"):
        assert hops == {"intra_hops": 2 * (intra - 1), "inter_hops": 2 * (inter - 1),
                        "world": intra * inter}
        err = float(np.max(np.abs(out - expected)))
        # within the bound, and the compression costs something measurable
        assert 0.0 < err <= atol


@pytest.mark.parametrize("dcn_codec", ["onebit_ef", "topk"])
def test_hierarchical_allreduce_lossy_dcn_transport_integrity(dcn_codec):
    """The sign and sparse wire models through the two-level construction:
    the stateless model carries no error-feedback residual, so this asserts
    transport integrity (finite, span-bounded), not fidelity."""
    intra, inter = 4, 2
    vecs = _vecs(5, intra * inter, 512)
    expected = np.mean(vecs, axis=0)
    atol = C.quantization_atol(2.0 * intra, 2 * (inter - 1), dcn_codec)
    for out, hops in _hier_world(vecs, intra, inter, dcn_codec):
        assert hops["inter_hops"] == 2 * (inter - 1)
        assert np.isfinite(out).all()
        assert float(np.max(np.abs(out - expected))) <= atol


def test_hierarchical_allreduce_f32_everywhere_is_exact():
    vecs = _vecs(3, 4, 64)
    expected = np.mean(vecs, axis=0)
    for out, _ in _hier_world(vecs, 2, 2, "f32"):
        np.testing.assert_allclose(out, expected, rtol=1e-6, atol=1e-6)


# ---- port reservation -----------------------------------------------------


def test_reserve_port_unique_and_bindable():
    ports = reserve_ports(8)
    assert len(set(ports)) == 8
    for port in ports:
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", port))
    again = reserve_ports(8)
    assert not set(ports) & set(again)
    assert reserve_port() not in set(ports) | set(again)


# ---- the port against the JAX package -------------------------------------


def _codec_inputs(codec):
    """Seeded chunks: random, constant, tiny, empty and, where the codec
    defines what a NaN becomes (not u8 quantization), one with a NaN."""
    rng = np.random.default_rng(11)
    x = rng.uniform(-3, 3, 1000).astype(np.float32)
    out = [x, np.full(9, 2.5, np.float32), x[:3], x[:0],
           rng.standard_normal(4097).astype(np.float32)]
    if codec != "minmax_uint8":
        poisoned = x.copy()
        poisoned[7] = np.nan
        out.append(poisoned)
    return out


@pytest.mark.parametrize("codec", CODECS)
def test_frames_byte_for_byte_jax(codec):
    for i, x in enumerate(_codec_inputs(codec)):
        frame = C.encode_chunk(i, x, codec)
        assert frame == JC.encode_chunk(i, x, codec), (codec, i)
        idx, y = C.decode_chunk(frame)
        jidx, jy = JC.decode_chunk(frame)
        assert idx == jidx == i
        np.testing.assert_array_equal(y, jy)


@pytest.mark.parametrize("codec", CODECS)
def test_wire_bytes_and_atol_match_jax(codec):
    for n in (0, 1, 7, 8, 1000, 4096, 4097):
        assert C.wire_bytes(n, codec) == JC.wire_bytes(n, codec)
    for span, hops in ((2.0, 1), (8.0, 2), (0.5, 14)):
        assert C.quantization_atol(span, hops, codec) == JC.quantization_atol(span, hops, codec)


def test_shaping_maths_match_jax():
    for ids in ((0, 0, 0, 0), (7, 3, 4, 0), (1, 31, 0, 12), (2**40, 5, 6, 7)):
        assert deterministic_jitter(*ids) == JS.deterministic_jitter(*ids)
    link = LinkSpec(latency_s=2e-4, bandwidth_Bps=2.5e9, jitter_s=5e-5)
    jlink = JS.LinkSpec(latency_s=2e-4, bandwidth_Bps=2.5e9, jitter_s=5e-5)
    for nbytes, u in ((0, 0.0), (4109, 0.25), (10**6, 0.99)):
        assert transfer_time_s(nbytes, link, u) == JS.transfer_time_s(nbytes, jlink, u)
    raw = json.dumps({"name": "c", "slice_size": 4, "ici": {"bandwidth_Bps": 1e9},
                      "dcn": {"latency_s": 1e-3, "jitter_s": 2e-4}, "seed": 3})
    for name in list(SHAPE_PRESETS) + [raw]:
        assert resolve_shape(name, slice_size=8, seed=1).to_json() == \
            JS.resolve_shape(name, slice_size=8, seed=1).to_json()
    assert SHAPE_PRESETS.keys() == JS.SHAPE_PRESETS.keys()


@pytest.mark.parametrize("dcn_codec", CODECS)
def test_hierarchical_allreduce_bitwise_jax(dcn_codec):
    vecs = _vecs(21, 8, 1031)
    ours = _hier_world(vecs, 4, 2, dcn_codec)
    theirs = _hier_world(vecs, 4, 2, dcn_codec, mod_of=lambda rank: JC)
    for (out, hops), (jout, jhops) in zip(ours, theirs):
        np.testing.assert_array_equal(out, jout)
        assert hops == jhops


def test_mixed_ring_of_both_packages():
    """A ring whose even positions run the port and odd ones the JAX
    package: the same frames, so the same result as an all-port ring."""
    vecs = _vecs(31, 8, 777)
    mixed = _hier_world(vecs, 4, 2, "minmax_uint8",
                        mod_of=lambda rank: C if rank % 2 == 0 else JC)
    ours = _hier_world(vecs, 4, 2, "minmax_uint8")
    for (out, _), (want, _) in zip(mixed, ours):
        np.testing.assert_array_equal(out, want)
