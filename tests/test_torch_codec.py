"""The port's codec kernels' plain versions (K1-K3) and ring codecs against
the JAX package.

The same numpy inputs go through the JAX package's jnp codec
(``compression/minmax_uint8.py``), its Pallas kernels in interpret mode (as
``tests/test_compression.py`` runs them, fused and tiled) and the port's
plain versions, which the port's wrappers take for CPU tensors.  Payload
bytes and sidecars must be exactly equal: both sides do the same
IEEE-rounded f32 operations.  A chunk holding a NaN or an inf has a NaN grid,
where the u8 payload is undefined on every side: there the sidecars and the
decoded values (NaN) are compared, not the payload.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bagua_tpu.compression.pallas_codec as PC
from bagua_tpu.compression import codecs as jcodecs
from bagua_tpu.compression.minmax_uint8 import compress_chunked as j_compress
from bagua_tpu.compression.minmax_uint8 import decompress_chunked as j_decompress
from bagua_tpu_torch.compression import codecs as tcodecs
from bagua_tpu_torch.ops import codec as cd


def _same(a, b):
    """Bitwise equal, any NaN equal to any NaN."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    nan = np.isnan(a) if a.dtype.kind == "f" else np.zeros(a.shape, bool)
    return np.array_equal(nan, np.isnan(b) if b.dtype.kind == "f" else nan) and \
        np.array_equal(a[~nan].view(np.uint8), b[~nan].view(np.uint8))


def _input(kind, n, m, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n * m).astype(np.float32)
    if kind == "scaled":
        x *= np.float32(1e-4)
    elif kind == "constant":
        x[:] = -3.0
    elif kind == "inf":
        x[1] = np.inf
        x[m + 2] = -np.inf
    elif kind == "nan":
        x[m + 3] = np.nan
    return x


def _port(x, n):
    t = torch.from_numpy(x)
    mn, mx, p = cd.compress_chunked(t, n)
    return mn.numpy(), mx.numpy(), p.numpy(), cd.decompress_chunked(mn, mx, p).numpy(), \
        cd.absmax_chunked(t, n).numpy()


def _check(got, want, finite):
    mn, mx, p, y, am = got
    wmn, wmx, wp, wy, wam = want
    assert _same(mn, wmn) and _same(mx, wmx)
    assert np.array_equal(p[finite], wp[finite])
    assert _same(y, wy)
    assert _same(am, wam)


CASES = [("normal", 8, 1000), ("normal", 4, 4096), ("normal", 2, 100), ("scaled", 3, 333),
         ("normal", 2, 100003), ("normal", 4, 3), ("constant", 2, 1000), ("inf", 2, 500),
         ("nan", 2, 500)]


@pytest.mark.parametrize("kind,n,m", CASES)
def test_plain_codec_matches_jnp_and_pallas(kind, n, m):
    x = _input(kind, n, m)
    finite = np.isfinite(x.reshape(n, m)).all(1)
    got = _port(x, n)
    jx = jnp.asarray(x)
    mn, mx, p = j_compress(jx, n)
    jnp_ref = (mn, mx, p, j_decompress(mn, mx, p), jnp.abs(jx.reshape(n, -1)).max(1))
    _check(got, tuple(np.asarray(v) for v in jnp_ref), finite)
    pmn, pmx, pp = PC.compress_chunked_pallas(jx, n, True)
    pallas = (pmn, pmx, pp, PC.decompress_chunked_pallas(pmn, pmx, pp, True),
              PC.absmax_chunked_pallas(jx, n, True))
    _check(got, tuple(np.asarray(v) for v in pallas), finite)
    if kind == "nan":
        assert not finite[1] and np.isnan(got[0][1]) and np.isnan(got[3][m:]).all() \
            and np.isnan(got[4][1])


@pytest.mark.parametrize("kind", ["normal", "nan"])
def test_plain_codec_matches_pallas_tiled(kind, monkeypatch):
    """Chunks past the fused ceiling take the Pallas two-pass tiled kernels
    (ceiling and tile forced to 32 rows, as tests/test_compression.py does:
    3 tiles per chunk, the last one ragged)."""
    monkeypatch.setattr(PC, "_MAX_FUSED_ROWS", 32)
    monkeypatch.setattr(PC, "_TILE_ROWS", 32)
    jax.clear_caches()
    n, m = 2, 12000
    x = _input(kind, n, m, seed=3)
    finite = np.isfinite(x.reshape(n, m)).all(1)
    jx = jnp.asarray(x)
    pmn, pmx, pp = PC.compress_chunked_pallas(jx, n, True)
    pallas = (pmn, pmx, pp, PC.decompress_chunked_pallas(pmn, pmx, pp, True),
              PC.absmax_chunked_pallas(jx, n, True))
    jax.clear_caches()
    _check(_port(x, n), tuple(np.asarray(v) for v in pallas), finite)


def test_constant_chunk_saturates_like_jnp():
    """A constant chunk of 1.0 puts ``mx * scale`` near 2.55e9, where an f32
    ulp is 256: ``lower = upper - 256`` and the level minus ``lower`` is 256.
    The jnp codec's f32 -> u8 convert saturates it to 255; the Pallas kernel
    hops through i32 (``pallas_codec.py:98-99``) and wraps it to 0, so the
    JAX package's two implementations disagree here (0.9999999 against 1.0
    decoded).  The port follows the jnp codec, the golden."""
    n, m = 2, 1000
    x = np.ones(n * m, np.float32)
    got = _port(x, n)
    mn, mx, p = j_compress(jnp.asarray(x), n)
    assert (got[2] == 255).all() and np.array_equal(got[2], np.asarray(p))
    assert _same(got[3], np.asarray(j_decompress(mn, mx, p))) and (got[3] == 1.0).all()
    _, _, pp = PC.compress_chunked_pallas(jnp.asarray(x), n, True)
    assert (np.asarray(pp) == 0).all()


def test_wrappers_take_the_plain_version_on_the_cpu():
    cd.reset_launch_counts()
    x = torch.from_numpy(_input("normal", 2, 64))
    mn, mx, p = cd.compress_chunked(x, 2)
    cd.decompress_chunked(mn, mx, p)
    cd.absmax_chunked(x, 2)
    assert all(k.launches == 0 for k in cd.KERNELS)
    want = cd.compress_chunked_plain(x, 2)
    assert all(torch.equal(a, b) for a, b in zip((mn, mx, p), want))


def _payload_bytes(p):
    """A JAX payload as numpy, 1-byte types as their bits."""
    p = np.asarray(p)
    return p.view(np.uint8) if p.dtype.itemsize == 1 else p


@pytest.mark.parametrize("name", ["minmax_uint8", "int8", "fp8_e4m3", "fp8_e5m2"])
@pytest.mark.parametrize("kind", ["normal", "heavy", "tiny", "zero", "nonfinite"])
def test_ring_codecs_match_jax(name, kind):
    rng = np.random.default_rng(5)
    x = {"normal": rng.standard_normal((3, 1001)),
         "heavy": rng.standard_cauchy((2, 4096)),
         "tiny": rng.standard_normal((2, 500)) * 1e-30,
         "zero": np.zeros((2, 64)),
         "nonfinite": rng.standard_normal((2, 300))}[kind].astype(np.float32)
    if kind == "nonfinite":
        x[0, 3], x[1, 5] = np.nan, np.inf
    finite = np.isfinite(x).all(1)
    jparts = jcodecs.CODECS[name].encode(jnp.asarray(x))
    tparts = tcodecs.get_codec(name).encode(torch.from_numpy(x))
    assert len(jparts) == len(tparts)
    for j, t in zip(jparts[:-1], tparts[:-1]):
        assert _same(t.numpy(), np.asarray(j))
    tp = tparts[-1]
    tp = tp.view(torch.uint8) if tp.element_size() == 1 else tp
    assert np.array_equal(tp.numpy()[finite], _payload_bytes(jparts[-1])[finite])
    got = tcodecs.get_codec(name).decode(tparts).numpy()
    assert got.dtype == np.float32 and got.shape == x.shape
    assert _same(got, np.asarray(jcodecs.CODECS[name].decode(jparts)))
    assert tcodecs.get_codec(name).wire_bytes(1000) == jcodecs.CODECS[name].wire_bytes(1000)


def test_codec_registry_and_policy():
    assert sorted(tcodecs.CODECS) == sorted(jcodecs.CODECS) == [
        "fp8_e4m3", "fp8_e5m2", "int8", "minmax_uint8", "onebit_ef", "topk"]
    assert tcodecs.POLICY_VALUES == jcodecs.POLICY_VALUES
    with pytest.raises(ValueError, match="unknown ring codec"):
        tcodecs.get_codec("uint4")
    for name in ("onebit_ef", "topk"):     # the stateful codecs resolve
        assert tcodecs.get_codec(name).name == name and tcodecs.get_codec(name).error_feedback
        assert tcodecs.validate_codec_policy(name.upper(), "compress_intra") == name
    with pytest.raises(ValueError, match="compress_intra must be one of"):
        tcodecs.validate_codec_policy("onebit", "compress_intra")
    assert tcodecs.validate_codec_policy(None, "k") == "auto"
    assert tcodecs.validate_codec_policy(" INT8 ", "k") == "int8"
    with pytest.raises(ValueError, match="compress_inter must be one of"):
        tcodecs.validate_codec_policy("gzip", "compress_inter")
    assert tcodecs.resolve_codec(None) is None
    assert tcodecs.resolve_codec("int8") is tcodecs.resolve_codec(tcodecs.CODECS["int8"])
