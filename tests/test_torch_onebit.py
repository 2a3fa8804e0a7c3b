"""The port's 1-bit and top-k codecs and the error-feedback residual against
the JAX package.

Codec: the same numpy inputs go through the plain versions of K4/K5 (which
the port's wrappers take for CPU tensors), the JAX package's jnp codec
(``OneBitEfCodec`` below its Pallas gate) and its Pallas kernels in
interpret mode.  Payload bytes must be exactly equal; the scale, a sum taken
in another order, within 1e-6 relative; the decode of the same parts exactly
equal.  Top-k: the decoded chunk exactly equal (``torch.topk`` does not
promise JAX's order among ties, so values are compared, not indices).

Residual: ``compensate_flats`` on the same flats and residual gives JAX's
out-flats exactly and its new residual within 1e-6 of the chunk's scale.
Trainer: two gloo ranks (``tests/workers/torch_trainer_worker.py``) train the
golden task with ``compress_intra="onebit_ef"`` (and ``"topk"`` at ratio 0.1)
from the JAX params in flax's layout, against the JAX trainer on a
``dp=2`` mesh.  Losses and the residual's L1 norm must agree within
``EF_RTOL`` relative at every step (XLA and torch sum the gradients in other
orders; the gaps measured on this task are about 1e-7).  The control run with
the residual dropped (``BAGUA_EF_RESIDUAL=off``) must miss the JAX EF
trajectory by more than ``EF_RTOL``, so a port that drops or misfolds the
residual fails the limit.
"""

import functools
import logging
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bench
import bagua_tpu_torch as bt
import bagua_tpu.compression.pallas_codec as PC
from bagua_tpu.algorithms.base import AlgorithmContext as JContext
from bagua_tpu.algorithms.gradient_allreduce import (
    GradientAllReduceAlgorithm as JGradientAllReduce,
)
from bagua_tpu.communication import BaguaCommunicator as JComm
from bagua_tpu.compression import codecs as jcodecs
from bagua_tpu.core.backend import BaguaTrainer as JTrainer
from bagua_tpu.parallel.mesh import build_mesh
from bagua_tpu_torch.algorithms import base as tbase
from bagua_tpu_torch.bucket import BucketPlan
from bagua_tpu_torch.compression import codecs as tcodecs
from bagua_tpu_torch.ops import codec as cd
from bagua_tpu_torch.tensor import NamedParam

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "workers" / "torch_trainer_worker.py"
STEPS = 20
#: largest relative gap of the 1-bit and top-k trajectories from JAX's
EF_RTOL = 1e-5
ALGOS = ("onebit", "topk", "onebit_off")
_RUNS = {}


@pytest.fixture(scope="module", autouse=True)
def process_group():
    bt.init_process_group(device="cpu")


# ---------------------------------------------------------------------------
# K4/K5 plain versions against the jnp codec and the Pallas kernels
# ---------------------------------------------------------------------------


def _input(kind, k, m, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(k * m).astype(np.float32)
    if kind == "zero":
        x[:] = 0.0
    elif kind == "nan":
        x[m + 3] = np.nan
    elif kind == "inf":
        x[1], x[m + 2] = np.inf, -np.inf
    elif kind == "signed_zero":
        x[::3] = -0.0
    return x


def _same(a, b):
    """Bitwise equal, any NaN equal to any NaN."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    nan = np.isnan(a)
    return np.array_equal(nan, np.isnan(b)) and np.array_equal(a[~nan].view(np.int32),
                                                               b[~nan].view(np.int32))


def _check_scale(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    ok = np.isfinite(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-6, atol=0)


SIGN_CASES = [("normal", 2, 1000), ("normal", 2, 4096), ("normal", 3, 100003),
              ("normal", 1, 3), ("normal", 4, 1025), ("zero", 2, 700), ("nan", 2, 500),
              ("inf", 2, 500), ("signed_zero", 2, 999)]


@pytest.mark.parametrize("kind,k,m", SIGN_CASES)
def test_sign_plain_matches_jnp_and_pallas(kind, k, m):
    x = _input(kind, k, m)
    scale, payload = cd.sign_compress_chunked(torch.from_numpy(x), k)
    assert payload.shape == (k, -(-m // 1024) * 128) and payload.dtype == torch.uint8
    jx = jnp.asarray(x)
    js, jp = jcodecs.CODECS["onebit_ef"].encode(jx.reshape(k, m))   # the jnp path
    ps, pp = PC.sign_compress_chunked_pallas(jx, k, True)
    for ws, wp in ((js, jp), (ps, pp)):
        assert np.array_equal(payload.numpy(), np.asarray(wp))
        _check_scale(scale.numpy(), ws)
    # the decode of the same parts: K5's plain version, the Pallas kernel,
    # and the codecs (sliced to m) exactly equal
    out = cd.sign_decompress_chunked(scale, payload).numpy()
    assert _same(out, PC.sign_decompress_chunked_pallas(jnp.asarray(scale.numpy()),
                                                        jnp.asarray(payload.numpy()), True))
    got = tcodecs.get_codec("onebit_ef").decode((scale, payload), m).numpy()
    want = jcodecs.CODECS["onebit_ef"].decode((jnp.asarray(scale.numpy()),
                                               jnp.asarray(payload.numpy())), m)
    assert got.shape == (k, m) and _same(got, want)
    if kind == "zero":
        assert (payload.numpy() == 255).all() and (got == 0).all()
    if kind in ("nan", "inf"):
        bad = 1 if kind == "nan" else 0
        assert not np.isfinite(scale.numpy()[bad]) and not np.isfinite(got[bad]).any()


def test_sign_plain_takes_bf16_as_jax_does():
    x = torch.from_numpy(_input("normal", 2, 3000)).bfloat16()
    scale, payload = cd.sign_compress_chunked(x, 2)
    js, jp = jcodecs.CODECS["onebit_ef"].encode(
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16).reshape(2, 3000))
    assert np.array_equal(payload.numpy(), np.asarray(jp))
    _check_scale(scale.numpy(), js)


def test_sign_pad_bits_are_one_and_nan_bits_zero():
    x = np.full(5, -1.0, np.float32)
    x[2] = np.nan
    scale, payload = cd.sign_compress_chunked(torch.from_numpy(x), 1)
    p = payload.numpy()[0]
    # elements 0..4 are bit 0 of bytes 0..4: all zero (negative, NaN); every
    # other bit is a zero pad element's, which packs as 1
    assert (p[:5] == 0b11111110).all() and (p[5:] == 255).all()
    assert np.isnan(scale.item())


def test_sign_wrappers_take_the_plain_version_on_the_cpu():
    cd.reset_launch_counts()
    x = torch.from_numpy(_input("normal", 2, 64))
    scale, payload = cd.sign_compress_chunked(x, 2)
    cd.sign_decompress_chunked(scale, payload)
    assert all(k.launches == 0 for k in cd.KERNELS)


@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("m", [3, 1024, 32768, 262144, 655360, 1310720, 2621440, 15627264])
def test_sign_compress_tiling(m, itemsize):
    # K4's grid as its wrapper sizes it: tiles of whole passes of a block (a
    # thread makes 16 / itemsize neighbouring bytes a pass) covering the
    # chunk's B bytes, at least MIN_SIGN_TILE bytes and at most MAX_TILES
    nbytes = cd.sign_payload_bytes(m)
    tile, tiles = cd._sign_compress_tiling(nbytes, itemsize)
    assert tile % (cd.SIGN_THREADS * 16 // itemsize) == 0
    assert (tiles - 1) * tile < nbytes <= tiles * tile
    assert tile >= cd.MIN_SIGN_TILE and tiles <= cd.MAX_TILES


def test_onebit_codec_contract():
    codec = tcodecs.get_codec("onebit_ef")
    assert codec.error_feedback and not codec.env_tuned
    j = jcodecs.CODECS["onebit_ef"]
    for m in (1, 1000, 1024, 1025, 100003):
        assert codec.wire_bytes(m) == j.wire_bytes(m)


# ---------------------------------------------------------------------------
# top-k
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ratio,k,m", [(0.01, 2, 1000), (0.1, 3, 777), (1.0, 2, 50),
                                       (0.001, 2, 10)])
def test_topk_matches_jax(ratio, k, m, monkeypatch):
    monkeypatch.setenv("BAGUA_TOPK_RATIO", str(ratio))
    x = np.random.default_rng(7).standard_normal((k, m)).astype(np.float32)
    x[0, 5] = np.nan
    x[-1, 9] = -np.inf
    t, j = tcodecs.get_codec("topk"), jcodecs.get_codec("topk")
    assert t.ratio == j.ratio == ratio
    assert all(t.k_for(n) == j.k_for(n) for n in (1, 7, m, 10 ** 6))
    assert t.wire_bytes(m) == j.wire_bytes(m)
    idx, vals = t.encode(torch.from_numpy(x))
    assert idx.dtype == torch.int32 and vals.dtype == torch.float32
    assert idx.shape == vals.shape == (k, t.k_for(m))
    got = t.decode((idx, vals), m).numpy()
    want = np.asarray(j.decode(j.encode(jnp.asarray(x)), m))
    assert _same(got, want)
    # a non-finite element is always kept
    assert np.isnan(got[0, 5]) and got[-1, 9] == -np.inf
    with pytest.raises(ValueError, match="needs the chunk element count"):
        t.decode((idx, vals))


def test_topk_ratio_env_knob_resolves_per_lookup(monkeypatch):
    monkeypatch.delenv("BAGUA_TOPK_RATIO", raising=False)
    assert tcodecs.get_codec("topk").ratio == 0.01
    monkeypatch.setenv("BAGUA_TOPK_RATIO", "0.25")     # set after import
    assert tcodecs.get_codec("topk").ratio == 0.25
    assert tcodecs.get_codec("topk") is not tcodecs.get_codec("topk")
    monkeypatch.setenv("BAGUA_TOPK_RATIO", "2")
    with pytest.raises(ValueError, match="topk ratio"):
        tcodecs.get_codec("topk")
    monkeypatch.setenv("BAGUA_TOPK_RATIO", "lots")
    with pytest.raises(ValueError, match="must be a number"):
        tcodecs.get_codec("topk")


def test_env_readers(monkeypatch):
    from bagua_tpu_torch import env

    assert not env.is_ef_residual_disabled()
    monkeypatch.setenv("BAGUA_EF_RESIDUAL", " OFF ")
    assert env.is_ef_residual_disabled()
    monkeypatch.setenv("BAGUA_EF_RESIDUAL", "maybe")
    with pytest.raises(ValueError, match="on|off"):
        env.is_ef_residual_disabled()
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert env.get_local_world_size() is None
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert env.get_local_world_size() == 4


# ---------------------------------------------------------------------------
# the error-feedback residual
# ---------------------------------------------------------------------------


class _TwoRanks:
    """A stand-in communicator of two ranks: ``ef_codec`` asks only its
    size."""

    def nranks(self):
        return 2


def _port_ctx(codec, plan, ef_enabled=True):
    return tbase.AlgorithmContext(comm=_TwoRanks(), plan=plan, world_size=2,
                                  intra_codec=codec, ef_enabled=ef_enabled)


def _jax_ctx(codec):
    mesh = build_mesh({"dp": 2}, jax.devices()[:2])
    return JContext(comm=JComm("dp", mesh), internode=None, intranode=None, plan=None,
                    world_size=2, intra_codec=codec, ef_enabled=True)


@pytest.mark.parametrize("codec", ["onebit_ef", "topk"])
def test_compensate_flats_matches_jax(codec):
    rng = np.random.default_rng(11)
    flats = [rng.standard_normal(n).astype(np.float32) for n in (3001, 64)]
    res = [(rng.standard_normal(f.size) * 0.1).astype(np.float32) for f in flats]
    params = [NamedParam("a", (3001,), torch.float32), NamedParam("b", (64,), torch.float32)]
    plan = BucketPlan.build(params, 1)    # one bucket each
    algo = bt.GradientAllReduceAlgorithm()
    state = algo.init_state(_port_ctx(codec, plan), None)
    assert [tuple(r.shape) for r in state["ef"]["buckets"]] == [(3001,), (64,)]
    assert all(float(r.abs().sum()) == 0.0 for r in state["ef"]["buckets"])
    state = {"ef": {"buckets": tuple(torch.from_numpy(r) for r in res)}}
    out, new = algo.compensate_flats(_port_ctx(codec, plan),
                                     [torch.from_numpy(f) for f in flats], state)
    jout, jnew = JGradientAllReduce().compensate_flats(
        _jax_ctx(codec), [jnp.asarray(f) for f in flats],
        {"ef": {"buckets": tuple(jnp.asarray(r)[None] for r in res)}})
    for o, jo, r, jr in zip(out, jout, new["ef"]["buckets"], jnew["ef"]["buckets"]):
        assert _same(o.numpy(), jo)                   # c = g + r, the same f32 add
        scale = np.abs(o.numpy()).mean()             # the 1-bit codec's scale of c
        np.testing.assert_allclose(r.numpy(), np.asarray(jr)[0], rtol=0, atol=1e-6 * scale)
    # the identity when no EF codec rides the wire
    flat = [torch.ones(3001), torch.ones(64)]
    assert algo.compensate_flats(_port_ctx("int8", plan), flat, state) == (flat, state)


def test_residual_off_rides_stateless_and_warns_once(monkeypatch, caplog):
    params = [NamedParam("a", (10,), torch.float32)]
    plan = BucketPlan.build(params, 1 << 20)
    tbase._EF_STATELESS_WARNED.clear()
    algo = bt.GradientAllReduceAlgorithm()
    ctx = _port_ctx("onebit_ef", plan, ef_enabled=False)
    with caplog.at_level(logging.WARNING, logger=tbase.__name__):
        assert algo.init_state(ctx, None) is None
        assert algo.ef_codec(ctx) is None and algo.ef_codec(ctx) is None
    warned = [r for r in caplog.records if "error-feedback codec" in r.getMessage()]
    assert len(warned) == 1 and "residual_disabled" in warned[0].getMessage()
    # a family without EF state rides it stateless too
    qadam = bt.QAdamAlgorithm(hierarchical=False)
    assert qadam.ef_codec(_port_ctx("onebit_ef", plan)) is None
    # the trainer reads BAGUA_EF_RESIDUAL
    monkeypatch.setenv("BAGUA_EF_RESIDUAL", "off")
    trainer = bt.BaguaTrainer(lambda m, b: None, None, algo, device="cpu",
                              compress_intra="onebit_ef")
    assert not trainer._ef_enabled and not trainer._ef_active()


# ---------------------------------------------------------------------------
# two gloo ranks against the JAX trainer on a dp=2 mesh
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _golden():
    return bench.golden_task()


def _run(tmp_path_factory):
    if "train" not in _RUNS:
        _, params, batch = _golden()
        tmp = tmp_path_factory.mktemp("onebit")
        np.savez(tmp / "data.npz", x=np.asarray(batch["x"]), y=np.asarray(batch["y"]))
        np.savez(tmp / "params.npz", **{f"{layer}.{k}": np.asarray(v)
                                        for layer, leaves in params.items()
                                        for k, v in leaves.items()})
        env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": os.pathsep.join(
            [str(REPO), os.environ.get("PYTHONPATH", "")])}
        outs = [tmp / f"out{r}.npz" for r in range(2)]
        procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), "2",
                                   f"file://{tmp / 'store'}", str(tmp / "data.npz"),
                                   str(outs[r]), str(STEPS), ",".join(ALGOS),
                                   str(tmp / "params.npz")], env=env)
                 for r in range(2)]
        try:
            assert [p.wait(timeout=300) for p in procs] == [0, 0]
        finally:
            for p in procs:
                p.kill()
        _RUNS["train"] = [np.load(o) for o in outs]
    return _RUNS["train"]


def _jax_run(codec, monkeypatch):
    if ("jax", codec) in _RUNS:
        return _RUNS[("jax", codec)]
    loss_fn, params, batch = _golden()
    if codec == "topk":
        monkeypatch.setenv("BAGUA_TOPK_RATIO", "0.1")
    trainer = JTrainer(loss_fn, optax.sgd(0.1), JGradientAllReduce(), autotune=False,
                       mesh=build_mesh({"dp": 2}, jax.devices()[:2]), compress_intra=codec)
    state = trainer.init(params)
    losses = []
    for _ in range(STEPS):
        state, loss = trainer.train_step(state, batch)
        losses.append(float(loss))
    ef = state.algo_state["ef"]["buckets"]
    _RUNS[("jax", codec)] = np.array(losses), sum(float(jnp.abs(b).sum()) for b in ef)
    return _RUNS[("jax", codec)]


@pytest.mark.parametrize("algo,codec", [("onebit", "onebit_ef"), ("topk", "topk")])
def test_ef_trajectory_tracks_the_jax_trainer(algo, codec, tmp_path_factory, monkeypatch):
    outs = _run(tmp_path_factory)
    got = outs[0][f"{algo}/losses"]
    np.testing.assert_array_equal(outs[1][f"{algo}/losses"], got)
    for name in ("dense_0.kernel", "dense_1.bias"):   # parameters agree across ranks
        np.testing.assert_array_equal(outs[1][f"{algo}/{name}"], outs[0][f"{algo}/{name}"])
    norm = sum(float(o[f"{algo}/ef_norm"]) for o in outs)
    assert all(bool(o[f"{algo}/ef_finite"]) for o in outs) and norm > 0
    want, want_norm = _jax_run(codec, monkeypatch)
    gap = np.abs(got - want) / np.abs(want)
    print(f"{codec}: largest relative loss gap {gap.max():.3g} (step {gap.argmax()}), "
          f"residual L1 {norm:.6g} vs JAX {want_norm:.6g} "
          f"({abs(norm - want_norm) / want_norm:.3g} relative)")   # shown by pytest -s
    assert gap.max() <= EF_RTOL, f"largest relative loss gap {gap.max():.3g} at step {gap.argmax()}"
    assert abs(norm - want_norm) <= EF_RTOL * want_norm, (norm, want_norm)
    assert got[-1] < got[0]


def test_residual_off_keeps_algo_state_none(tmp_path_factory, monkeypatch):
    outs = _run(tmp_path_factory)
    assert all(float(o["onebit_off/ef_norm"]) == -1.0 for o in outs)
    losses = outs[0]["onebit_off/losses"]
    assert np.isfinite(losses).all()
    np.testing.assert_array_equal(outs[1]["onebit_off/losses"], losses)
    # without its residual the run leaves JAX's EF trajectory by more than
    # the limit the EF runs are held to
    want, _ = _jax_run("onebit_ef", monkeypatch)
    gap = np.abs(losses - want) / np.abs(want)
    print(f"onebit_ef without the residual: largest relative loss gap {gap.max():.3g}")
    assert gap.max() > EF_RTOL, gap.max()
