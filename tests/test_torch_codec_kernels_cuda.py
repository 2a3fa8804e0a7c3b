"""The port's codec CUDA kernels (K1-K5) against their plain versions.

These need an NVIDIA card (sm_90a) and ``nvcc``; without a card they skip.
On the card, where JAX is not installed, skip the JAX conftest:
``python -m pytest --noconftest -m cuda tests/test_torch_codec_kernels_cuda.py``.
The kernels and the plain versions do the same IEEE-rounded f32 operations,
so sidecars, payload bytes and decoded values must be exactly equal (any NaN
equal to any NaN); a chunk holding a NaN or an inf has a NaN grid, where the
u8 payload is undefined, so its payload is not compared.  The sign kernels:
K4's payload exactly equal, its scale (a sum taken in another order) within
1e-6 relative; K5 on the same parts exactly equal.  The sizes: 128 KiB and
5 MiB chunks (the path's), BERT-Large's 62.5 MB embedding chunk (more than
K1's grid holds in shared memory: the part that does not fit is read again),
chunks that start off a 16-byte boundary (m = 100003, 5, 4_194_307), one
chunk and 64 of them, and a whole 10 MiB bucket and the whole embedding
bucket as one chunk (the low-precision gossip ring's).  K3 (one launch whose last block of a chunk writes
its max) also on inputs that start off a 16-byte boundary, -0.0, ±inf with
a NaN, and 1 to 65535 chunks: equal to its plain version bit for bit.  K3 and
K4 launched at once from two threads, each on its own stream (the overlap
scheduler's setting), equal to plain, with every launch counted.
"""

import pytest
import torch

from bagua_tpu_torch.ops import _build, codec as cd

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _same(a, b):
    nan = a.isnan()
    return torch.equal(nan, b.isnan()) and torch.equal(a.view(torch.int32)[~nan],
                                                       b.view(torch.int32)[~nan])


def _input(kind, n, m, dtype):
    g = torch.Generator(device="cuda").manual_seed(n * 7919 + m)
    x = torch.randn(n * m, device="cuda", generator=g)
    if kind == "constant":
        x = torch.ones_like(x)
    elif kind == "inf":
        x[m // 2] = float("inf")
    elif kind == "nan":
        x[m - 1] = float("nan")
    return x.to(dtype)


EMBED_M = 30522 * 1024 // 2   # BERT-Large's embedding bucket, one of two chunks
#: the low-precision gossip ring's chunks: a whole bucket, the embedding's
#: (30528 x 1024) and a 10 MiB one
EMBED_BUCKET = 30528 * 1024
CASES = [("normal", 2, 32768), ("normal", 2, 1310720), ("normal", 4, 100003),
         ("normal", 1, 5), ("normal", 3, 4_194_307), ("constant", 2, 4099),
         ("inf", 2, 50001), ("nan", 2, 50001), ("normal", 2, EMBED_M), ("normal", 64, 4099),
         ("normal", 1, 2621440), ("normal", 1, EMBED_BUCKET)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind,n,m", CASES)
def test_codec_kernels_match_plain(card, kind, n, m, dtype):
    x = _input(kind, n, m, dtype)
    mn, mx, p = cd.compress_chunked(x, n)
    pmn, pmx, pp = cd.compress_chunked_plain(x, n)
    finite = torch.isfinite(x.view(n, m).float()).all(dim=1)
    assert _same(mn, pmn) and _same(mx, pmx)
    assert torch.equal(p[finite], pp[finite])
    assert _same(cd.decompress_chunked(mn, mx, p), cd.decompress_chunked_plain(pmn, pmx, pp))
    assert _same(cd.absmax_chunked(x, n), cd.absmax_chunked_plain(x, n))
    if kind == "nan":
        assert mn[0].isnan() and cd.decompress_chunked(mn, mx, p)[:m].isnan().all()


SIGN_CASES = [("normal", 2, 32768), ("normal", 2, 1310720), ("normal", 3, 100003),
              ("normal", 1, 3), ("normal", 2, 4_194_307), ("zero", 2, 5000),
              ("inf", 2, 50001), ("nan", 2, 50001), ("normal", 2, EMBED_M),
              ("normal", 64, 4099), ("normal", 1, 2621440)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind,n,m", SIGN_CASES)
def test_sign_kernels_match_plain(card, kind, n, m, dtype):
    x = _input("normal" if kind == "zero" else kind, n, m, dtype)
    if kind == "zero":
        x.zero_()
    scale, p = cd.sign_compress_chunked(x, n)
    pscale, pp = cd.sign_compress_chunked_plain(x, n)
    assert torch.equal(p, pp)
    finite = torch.isfinite(pscale)
    assert torch.equal(finite, torch.isfinite(scale))
    assert torch.equal(scale.isnan(), pscale.isnan())
    torch.testing.assert_close(scale[finite], pscale[finite], rtol=1e-6, atol=0)
    assert _same(cd.sign_decompress_chunked(scale, p), cd.sign_decompress_chunked_plain(scale, p))
    if kind == "zero":
        assert (scale == 0).all() and (p == 255).all()
    if kind in ("nan", "inf"):
        assert not finite[0] and not torch.isfinite(cd.sign_decompress_chunked(scale, p)[0]).any()


def test_codec_kernels_count_launches_and_reject_bad_input(card):
    cd.reset_launch_counts()
    x = torch.randn(8, device="cuda")
    mn, mx, p = cd.compress_chunked(x, 2)
    cd.decompress_chunked(mn, mx, p)
    cd.absmax_chunked(x, 4)
    scale, sp = cd.sign_compress_chunked(x, 2)
    cd.sign_decompress_chunked(scale, sp)
    assert [k.launches for k in cd.KERNELS] == [1, 1, 1, 1, 1]
    with pytest.raises(ValueError):
        cd.sign_decompress_chunked(scale, sp[:, :100].contiguous())
    with pytest.raises(ValueError):
        cd.compress_chunked(x, 3)
    with pytest.raises(ValueError):
        cd.absmax_chunked(x.half(), 2)
    with pytest.raises(ValueError):
        cd.compress_chunked(torch.randn(4, 4, device="cuda").t(), 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,m", [(2, 32768), (2, 1310720), (2, EMBED_M), (64, 4099),
                                 (1, 2621440), (1, EMBED_BUCKET)])
def test_compress_kernels_are_one_launch(card, n, m, dtype):
    # K1, K3 and K4 each run one device kernel a call: no second pass, no
    # memset
    x = _input("normal", n, m, dtype)
    cd.compress_chunked(x, n)   # built and warm
    cd.absmax_chunked(x, n)
    cd.sign_compress_chunked(x, n)
    torch.cuda.synchronize()
    k1 = _build.kernels_of_calls(lambda: cd.compress_chunked(x, n))
    k3 = _build.kernels_of_calls(lambda: cd.absmax_chunked(x, n))
    k4 = _build.kernels_of_calls(lambda: cd.sign_compress_chunked(x, n))
    assert len(k1) == 3 and all("minmax_compress_kernel" in k for k in k1), k1
    assert len(k3) == 3 and all("absmax_kernel" in k for k in k3), k3
    assert len(k4) == 3 and all("sign_compress_kernel" in k for k in k4), k4


ABSMAX_CASES = [("negzero", 2, 1310720), ("inf_nan", 2, 1310720), ("inf_nan", 3, 100003),
                ("normal", 1, 1), ("normal", 1, 7), ("normal", 65535, 3), ("normal", 65535, 64),
                ("normal", 1000, 4097), ("normal", 1, 15630336), ("offset", 2, 100003),
                ("offset", 1, 2621441)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind,n,m", ABSMAX_CASES)
def test_absmax_kernel_matches_plain(card, kind, n, m, dtype):
    # "negzero": every element of chunk 0 is -0.0 (its max is +0.0, bits 0);
    # "inf_nan": chunk 0 holds +inf, -inf and a NaN (NaN), chunk 1 +inf and
    # -inf (inf); "offset": the input starts one element past an aligned
    # address, so every chunk has a head and a tail
    x = _input("normal", 1, n * m + 1, dtype)[1:] if kind == "offset" else \
        _input("normal", n, m, dtype)
    if kind == "negzero":
        x[:m] = -0.0
    if kind == "inf_nan":
        x[3], x[m // 2], x[m - 2] = float("inf"), float("-inf"), float("nan")
        x[m + 1], x[2 * m - 1] = float("-inf"), float("inf")
    got, want = cd.absmax_chunked(x, n), cd.absmax_chunked_plain(x, n)
    assert _same(got, want)
    if kind == "negzero":
        assert got[0].view(torch.int32).item() == 0
    if kind == "inf_nan":
        assert got[0].isnan() and got[1].item() == float("inf")
    # the tickets and words are left at zero: a second call gives the same
    assert _same(cd.absmax_chunked(x, n), want)


@pytest.mark.parametrize("n,m", [(2, 1310720), (1, 2621440), (3, 100003)])
def test_sign_scale_is_reproducible(card, n, m):
    # the chunk's last block adds the partials in index order, whichever
    # block that is: 20 calls give the same scale, bit for bit
    x = _input("normal", n, m, torch.float32)
    first, payload = cd.sign_compress_chunked(x, n)
    for _ in range(19):
        scale, p = cd.sign_compress_chunked(x, n)
        assert torch.equal(scale.view(torch.int32), first.view(torch.int32))
        assert torch.equal(p, payload)
    pscale, _ = cd.sign_compress_chunked_plain(x, n)
    torch.testing.assert_close(first, pscale, rtol=1e-6, atol=0)


def test_two_streams_alternating(card):
    # calls that alternate between two streams, each on its own inputs, give
    # the plain versions' answers: K1 keeps no state between launches, and
    # K3's and K4's wrappers order launches made on different streams (their
    # tickets live in the library's memory)
    n, m = 2, 1310720
    xs = [_input("normal", n, m + i, torch.float32) for i in range(2)]
    want = [(cd.compress_chunked_plain(x, n), cd.sign_compress_chunked_plain(x, n),
             cd.absmax_chunked_plain(x, n)) for x in xs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    got = []
    for i in range(8):
        with torch.cuda.stream(streams[i % 2]):
            got.append((i % 2, cd.compress_chunked(xs[i % 2], n),
                        cd.sign_compress_chunked(xs[i % 2], n), cd.absmax_chunked(xs[i % 2], n)))
    torch.cuda.synchronize()
    for j, (mn, mx, p), (scale, sp), am in got:
        (pmn, pmx, pp), (pscale, psp), pam = want[j]
        assert _same(mn, pmn) and _same(mx, pmx) and torch.equal(p, pp)
        assert torch.equal(sp, psp)
        torch.testing.assert_close(scale, pscale, rtol=1e-6, atol=0)
        assert _same(am, pam)


def test_two_threads_on_two_streams(card):
    # the overlap scheduler's setting: K3 and K4 launched at once from two
    # threads, each on a stream of its own (the comm worker's rings and the
    # backward's error-feedback step), with the interpreter switching threads
    # often.  Every result equals the plain version's, and no launch goes
    # uncounted.
    import sys
    import threading

    n, m, calls = 2, 1310720, 20
    xs = [_input("normal", n, m + 7 * i, torch.float32) for i in range(2)]
    want = [(cd.absmax_chunked_plain(x, n), cd.sign_compress_chunked_plain(x, n)) for x in xs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    got = [[], []]
    errors = []
    torch.cuda.synchronize()
    before = (cd.absmax_chunked.launches, cd.sign_compress_chunked.launches)

    def work(i):
        try:
            torch.cuda.set_device(xs[i].device)
            with torch.cuda.stream(streams[i]):
                for _ in range(calls):
                    got[i].append((cd.absmax_chunked(xs[i], n), cd.sign_compress_chunked(xs[i], n)))
        except Exception as e:   # raised below, on the test's thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    torch.cuda.synchronize()
    assert (cd.absmax_chunked.launches - before[0],
            cd.sign_compress_chunked.launches - before[1]) == (2 * calls, 2 * calls)
    for i in range(2):
        pam, (pscale, psp) = want[i]
        assert len(got[i]) == calls
        for am, (scale, sp) in got[i]:
            assert _same(am, pam)
            assert torch.equal(sp, psp)
            torch.testing.assert_close(scale, pscale, rtol=1e-6, atol=0)
