"""The port's grouped-matmul CUDA kernels (K7) against their plain versions.

These need an NVIDIA card (sm_90a) and ``nvcc``; without a card they skip.
On the card, where JAX is not installed, skip the JAX conftest:
``python -m pytest --noconftest -m cuda tests/test_torch_gmm_kernels_cuda.py``.
Tolerances (max-abs error over the plain version's max-abs): the bf16
product 1e-2 (kernel and plain version both sum in f32 and round once to
bf16, so they differ by at most one bf16 ulp, 2^-8 of an element); the f16
product 2e-3 (the same in f16, 2^-11); the f32 d_rhs, and every product of
f32 operands, 1e-4 (another summation order).
"""

import pytest
import torch

from bagua_tpu_torch.ops import gmm as gm

pytestmark = pytest.mark.cuda
TOL_BF16, TOL_F16, TOL_F32 = 1e-2, 2e-3, 1e-4
TOL = {torch.bfloat16: TOL_BF16, torch.float16: TOL_F16, torch.float32: TOL_F32}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _rel(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def _case(rows, d, f, n_groups, seed, dtype=torch.bfloat16):
    g = torch.Generator(device="cuda").manual_seed(seed)
    lhs = torch.randn(rows, d, device="cuda", generator=g).to(dtype)
    rhs = torch.randn(n_groups, d, f, device="cuda", generator=g).to(dtype)
    gout = torch.randn(rows, f, device="cuda", generator=g).to(dtype)
    return lhs, rhs, gout


SIZES = {
    "balanced": [64, 64, 64, 64],
    "skewed": [5, 200, 3, 48],        # one group holds 78% of the rows
    "empty": [0, 130, 0, 126],        # empty groups at both ends and between
    "ragged": [1, 127, 129, 0],       # smaller and larger than one tile
    "short": [50, 0, 60, 20],         # 130 of 256 rows grouped; the rest zero
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
@pytest.mark.parametrize("d,f", [(128, 256), (256, 128), (64, 200), (200, 64), (520, 8)])
@pytest.mark.parametrize("kind", sorted(SIZES))
def test_kernels_match_plain(card, kind, d, f, dtype):
    # (64, 200), (200, 64) and (520, 8): widths that end inside a tile
    rows = 256
    lhs, rhs, gout = _case(rows, d, f, 4, seed=d + len(kind), dtype=dtype)
    sizes = torch.tensor(SIZES[kind], dtype=torch.int32, device="cuda")
    counts = [k.launches for k in gm.KERNELS]
    out = gm.grouped_matmul(lhs, rhs, sizes)
    d_lhs = gm.grouped_matmul(gout, rhs, sizes, transpose_rhs=True)
    d_rhs = gm.grouped_matmul_drhs(lhs, gout, sizes, 4)
    torch.cuda.synchronize()
    assert [k.launches for k in gm.KERNELS] == [counts[0] + 2, counts[1] + 1]
    want = gm.grouped_matmul_plain(lhs, rhs, sizes)
    want_dl = gm.grouped_matmul_plain(gout, rhs, sizes, transpose_rhs=True)
    want_dr = gm.grouped_matmul_drhs_plain(lhs, gout, sizes, 4)
    tol_out = TOL[dtype]
    for got, ref, tol in ((out, want, tol_out), (d_lhs, want_dl, tol_out),
                          (d_rhs, want_dr, TOL_F32)):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert _rel(got, ref) <= tol
    grouped = int(sum(SIZES[kind]))
    assert torch.all(out[grouped:] == 0) and torch.all(d_lhs[grouped:] == 0)
    for gi, n in enumerate(SIZES[kind]):
        if n == 0:
            assert torch.all(d_rhs[gi] == 0)


def test_gmm_autograd_uses_both_kernels(card):
    lhs, rhs, gout = _case(300, 128, 256, 3, seed=7)
    sizes = torch.tensor([100, 0, 200], device="cuda")   # int64: gmm casts it
    lhs.requires_grad_()
    w = rhs.float().requires_grad_()
    counts = [k.launches for k in gm.KERNELS]
    out = gm.gmm(lhs, w.bfloat16(), sizes)
    out.backward(gout)
    assert [k.launches for k in gm.KERNELS] == [counts[0] + 2, counts[1] + 1]
    lr, wr = lhs.detach().clone().requires_grad_(), w.detach().clone().requires_grad_()
    ref = gm.grouped_matmul_plain(lr, wr.bfloat16(), sizes)
    ref.backward(gout)
    assert w.grad.dtype == torch.float32 and torch.all(w.grad[1] == 0)
    assert _rel(out, ref) <= TOL_BF16
    assert _rel(lhs.grad, lr.grad) <= TOL_BF16
    assert _rel(w.grad, wr.grad) <= TOL_BF16   # d_rhs rounded to rhs's bf16


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    lhs, rhs, gout = _case(64, 128, 128, 2, seed=1)
    sizes = torch.tensor([32, 32], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="float16, bfloat16 or float32"):
        gm.grouped_matmul(lhs.double(), rhs.double(), sizes)
    with pytest.raises(ValueError, match="float16, bfloat16 or float32"):
        gm.gmm(lhs.double(), rhs.double(), sizes)
    with pytest.raises(ValueError, match="one dtype"):
        gm.grouped_matmul(lhs, rhs.float(), sizes)
    with pytest.raises(ValueError, match="multiples of 8"):   # gmm pads it; the wrappers refuse
        gm.grouped_matmul(lhs[:, :60].contiguous(), rhs[:, :60].contiguous(), sizes)
    with pytest.raises(ValueError, match="int32"):
        gm.grouped_matmul(lhs, rhs, sizes.long())
    many = torch.zeros(gm.MAX_GROUPS + 1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="at most 2048 groups"):
        gm.grouped_matmul_drhs(lhs, gout, many, gm.MAX_GROUPS + 1)
    with pytest.raises(ValueError, match="contiguous"):
        gm.grouped_matmul_drhs(lhs, gout.t().contiguous().t(), sizes, 2)
    with pytest.raises(ValueError, match="do not match"):
        gm.grouped_matmul(lhs, rhs, sizes[:1])


@pytest.mark.parametrize("d_model,dtype", [(64, torch.bfloat16), (128, torch.float32),
                                           (128, torch.float16), (100, torch.bfloat16)])
def test_moe_layer_at_narrow_and_f32_widths_matches_the_reference(card, d_model, dtype):
    # d_model 64 or 100 (padded to 104), or an f32 or f16 compute dtype: the
    # layer's grouped matmuls run the kernels, and agree with the same layer
    # whose gmm is the dense reference (the routing, computed before either,
    # is the same): the output within the product's tolerance (bf16 1e-2,
    # f16 2e-3, f32 1e-4) and the gradients, two products deep, within twice
    # it
    from bagua_tpu_torch.model_parallel.moe import MoEMLP

    g = torch.Generator(device="cuda").manual_seed(d_model)
    x0 = torch.randn(2, 64, d_model, device="cuda", generator=g).to(dtype)
    runs = []
    for gmm_fn in (None, gm.gmm_reference):
        torch.manual_seed(0)
        layer = MoEMLP(4, 256, d_model=d_model, k=2, dropless=True, dtype=dtype,
                       gmm_fn=gmm_fn).cuda()
        x = x0.clone().requires_grad_()
        gm.reset_launch_counts()
        y = layer(x)
        (y.float().square().mean() + layer.l_aux).backward()
        torch.cuda.synchronize()
        runs.append((y, [x.grad, *(p.grad for p in layer.parameters())],
                     [k.launches for k in gm.KERNELS]))
    (y, grads, launches), (ref_y, ref_grads, ref_launches) = runs
    assert launches == [4, 2] and ref_launches == [0, 0]   # 2 products, 2 + 2 gradients
    tol = TOL[dtype]
    assert torch.isfinite(y).all() and _rel(y, ref_y) <= tol
    for a, b in zip(grads, ref_grads):
        assert torch.isfinite(a).all() and _rel(a, b) <= 2 * tol


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("d,f", [(100, 200), (200, 100), (30, 7)])
def test_odd_widths_match_plain(card, d, f, dtype):
    # widths that are not multiples of 8 go through gmm padded (to 104, 200;
    # 200, 104; 32, 8) and cut back: one K7a launch forward, one K7a and one
    # K7b backward, and output and gradients equal the plain versions on the
    # unpadded operands (d_rhs rounded to rhs's dtype on both sides)
    lhs, rhs, gout = _case(300, d, f, 3, seed=d + f, dtype=dtype)
    sizes = torch.tensor([120, 0, 150], dtype=torch.int32, device="cuda")
    runs = []
    for fn in (gm.gmm, gm.grouped_matmul_plain):
        a, b = lhs.clone().requires_grad_(), rhs.clone().requires_grad_()
        gm.reset_launch_counts()
        out = fn(a, b, sizes)
        out.backward(gout)
        torch.cuda.synchronize()
        runs.append((out, a.grad, b.grad, [k.launches for k in gm.KERNELS]))
    (out, dl, dr, launches), (ref, ref_dl, ref_dr, ref_launches) = runs
    assert launches == [2, 1] and ref_launches == [0, 0]
    assert out.shape == (300, f) and dl.shape == lhs.shape and dr.shape == rhs.shape
    assert torch.all(out[270:] == 0) and torch.all(dr[1] == 0)
    for got, want in ((out, ref), (dl, ref_dl), (dr, ref_dr)):
        assert got.dtype == want.dtype and _rel(got, want) <= TOL[dtype]


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_kernels_write_no_row_of_another_group(card, dtype, transpose):
    # K7a: every group ends inside a 128-row tile, whose last rows belong to
    # the next group.  The output starts as NaN with 64 rows more than the
    # kernel's: every row below `rows` is written, by its own group's tile
    # (rhs of group 0 is NaN, so a row of group 1 written by group 0's tile
    # would come out NaN; the launch is repeated to give a late write the
    # chance to land), and no row past `rows` is.  K7b: lhs rows of group 1
    # are NaN; group 0's d_rhs reads boxes that reach into them and zeroes
    # those rows, so it stays finite and equal to the plain version.
    rows, d, f = 400, 128, 256
    sizes = torch.tensor([150, 90, 100, 0], dtype=torch.int32, device="cuda")   # 60 tail rows
    lhs, rhs, gout = _case(rows, d, f, 4, seed=3, dtype=dtype)
    if transpose:
        rhs = rhs.transpose(1, 2).contiguous()
    rhs[0] = 0   # the plain version's one-hot product would spread a NaN to every row
    want = gm.grouped_matmul_plain(lhs, rhs, sizes, transpose)
    rhs[0] = float("nan")
    code = gm._DTYPE_CODE[dtype]
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(5):
        out = torch.full((rows + 64, f), float("nan"), device="cuda", dtype=dtype)
        assert gm._lib().bagua_gmm(lhs.data_ptr(), rhs.data_ptr(), sizes.data_ptr(),
                                   out.data_ptr(), rows, d, f, 4, int(transpose), code,
                                   stream) == 0
        torch.cuda.synchronize()
        assert torch.isnan(out[:150]).all()          # group 0: rhs is NaN
        assert not torch.isnan(out[150:rows]).any()  # groups 1, 2 and the zero tail
        assert torch.isnan(out[rows:]).all()         # past rows: never written
        assert _rel(out[150:rows], want[150:]) <= TOL[dtype]
        assert torch.all(out[340:rows] == 0)
    lhs[150:240] = float("nan")
    d_rhs = gm.grouped_matmul_drhs(lhs, gout, sizes, 4)
    want = gm.grouped_matmul_drhs_plain(lhs[:150], gout[:150], sizes[:1], 1)
    torch.cuda.synchronize()
    assert torch.isfinite(d_rhs[0]).all() and _rel(d_rhs[0], want[0]) <= TOL_F32
    assert torch.isnan(d_rhs[1]).any() and torch.isfinite(d_rhs[2]).all()
    assert torch.all(d_rhs[3] == 0)


@pytest.mark.parametrize("kind", ["balanced", "skewed"])
def test_drhs_is_deterministic(card, kind):
    # K7b splits a group of more than its chunk (8192 rows) into chunks
    # whose partial sums meet in chunk order: two launches on the same
    # inputs agree bit for bit, and both equal the plain version within f32
    # summation order; skewed puts 20000 of 24576 rows in one group (three
    # chunks), balanced one chunk a group
    rows, n_groups = 24576, 4
    sizes = ([rows // n_groups] * n_groups if kind == "balanced"
             else [20000, 1000, 0, rows - 21000])
    lhs, _, gout = _case(rows, 256, 512, n_groups, seed=11)
    sizes = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    first = gm.grouped_matmul_drhs(lhs, gout, sizes, n_groups)
    second = gm.grouped_matmul_drhs(lhs, gout, sizes, n_groups)
    want = gm.grouped_matmul_drhs_plain(lhs, gout, sizes, n_groups)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert _rel(first, want) <= TOL_F32
    if kind == "skewed":
        assert torch.all(first[2] == 0)


def test_empty_groups_give_zero_d_rhs(card):
    # an empty group's d_rhs is written as zeros over whatever the output
    # memory held, also when no row is grouped at all
    lhs, _, gout = _case(256, 128, 256, 3, seed=4)
    for sizes, rows in (([0, 256, 0], 256), ([0, 0, 0], 256), ([0, 0, 0], 0)):
        sizes = torch.tensor(sizes, dtype=torch.int32, device="cuda")
        torch.full((3, 128, 256), float("nan"), device="cuda")   # leave NaN in the cache
        d_rhs = gm.grouped_matmul_drhs(lhs[:rows], gout[:rows], sizes, 3)
        torch.cuda.synchronize()
        for g in range(3):
            if sizes[g] == 0:
                assert torch.all(d_rhs[g] == 0)
            else:
                assert torch.isfinite(d_rhs[g]).all()
