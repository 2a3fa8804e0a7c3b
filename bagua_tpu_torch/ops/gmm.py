"""Grouped matrix multiply (``gmm``): hand-written Hopper kernels behind a
torch autograd Function, the expert-FFN primitive of dropless MoE.

Port of ``bagua_tpu/ops/gmm.py``.  ``gmm(lhs, rhs, group_sizes)`` multiplies
contiguous row groups of ``lhs`` ``[rows, d]`` by per-group matrices ``rhs``
``[groups, d, f]``: group ``g`` owns rows ``group_sizes[:g].sum() :
group_sizes[:g+1].sum()``.  The two Pallas TPU kernels become the CUDA
kernels of ``csrc/gmm.cu``, built with ``nvcc`` at first use and called
through ``ctypes``:

- :func:`grouped_matmul` (K7a): ``out[r] = lhs[r] @ rhs[g(r)]``, or with
  ``transpose_rhs`` ``lhs[r] @ rhs[g(r)]^T`` (the d_lhs product);
- :func:`grouped_matmul_drhs` (K7b): ``d_rhs[g] = lhs_g^T @ gout_g`` in f32,
  zero for an empty group.

Each wrapper has a plain PyTorch version beside it and counts its launches in
``<wrapper>.launches``.  A wrapper takes the plain version only for tensors
on the CPU; for a CUDA tensor it launches the kernel or raises.  The kernels
read the group sizes on the device (they are routing counts, data of every
step), so nothing here reads them back to the host.

What :func:`gmm` takes is :func:`kernels_take`, on shape and dtype alone:
any positive d and f and a float16, bfloat16 or float32 compute dtype (that
of ``lhs``; float32 runs FMA kernels, the 16-bit types the tensor cores).
The kernels' loads need rows of a multiple of ``WIDTH_MULTIPLE`` elements,
so on the kernel path :func:`gmm` pads lhs and rhs with zero columns and
rows up to one (zeros add nothing to a product) and slices the output back;
the wrappers take only multiples.  A CUDA tensor outside the rule raises, in
:func:`gmm` as in the wrappers: there is no fallback to the dense reference
on the card, and the JAX package's TPU gate ``rows >= block_rows`` is not
carried over.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..obs import flops as _flops
from . import _build

#: the kernels' d and f are multiples of this (a 16-bit row then starts on a
#: 16-byte boundary, as TMA requires); :func:`gmm` pads to it.  The JAX
#: kernel path takes multiples of 128 and runs its reference otherwise
#: (``gmm.py:199-204``)
WIDTH_MULTIPLE = 8
#: the most groups (experts) the kernels take: K7b orders its work in a table
#: of this size in shared memory
MAX_GROUPS = 2048
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _group_of_row(group_sizes, rows: int, device):
    """Group index of each row, ``G`` for rows past the last group."""
    ends = torch.cumsum(group_sizes.to(device=device, dtype=torch.int64), 0)
    return torch.searchsorted(ends, torch.arange(rows, device=device), right=True)


def _one_hot_rows(group_sizes, rows: int, n_groups: int, device, dtype):
    """``[rows, n_groups]`` one-hot of each row's group (zero past the last
    group), built by comparison: ``F.one_hot`` reads its input's range back
    to the host."""
    g = _group_of_row(group_sizes, rows, device)
    return (g[:, None] == torch.arange(n_groups, device=device)).to(dtype)


def gmm_reference(lhs, rhs, group_sizes):
    """Dense one-hot reference, the golden (``gmm.py:37-46``): computed in
    ``lhs``'s dtype, ``rhs`` cast to it."""
    rows = lhs.shape[0]
    onehot = _one_hot_rows(group_sizes, rows, rhs.shape[0], lhs.device, lhs.dtype)
    return torch.einsum("rg,rd,gdf->rf", onehot, lhs, rhs.to(lhs.dtype)).to(lhs.dtype)


# ---------------------------------------------------------------------------
# plain versions of the two kernels
# ---------------------------------------------------------------------------


def grouped_matmul_plain(lhs, rhs, group_sizes, transpose_rhs: bool = False):
    """Plain version of :func:`grouped_matmul`: :func:`gmm_reference`'s
    one-hot einsum with the kernel's numerics, products summed in f32 and
    rounded once to ``lhs``'s dtype."""
    if transpose_rhs:
        rhs = rhs.transpose(1, 2)
    onehot = _one_hot_rows(group_sizes, lhs.shape[0], rhs.shape[0], lhs.device,
                           torch.float32)
    out = torch.einsum("rg,rd,gdf->rf", onehot, lhs.float(), rhs.float())
    return out.to(lhs.dtype)


def grouped_matmul_drhs_plain(lhs, gout, group_sizes, n_groups: int):
    """Plain version of :func:`grouped_matmul_drhs`:
    ``einsum("rg,rd,rf->gdf")`` in f32 with the one-hot of each row's group;
    an empty group sums nothing and is zero."""
    onehot = _one_hot_rows(group_sizes, lhs.shape[0], n_groups, lhs.device,
                           torch.float32)
    return torch.einsum("rg,rd,rf->gdf", onehot, lhs.float(), gout.float())


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "bagua_gmm": [_P] * 4 + [_I] * 6 + [_P],
    "bagua_gmm_drhs": [_P] * 4 + [_I] * 5 + [_P],
}
_lib_cache = []


def _lib():
    if not _lib_cache:
        _lib_cache.append(_build.bind("gmm", _SIGNATURES))
    return _lib_cache[0]


def kernels_take(d: int, f: int, dtype: torch.dtype) -> bool:
    """Whether :func:`gmm` runs the kernels for a product ``[rows, d] x
    [d, f]`` computed in ``dtype`` (padding d and f to multiples of
    ``WIDTH_MULTIPLE`` first)."""
    return dtype in _DTYPE_CODE and d >= 1 and f >= 1


def _require_taken(d: int, f: int, dtype: torch.dtype) -> None:
    """Raise unless :func:`kernels_take` accepts the product."""
    if not kernels_take(d, f, dtype):
        raise ValueError(f"gmm kernels take float16, bfloat16 or float32 with positive "
                         f"d and f, got {dtype}, d {d}, f {f}")


def _check(mats, group_sizes, d, f):
    """Raise on anything the kernels do not take: every tensor on one CUDA
    device and contiguous; ``mats`` of one dtype and 16-byte aligned, their
    dtype, d and f what :func:`kernels_take` accepts and multiples of
    ``WIDTH_MULTIPLE``; ``group_sizes`` int32 ``[G]``, G at most
    ``MAX_GROUPS``.  Returns the dtype's code."""
    ref = mats[0]
    if ref.device.type != "cuda":
        raise ValueError(f"gmm kernels take CUDA tensors, got {ref.device}")
    for t in mats:
        if t.dtype != ref.dtype:
            raise ValueError(f"gmm kernels take operands of one dtype, got "
                             f"{t.dtype} and {ref.dtype}")
    _require_taken(d, f, ref.dtype)
    if d % WIDTH_MULTIPLE or f % WIDTH_MULTIPLE:
        raise ValueError(f"gmm kernels take d and f that are multiples of "
                         f"{WIDTH_MULTIPLE} (gmm pads others), got d {d}, f {f}")
    if group_sizes.dtype != torch.int32 or group_sizes.dim() != 1:
        raise ValueError(f"group_sizes must be a 1-d int32 tensor, got "
                         f"{tuple(group_sizes.shape)} {group_sizes.dtype}")
    if group_sizes.shape[0] > MAX_GROUPS:
        raise ValueError(f"gmm kernels take at most {MAX_GROUPS} groups, got "
                         f"{group_sizes.shape[0]}")
    for t in (*mats, group_sizes):
        if t.device != ref.device:
            raise ValueError(f"operands on {t.device} and {ref.device}")
        if not t.is_contiguous():
            raise ValueError("gmm kernels take contiguous tensors")
    for t in mats:
        if t.data_ptr() % 16:
            raise ValueError("gmm kernels take 16-byte aligned operands")
    return _DTYPE_CODE[ref.dtype]


def grouped_matmul(lhs, rhs, group_sizes, transpose_rhs: bool = False):
    """K7a: ``[rows, f]`` in ``lhs``'s dtype; ``lhs`` ``[rows, d]``, ``rhs``
    ``[G, d, f]`` (or ``[G, f, d]`` with ``transpose_rhs``), ``group_sizes``
    int32 ``[G]``.  Rows past the last group come out zero."""
    if lhs.device.type == "cpu":
        return grouped_matmul_plain(lhs, rhs, group_sizes, transpose_rhs)
    if lhs.dim() != 2 or rhs.dim() != 3:
        raise ValueError(f"expected lhs [rows, d] and rhs [G, d, f], got "
                         f"{tuple(lhs.shape)} and {tuple(rhs.shape)}")
    rows, d = lhs.shape
    n_groups, rd, f = rhs.shape
    if transpose_rhs:
        rd, f = f, rd
    if rd != d or group_sizes.shape != (n_groups,):
        raise ValueError(f"shapes do not match: lhs {tuple(lhs.shape)}, rhs "
                         f"{tuple(rhs.shape)} (transpose_rhs={transpose_rhs}), "
                         f"group_sizes {tuple(group_sizes.shape)}")
    code = _check((lhs, rhs), group_sizes, d, f)
    out = torch.empty((rows, f), dtype=lhs.dtype, device=lhs.device)
    _build.launch(_lib().bagua_gmm, lhs.data_ptr(), rhs.data_ptr(),
                  group_sizes.data_ptr(), out.data_ptr(), rows, d, f, n_groups,
                  int(transpose_rhs), code)
    grouped_matmul.launches += 1
    return out


def grouped_matmul_drhs(lhs, gout, group_sizes, n_groups: int):
    """K7b: ``[G, d, f]`` f32, ``d_rhs[g] = lhs_g^T @ gout_g``; ``lhs``
    ``[rows, d]``, ``gout`` ``[rows, f]``, ``group_sizes`` int32 ``[G]``."""
    if lhs.device.type == "cpu":
        return grouped_matmul_drhs_plain(lhs, gout, group_sizes, n_groups)
    if lhs.dim() != 2 or gout.dim() != 2 or gout.shape[0] != lhs.shape[0] \
            or group_sizes.shape != (n_groups,):
        raise ValueError(f"shapes do not match: lhs {tuple(lhs.shape)}, gout "
                         f"{tuple(gout.shape)}, group_sizes "
                         f"{tuple(group_sizes.shape)}, {n_groups} groups")
    rows, d = lhs.shape
    f = gout.shape[1]
    code = _check((lhs, gout), group_sizes, d, f)
    out = torch.empty((n_groups, d, f), dtype=torch.float32, device=lhs.device)
    _build.launch(_lib().bagua_gmm_drhs, lhs.data_ptr(), gout.data_ptr(),
                  group_sizes.data_ptr(), out.data_ptr(), rows, d, f, n_groups, code)
    grouped_matmul_drhs.launches += 1
    return out


KERNELS = (grouped_matmul, grouped_matmul_drhs)


def reset_launch_counts() -> None:
    """Zero every kernel's launch count."""
    for k in KERNELS:
        k.launches = 0


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class _GMM(torch.autograd.Function):
    """The custom VJP of ``gmm.py:141-186``: d_lhs is the grouped product
    with ``rhs`` transposed (K7a), d_rhs the grouped outer product (K7b),
    returned in ``rhs``'s dtype."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes):
        rhs_c = rhs.to(lhs.dtype).contiguous()
        ctx.save_for_backward(lhs, rhs_c, group_sizes)
        ctx.rhs_dtype = rhs.dtype
        return grouped_matmul(lhs, rhs_c, group_sizes)

    @staticmethod
    def backward(ctx, gout):
        lhs, rhs_c, group_sizes = ctx.saved_tensors
        gout = gout.contiguous()
        d_lhs = d_rhs = None
        if ctx.needs_input_grad[0]:
            d_lhs = grouped_matmul(gout, rhs_c, group_sizes, transpose_rhs=True)
        if ctx.needs_input_grad[1]:
            d_rhs = grouped_matmul_drhs(lhs, gout, group_sizes,
                                        rhs_c.shape[0]).to(ctx.rhs_dtype)
        return d_lhs, d_rhs, None


def _kernel_path(x) -> bool:
    """Whether :func:`gmm` sends ``x`` to the kernel wrappers as the kernels
    take it (padded), rather than to the plain versions as it is."""
    return x.device.type != "cpu"


def gmm(lhs, rhs, group_sizes):
    """Grouped matmul: rows of ``lhs`` ``[rows, d]``, sorted so group ``g``
    occupies ``group_sizes[:g].sum() : group_sizes[:g+1].sum()``, each
    multiplied by ``rhs[g]`` ``[d, f]``; returns ``[rows, f]`` in ``lhs``'s
    dtype.  Differentiable in ``lhs`` and ``rhs``.  ``group_sizes`` may be
    any integer tensor; it is cast to int32 on its device."""
    if lhs.dim() != 2 or rhs.dim() != 3 or rhs.shape[1] != lhs.shape[1]:
        raise ValueError(f"expected lhs [rows, d] and rhs [G, d, f], got "
                         f"{tuple(lhs.shape)} and {tuple(rhs.shape)}")
    group_sizes = group_sizes.to(device=lhs.device, dtype=torch.int32)
    d, f = rhs.shape[1:]
    if _flops.counting():   # the trainer's model-flops count (obs/mfu)
        _flops.note(2.0 * lhs.shape[0] * d * f, input_grad=lhs.requires_grad,
                    weight_grad=rhs.requires_grad)
    if not _kernel_path(lhs) or not (d % WIDTH_MULTIPLE or f % WIDTH_MULTIPLE):
        return _GMM.apply(lhs.contiguous(), rhs, group_sizes)
    _require_taken(d, f, lhs.dtype)   # before padding, so that the message has the real widths
    # the kernels' rows must be a multiple of WIDTH_MULTIPLE elements: zero
    # columns of lhs meet zero rows of rhs, zero columns of rhs give output
    # columns that are cut off; autograd slices the gradients back
    d8, f8 = (-(-n // WIDTH_MULTIPLE) * WIDTH_MULTIPLE for n in (d, f))
    out = _GMM.apply(F.pad(lhs, (0, d8 - d)).contiguous(),
                     F.pad(rhs, (0, f8 - f, 0, d8 - d)), group_sizes)
    return out[:, :f]


reset_launch_counts()   # every count starts at zero
