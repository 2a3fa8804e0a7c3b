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
step), so nothing here reads them back to the host.  Unlike the JAX package
there is no fallback to the dense reference off the TPU or at tiny shapes.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: d and f must be multiples of this for the kernels (the JAX kernel path's
#: own condition, ``gmm.py:199-204``)
DIM_MULTIPLE = 128


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
    "bagua_gmm": [_P] * 4 + [_I] * 5 + [_P],
    "bagua_gmm_drhs": [_P] * 4 + [_I] * 4 + [_P],
}
_lib_cache = []


def _lib():
    if not _lib_cache:
        _lib_cache.append(_build.bind("gmm", _SIGNATURES))
    return _lib_cache[0]


def _check(mats, group_sizes, dims):
    """Raise on anything the kernels do not take: every tensor on one CUDA
    device and contiguous; ``mats`` bf16 and 16-byte aligned;
    ``group_sizes`` int32 ``[G]``; ``dims`` multiples of 128."""
    ref = mats[0]
    if ref.device.type != "cuda":
        raise ValueError(f"gmm kernels take CUDA tensors, got {ref.device}")
    for t in mats:
        if t.dtype != torch.bfloat16:
            raise ValueError(f"gmm kernels take bfloat16 operands, got {t.dtype}")
    if group_sizes.dtype != torch.int32 or group_sizes.dim() != 1:
        raise ValueError(f"group_sizes must be a 1-d int32 tensor, got "
                         f"{tuple(group_sizes.shape)} {group_sizes.dtype}")
    for t in (*mats, group_sizes):
        if t.device != ref.device:
            raise ValueError(f"operands on {t.device} and {ref.device}")
        if not t.is_contiguous():
            raise ValueError("gmm kernels take contiguous tensors")
    for t in mats:
        if t.data_ptr() % 16:
            raise ValueError("gmm kernels take 16-byte aligned operands")
    for name, n in dims.items():
        if n < DIM_MULTIPLE or n % DIM_MULTIPLE:
            raise ValueError(f"{name} must be a positive multiple of "
                             f"{DIM_MULTIPLE}, got {n}")


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
    _check((lhs, rhs), group_sizes, {"d": d, "f": f})
    out = torch.empty((rows, f), dtype=lhs.dtype, device=lhs.device)
    _build.launch(_lib().bagua_gmm, lhs.data_ptr(), rhs.data_ptr(),
                  group_sizes.data_ptr(), out.data_ptr(), rows, d, f, n_groups,
                  int(transpose_rhs))
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
    _check((lhs, gout), group_sizes, {"d": d, "f": f})
    out = torch.empty((n_groups, d, f), dtype=torch.float32, device=lhs.device)
    _build.launch(_lib().bagua_gmm_drhs, lhs.data_ptr(), gout.data_ptr(),
                  group_sizes.data_ptr(), out.data_ptr(), rows, d, f, n_groups)
    grouped_matmul_drhs.launches += 1
    return out


KERNELS = (grouped_matmul, grouped_matmul_drhs)
for _k in KERNELS:
    _k.launches = 0


def reset_launch_counts() -> None:
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
    return _GMM.apply(lhs.contiguous(), rhs, group_sizes)
