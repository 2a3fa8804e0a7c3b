"""Bucketing: partition named tensors into flat communication buffers.

Port of ``bagua_tpu/bucket.py``: the reference autotuner's greedy
``split_bucket_by_bucket_size`` and the ``BucketSpec``/``BucketPlan``
partition.  Each bucket is one contiguous flat tensor, so one collective
moves it (the reference's ``_flatten_``), padded with zeros to a multiple of
its ``alignment`` (the compressed algorithms align to the world size, so
every rank owns an equal chunk).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Sequence, Tuple

import torch

from .define import TensorDeclaration, TensorDtype
from .tensor import NamedParam


def split_bucket_by_bucket_size(
    tensor_list: List[TensorDeclaration],
    bucket_size: int,
) -> List[List[TensorDeclaration]]:
    """Greedy dtype-grouped split: iterate dtypes in sorted order, fill a
    bucket until it reaches ``bucket_size`` bytes, then start a new one.  A
    bucket never spans two dtypes."""
    dtypes = sorted({TensorDtype(t.dtype).value for t in tensor_list})
    buckets: List[List[TensorDeclaration]] = []
    for dtype in dtypes:
        tmp: List[TensorDeclaration] = []
        tmp_bytes = 0
        for td in [t for t in tensor_list if TensorDtype(t.dtype).value == dtype]:
            tmp_bytes += td.nbytes
            tmp.append(td)
            if tmp_bytes >= bucket_size:
                buckets.append(tmp)
                tmp, tmp_bytes = [], 0
        if tmp:
            buckets.append(tmp)
    return buckets


@dataclass(frozen=True)
class BucketSpec:
    """One bucket: ordered named tensors of one dtype, padded to a multiple
    of ``alignment`` elements."""

    name: str
    tensors: Tuple[NamedParam, ...]
    alignment: int = 1

    @property
    def numel(self) -> int:
        return sum(t.numel for t in self.tensors)

    @property
    def padded_numel(self) -> int:
        return -(-self.numel // self.alignment) * self.alignment

    @property
    def dtype(self) -> torch.dtype:
        return self.tensors[0].dtype

    def offsets(self) -> List[int]:
        offs, off = [], 0
        for t in self.tensors:
            offs.append(off)
            off += t.numel
        return offs


@dataclass(frozen=True)
class BucketPlan:
    """A full partition of the registered tensors into buckets."""

    buckets: Tuple[BucketSpec, ...]

    @property
    def tensor_names(self) -> List[str]:
        return [t.name for b in self.buckets for t in b.tensors]

    @staticmethod
    def from_declaration_buckets(
        decl_buckets: Sequence[Sequence[TensorDeclaration]],
        named_params: Sequence[NamedParam],
        alignment: int = 1,
    ) -> "BucketPlan":
        by_name = {p.name: p for p in named_params}
        plan = BucketPlan(buckets=tuple(
            BucketSpec(name=str(i), tensors=tuple(by_name[d.name] for d in db),
                       alignment=alignment)
            for i, db in enumerate(decl_buckets)
        ))
        missing = set(by_name) - set(plan.tensor_names)
        if missing:
            raise ValueError(f"bucket plan misses tensors: {sorted(missing)}")
        return plan

    @staticmethod
    def build(
        named_params: Sequence[NamedParam],
        bucket_bytes: int,
        alignment: int = 1,
    ) -> "BucketPlan":
        decls = [p.declaration() for p in named_params]
        decl_buckets = split_bucket_by_bucket_size(decls, bucket_bytes)
        return BucketPlan.from_declaration_buckets(decl_buckets, named_params, alignment)

    def flatten(self, named: Mapping[str, torch.Tensor]) -> List[torch.Tensor]:
        """Tensors by name -> one new contiguous flat buffer per bucket, its
        pad tail zero (a codec's per-chunk min/max reads it)."""
        flats = []
        for b in self.buckets:
            t0 = named[b.tensors[0].name]
            flat = torch.empty(b.padded_numel, dtype=b.dtype, device=t0.device)
            for t, off in zip(b.tensors, b.offsets()):
                flat[off:off + t.numel].copy_(named[t.name].reshape(-1))
            flat[b.numel:].zero_()
            flats.append(flat)
        return flats

    def unflatten(self, flats: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Inverse of :meth:`flatten`: each tensor is a view into its
        bucket's flat buffer (a bucket holds one dtype)."""
        named = {}
        for b, flat in zip(self.buckets, flats):
            for t, off in zip(b.tensors, b.offsets()):
                named[t.name] = flat[off:off + t.numel].view(t.shape)
        return named
