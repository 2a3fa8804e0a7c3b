"""Bucketing: partition named tensors into flat communication buffers.

Port of ``bagua_tpu/bucket.py``: the reference autotuner's greedy
``split_bucket_by_bucket_size`` and the ``BucketSpec``/``BucketPlan``
partition.  Each bucket is one contiguous flat tensor, so one collective
moves it (the reference's ``_flatten_``), padded with zeros to a multiple of
its ``alignment`` (the compressed algorithms align to the world size, so
every rank owns an equal chunk).

The flat-resident layout keeps the training state in such flats across
steps: :meth:`BucketPlan.flatten` allocates the parameters' flats,
:meth:`BucketSpec.zeros` a gradient flat, :meth:`BucketSpec.views` and
:meth:`BucketPlan.unflatten` hand out views into them, and
:func:`relayout_flats` moves flats from one plan onto another when the
buckets change.  :meth:`BucketPlan.layout_descriptor` describes a plan in the
JSON form of the JAX package's (``bucket.py:174-220``), dtype names included,
so that a checkpoint's sidecar rebuilds the plan it was saved under
(:meth:`BucketPlan.from_layout_descriptor`) in either package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Sequence, Tuple

import torch

from .define import TensorDeclaration, TensorDtype
from .tensor import NamedParam

#: torch dtype <-> the numpy name the JAX package writes in a layout
#: descriptor (``np.dtype(...).name``)
_DTYPE_NAMES = {
    torch.float32: "float32",
    torch.float16: "float16",
    torch.bfloat16: "bfloat16",
    torch.float64: "float64",
    torch.uint8: "uint8",
    torch.int8: "int8",
    torch.int32: "int32",
    torch.int64: "int64",
}
_DTYPES_BY_NAME = {v: k for k, v in _DTYPE_NAMES.items()}


def dtype_name(dtype: torch.dtype) -> str:
    """The numpy name of a torch dtype (``torch.float32`` -> ``float32``),
    as the JAX package names dtypes in descriptors and signatures."""
    try:
        return _DTYPE_NAMES[dtype]
    except KeyError:
        raise ValueError(f"no layout-descriptor name for dtype {dtype}") from None


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

    def signature(self) -> Tuple:
        return (self.name, self.alignment,
                tuple((t.name, t.shape, str(t.dtype)) for t in self.tensors))

    def zeros(self, device) -> torch.Tensor:
        """A zero flat of this bucket (``padded_numel`` elements of its
        dtype), the resident layout's gradient buffer."""
        return torch.zeros(self.padded_numel, dtype=self.dtype, device=device)

    def flatten_of(self, named: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """A new flat of this bucket from its tensors by name, the pad tail
        zero."""
        t0 = named[self.tensors[0].name]
        flat = torch.empty(self.padded_numel, dtype=self.dtype, device=t0.device)
        for t, off in zip(self.tensors, self.offsets()):
            flat[off:off + t.numel].copy_(named[t.name].reshape(-1))
        flat[self.numel:].zero_()
        return flat

    def views(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Each tensor of the bucket as a view into ``flat``, by name."""
        return {t.name: flat[off:off + t.numel].view(t.shape)
                for t, off in zip(self.tensors, self.offsets())}


@dataclass(frozen=True)
class BucketPlan:
    """A full partition of the registered tensors into buckets."""

    buckets: Tuple[BucketSpec, ...]

    def signature(self) -> Tuple:
        return tuple(b.signature() for b in self.buckets)

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
        return [b.flatten_of(named) for b in self.buckets]

    def unflatten(self, flats: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Inverse of :meth:`flatten`: each tensor is a view into its
        bucket's flat buffer (a bucket holds one dtype)."""
        named = {}
        for b, flat in zip(self.buckets, flats):
            named.update(b.views(flat))
        return named

    def portable_signature(self) -> Tuple:
        """:meth:`signature` with numpy dtype names: the JAX package's
        ``BucketPlan.signature()`` of the same plan, which its checkpoint
        ``plan_signature`` hashes."""
        return tuple((b.name, b.alignment,
                      tuple((t.name, tuple(int(d) for d in t.shape), dtype_name(t.dtype))
                            for t in b.tensors))
                     for b in self.buckets)

    # ---- layout portability ------------------------------------------

    def layout_descriptor(self) -> List[dict]:
        """JSON description of the flat layout, per bucket its
        ``alignment`` and its tensors' ``name``, ``shape`` and ``dtype`` in
        order: enough to rebuild the plan (:meth:`from_layout_descriptor`)
        without the model.  Checkpoint sidecars carry it, so that a
        flat-resident checkpoint restores under another plan."""
        return [
            {
                "alignment": int(b.alignment),
                "tensors": [
                    {"name": t.name, "shape": [int(d) for d in t.shape],
                     "dtype": dtype_name(t.dtype)}
                    for t in b.tensors
                ],
            }
            for b in self.buckets
        ]

    @staticmethod
    def from_layout_descriptor(desc: Sequence[dict]) -> "BucketPlan":
        """The plan of a :meth:`layout_descriptor` (the JAX package's
        included); buckets are named by their index, as a plan names them."""
        return BucketPlan(buckets=tuple(
            BucketSpec(
                name=str(i),
                tensors=tuple(NamedParam(t["name"], tuple(int(d) for d in t["shape"]),
                                         _DTYPES_BY_NAME[t["dtype"]])
                              for t in b["tensors"]),
                alignment=int(b["alignment"]))
            for i, b in enumerate(desc)))


def relayout_flats(old_plan: BucketPlan, new_plan: BucketPlan,
                   flats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Move flat bucket buffers from ``old_plan``'s layout onto
    ``new_plan``'s without going through the tensors' shapes
    (``bucket.py:219-270``): each tensor's 1-D segment is sliced out of the
    old flats and copied into new ones, the old padding dropped and the new
    padding zero.  Segments slice along the last axis, so flats with leading
    axes move the same way.  Both plans must hold the same tensors at the
    same sizes."""
    segments: Dict[str, torch.Tensor] = {}
    for b, flat in zip(old_plan.buckets, flats):
        for t, off in zip(b.tensors, b.offsets()):
            segments[t.name] = flat[..., off:off + t.numel]
    missing = [t.name for b in new_plan.buckets for t in b.tensors if t.name not in segments]
    if missing:
        raise ValueError(f"relayout_flats: old plan misses tensors {sorted(missing)}")
    resized = {t.name: (segments[t.name].shape[-1], t.numel)
               for b in new_plan.buckets for t in b.tensors
               if segments[t.name].shape[-1] != t.numel}
    if resized:
        # a silently shifted offset would corrupt every later tensor of the
        # bucket (with equal total lengths, without any error at all)
        raise ValueError(
            "relayout_flats: tensor sizes differ between plans — the flat buffers "
            "cannot be re-laid-out (model edit between save and restore?): "
            + ", ".join(f"{n}: {a} -> {b} elems" for n, (a, b) in sorted(resized.items())))
    out: List[torch.Tensor] = []
    for b in new_plan.buckets:
        first = segments[b.tensors[0].name]
        flat = first.new_zeros(first.shape[:-1] + (b.padded_numel,), dtype=b.dtype)
        for t, off in zip(b.tensors, b.offsets()):
            flat[..., off:off + t.numel].copy_(segments[t.name])
        out.append(flat)
    return out
