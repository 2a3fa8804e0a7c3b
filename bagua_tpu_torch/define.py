"""Shared typed definitions.

Port of ``bagua_tpu/define.py``: the tensor declaration, the autotune
service's hyperparameters and the telemetry span, with dataclasses in place
of pydantic models.  They are the autotune service's wire format, so they
are built from a dict as the pydantic models are (``Model(**d)``: nested
dicts become declarations, unknown keys are ignored, values are coerced by
pydantic's lax rules) and :meth:`model_dump` gives the dict pydantic's
would.  The torch-dtype mapping (``utils.py`` in the JAX package) lives
here too.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import List

import torch


class TensorDtype(str, enum.Enum):
    F32 = "f32"
    F16 = "f16"
    BF16 = "bf16"
    U8 = "u8"
    I32 = "i32"
    I64 = "i64"


DTYPE_BYTES = {
    TensorDtype.F32: 4,
    TensorDtype.F16: 2,
    TensorDtype.BF16: 2,
    TensorDtype.U8: 1,
    TensorDtype.I32: 4,
    TensorDtype.I64: 8,
}

_TORCH_DTYPES = {
    torch.float32: TensorDtype.F32,
    torch.float16: TensorDtype.F16,
    torch.bfloat16: TensorDtype.BF16,
    torch.uint8: TensorDtype.U8,
    torch.int32: TensorDtype.I32,
    torch.int64: TensorDtype.I64,
}


_TRUE = ("1", "on", "t", "true", "y", "yes")
_FALSE = ("0", "off", "f", "false", "n", "no")


def _as_int(value, name: str) -> int:
    """An int by pydantic's lax rules: ints and bools, integral floats, and
    strings that spell an integer."""
    if isinstance(value, (bool, int)):
        return int(value)
    if isinstance(value, float) and value.is_integer():
        return int(value)
    if isinstance(value, str):
        try:
            return int(value.strip())
        except ValueError:
            pass
    raise ValueError(f"{name}: input should be a valid integer, got {value!r}")


def _as_bool(value, name: str) -> bool:
    """A bool by pydantic's lax rules: bools, 0 and 1, and the usual
    spellings of yes and no."""
    if isinstance(value, bool):
        return value
    if isinstance(value, (int, float)) and value in (0, 1):
        return bool(value)
    if isinstance(value, str) and value.strip().lower() in _TRUE + _FALSE:
        return value.strip().lower() in _TRUE
    raise ValueError(f"{name}: input should be a valid boolean, got {value!r}")


def _as_str(value, name: str) -> str:
    if isinstance(value, str):
        return value
    raise ValueError(f"{name}: input should be a valid string, got {value!r}")


#: by annotation (strings: ``from __future__ import annotations``)
_COERCE = {"int": _as_int, "bool": _as_bool, "str": _as_str}


class _WireModel:
    """Construction from keyword arguments with coercion, and
    :meth:`model_dump`, for the dataclasses below."""

    def __post_init__(self):
        for f in dataclasses.fields(self):
            coerce = _COERCE.get(f.type)
            if coerce is not None:
                object.__setattr__(self, f.name, coerce(getattr(self, f.name), f.name))

    def model_dump(self) -> dict:
        return {f.name: _dump(getattr(self, f.name)) for f in dataclasses.fields(self)}


def _dump(value):
    if isinstance(value, _WireModel):
        return value.model_dump()
    if isinstance(value, (list, tuple)):
        return [_dump(v) for v in value]
    return value


def _fields_only(cls):
    """Let ``cls(**d)`` ignore keys that are not fields, as a pydantic
    model does."""
    init = cls.__init__
    names = frozenset(f.name for f in dataclasses.fields(cls))

    def __init__(self, *args, **kwargs):
        init(self, *args, **{k: v for k, v in kwargs.items() if k in names})

    __init__.__doc__ = init.__doc__
    cls.__init__ = __init__
    return cls


@_fields_only
@dataclass(frozen=True)
class TensorDeclaration(_WireModel):
    name: str
    num_elements: int
    dtype: TensorDtype

    def __post_init__(self):
        super().__post_init__()
        try:
            object.__setattr__(self, "dtype", TensorDtype(self.dtype))
        except ValueError:
            raise ValueError(f"dtype: input should be one of "
                             f"{[d.value for d in TensorDtype]}, got {self.dtype!r}") from None

    @property
    def nbytes(self) -> int:
        return self.num_elements * DTYPE_BYTES[TensorDtype(self.dtype)]


def _declaration(value) -> TensorDeclaration:
    if isinstance(value, TensorDeclaration):
        return value
    if isinstance(value, dict):
        return TensorDeclaration(**value)
    raise ValueError(f"buckets: input should be a TensorDeclaration or a dict, got {value!r}")


@_fields_only
@dataclass
class BaguaHyperparameter(_WireModel):
    """Tunable hyperparameters mutated by the autotune service
    (``bagua_tpu/define.py:52``).  ``""`` (and 0 for the chunk sizes) keeps
    the trainer's current value."""

    buckets: List[List[TensorDeclaration]] = field(default_factory=list)
    is_hierarchical_reduce: bool = False
    bucket_size: int = 10 * 1024 ** 2
    #: algorithm family recommended by the autotuner ("" = keep current)
    algorithm: str = ""
    #: overlap-scheduler mode ("auto"|"on"|"off"; "" = keep current)
    overlap: str = ""
    #: ring sub-collective size in bytes (0 = keep current)
    overlap_chunk_bytes: int = 0
    #: per-tier ring chunk targets (0 = keep current)
    overlap_chunk_bytes_intra: int = 0
    overlap_chunk_bytes_inter: int = 0
    #: per-tier codec policy: ``off``/``auto``/a codec name ("" = keep)
    compress_intra: str = ""
    compress_inter: str = ""
    #: bucket-flat residency of the training state ("on"|"off"; "" = keep)
    flat_resident: str = ""

    def __post_init__(self):
        super().__post_init__()
        if not isinstance(self.buckets, (list, tuple)):
            raise ValueError(f"buckets: input should be a valid list, got {self.buckets!r}")
        out = []
        for b in self.buckets:
            if not isinstance(b, (list, tuple)):
                raise ValueError(f"buckets: input should be a valid list, got {b!r}")
            out.append([_declaration(t) for t in b])
        self.buckets = out

    def update(self, param_dict: dict) -> "BaguaHyperparameter":
        """Set the known fields of ``param_dict`` as given (unvalidated, as
        the JAX package's ``update`` writes ``__dict__``)."""
        names = {f.name for f in dataclasses.fields(self)}
        for key, value in param_dict.items():
            if key in names:
                self.__dict__[key] = value
        return self


@_fields_only
@dataclass
class BaguaCoreTelemetrySpan(_WireModel):
    trace_id: int
    action: str
    tensor_name: str
    start_time: int
    end_time: int


def to_bagua_datatype(dtype: torch.dtype) -> TensorDtype:
    """torch dtype -> wire datatype name."""
    try:
        return _TORCH_DTYPES[dtype]
    except KeyError:
        raise ValueError(f"unsupported data type {dtype}.") from None
