"""Shared typed definitions.

Port of ``bagua_tpu/define.py``'s tensor declarations, with dataclasses in
place of pydantic models.  The torch-dtype mapping (``utils.py`` in the JAX
package) lives here too.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

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


@dataclass(frozen=True)
class TensorDeclaration:
    name: str
    num_elements: int
    dtype: TensorDtype

    @property
    def nbytes(self) -> int:
        return self.num_elements * DTYPE_BYTES[TensorDtype(self.dtype)]


def to_bagua_datatype(dtype: torch.dtype) -> TensorDtype:
    """torch dtype -> wire datatype name."""
    try:
        return _TORCH_DTYPES[dtype]
    except KeyError:
        raise ValueError(f"unsupported data type {dtype}.") from None
