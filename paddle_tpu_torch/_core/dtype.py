"""Paddle dtype names over torch dtypes, and the default float dtype.

Counterpart of ``paddle_tpu/_core/dtype.py``: the reference's DataType
names (``"float32"``, ``"bf16"``, ``"paddle.int8"``, ...) map to
``torch.dtype`` objects, and ``set_default_dtype`` /
``get_default_dtype`` hold the float type that Python floats and float64
data take. 64-bit types canonicalise to their 32-bit counterparts, as
the reference does by default (its x32 rule), so a tensor made from the
same numpy data has the same dtype in both packages.
"""
from __future__ import annotations

import numpy as np
import torch

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_STR_ALIASES = {
    "bool": bool_, "uint8": uint8, "int8": int8, "int16": int16,
    "int32": int32, "int64": int64, "float16": float16, "half": float16,
    "bfloat16": bfloat16, "bf16": bfloat16, "float32": float32,
    "float": float32, "float64": float64, "double": float64,
    "complex64": complex64, "complex128": complex128,
}
_FLOATING = {float16, bfloat16, float32, float64}
_X32 = {int64: int32, float64: float32, complex128: complex64}

_default_dtype = float32


def set_default_dtype(d):
    """Set the default float dtype (float16, bfloat16, float32 or
    float64)."""
    global _default_dtype
    d = convert_dtype(d, canonicalize=False)
    if d not in _FLOATING:
        raise TypeError(f"set_default_dtype only supports float16/bfloat16/"
                        f"float32/float64, got {d}")
    _default_dtype = d


def get_default_dtype() -> torch.dtype:
    return _default_dtype


def convert_dtype(d, canonicalize: bool = True):
    """Any dtype spec (a Paddle name, ``torch.dtype``, numpy dtype or
    Python type) as a ``torch.dtype``; ``None`` stays ``None``. With
    ``canonicalize``, 64-bit types become 32-bit ones."""
    if d is None:
        return None
    if isinstance(d, torch.dtype):
        out = d
    elif isinstance(d, str):
        name = d.split(".")[-1]          # "paddle.float32" style
        out = _STR_ALIASES.get(name)
        if out is None:
            raise TypeError(f"unknown dtype {d!r}")
    elif d is bool:
        out = bool_
    elif d is int:
        out = int64
    elif d is float:
        out = _default_dtype
    else:
        out = _STR_ALIASES.get(np.dtype(d).name)
        if out is None:
            raise TypeError(f"unsupported dtype {d!r}")
    return _X32.get(out, out) if canonicalize else out


def dtype_name(d) -> str:
    return str(convert_dtype(d, canonicalize=False)).split(".")[-1]
