"""Dtype names and helpers (``paddle_tpu/core/dtype.py`` counterpart).

Paddle's dtype names (``float32``, ``bfloat16``, ``fp16``, ...) as torch
dtypes. One difference from the JAX package, which runs with 64-bit types
off: a ``float64`` or ``int64`` asked for here is 64 bits, as Paddle
specifies, where JAX computes in 32.
"""

from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

__all__ = ["bool_", "uint8", "int8", "int16", "int32", "int64", "float16",
           "bfloat16", "float32", "float64", "complex64", "complex128",
           "float8_e4m3", "float8_e5m2", "to_dtype", "dtype_name",
           "is_floating_point", "is_integer", "finfo", "iinfo",
           "get_default_dtype", "set_default_dtype"]

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
float8_e4m3 = torch.float8_e4m3fn
float8_e5m2 = torch.float8_e5m2

_NAME_TO_DTYPE = {
    "bool": bool_,
    "uint8": uint8,
    "int8": int8,
    "int16": int16,
    "int32": int32,
    "int64": int64,
    "float16": float16,
    "bfloat16": bfloat16,
    "float32": float32,
    "float64": float64,
    "complex64": complex64,
    "complex128": complex128,
    "float8_e4m3": float8_e4m3,
    "float8_e5m2": float8_e5m2,
    # paddle aliases
    "fp16": float16,
    "bf16": bfloat16,
    "fp32": float32,
    "fp64": float64,
}

DTypeLike = Union[str, torch.dtype, np.dtype, type, Any]


def to_dtype(dtype: DTypeLike):
    """A Paddle, numpy or torch dtype spec as a torch dtype (None stays
    None)."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        try:
            return _NAME_TO_DTYPE[dtype]
        except KeyError:
            raise ValueError(f"Unknown dtype name {dtype!r}")
    name = getattr(dtype, "name", None) or np.dtype(dtype).name
    if name == "float8_e4m3fn":
        return float8_e4m3
    return to_dtype(name)


def dtype_name(dtype: DTypeLike) -> str:
    """numpy's name of the dtype (``"float32"``, ``"bool"``)."""
    return str(to_dtype(dtype)).replace("torch.", "")


def is_floating_point(dtype: DTypeLike) -> bool:
    return to_dtype(dtype).is_floating_point


def is_integer(dtype: DTypeLike) -> bool:
    d = to_dtype(dtype)
    return not (d.is_floating_point or d.is_complex or d is torch.bool)


def finfo(dtype: DTypeLike):
    return torch.finfo(to_dtype(dtype))


def iinfo(dtype: DTypeLike):
    return torch.iinfo(to_dtype(dtype))


def get_default_dtype():
    """``FLAGS_default_dtype`` as a torch dtype (``float32`` by default)."""
    from . import flags
    return to_dtype(flags.flag("default_dtype"))


def set_default_dtype(dtype: DTypeLike) -> None:
    from . import flags
    flags.set_flags({"default_dtype": dtype_name(dtype)})
