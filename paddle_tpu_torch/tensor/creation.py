"""Tensor creation ops (``paddle_tpu/tensor/creation.py`` counterpart).

A new tensor is made on the device :func:`~..core.device.resolve_device`
gives for ``None``: the one :func:`~..core.device.set_device` chose for
this thread, else ``cuda:0``. A float dtype left unsaid is
``FLAGS_default_dtype``'s; integers are int64, as Paddle makes them (the
JAX package, with 64-bit types off, makes int32).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core.device import resolve_device

__all__ = [
    "to_tensor", "zeros", "ones", "full", "zeros_like", "ones_like",
    "full_like", "arange", "linspace", "eye", "empty", "empty_like",
    "diag", "diagflat", "tril", "triu", "meshgrid", "assign", "clone",
    "numel", "tolist", "logspace", "vander", "tril_indices", "triu_indices",
]


def _dev() -> torch.device:
    return resolve_device(None)


def _dt(dtype):
    return dtypes.to_dtype(dtype) if dtype else dtypes.get_default_dtype()


def _shape(shape):
    if isinstance(shape, int):
        return (shape,)
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in shape.reshape(-1).tolist())
    return tuple(int(s) for s in shape)


def _dims(x, axis):
    """``axis`` as torch's ``dim``: every axis for None, a tuple for a
    list."""
    if axis is None:
        return tuple(range(x.dim()))
    return tuple(axis) if isinstance(axis, (list, tuple)) else axis


def to_tensor(data, dtype=None, place=None, stop_gradient: bool = True):
    """``paddle.to_tensor``: a ``torch.Tensor`` on ``place`` (a Paddle
    string such as ``"gpu:0"`` or ``"cpu"``, or a torch device; None is
    this thread's device), copied from ``data``, with ``requires_grad =
    not stop_gradient``. A Python float or a float64 array with no
    ``dtype`` takes ``FLAGS_default_dtype``, as in JAX."""
    dev = resolve_device(place)
    if dtype is not None:
        dtype = dtypes.to_dtype(dtype)
    if isinstance(data, torch.Tensor):
        t = data.detach().to(device=dev, dtype=dtype, copy=True)
    else:
        arr = np.asarray(data)
        if dtype is None and arr.dtype == np.float64:
            dtype = dtypes.get_default_dtype()
        t = torch.as_tensor(arr, device=dev)
        t = t.to(dtype) if dtype is not None else t.clone()
    if not stop_gradient:
        t.requires_grad_(True)
    return t


def zeros(shape, dtype=None) -> torch.Tensor:
    return torch.zeros(_shape(shape), dtype=_dt(dtype), device=_dev())


def ones(shape, dtype=None) -> torch.Tensor:
    return torch.ones(_shape(shape), dtype=_dt(dtype), device=_dev())


def full(shape, fill_value, dtype=None) -> torch.Tensor:
    return torch.full(_shape(shape), fill_value, dtype=_dt(dtype),
                      device=_dev())


def zeros_like(x, dtype=None) -> torch.Tensor:
    return torch.zeros_like(x, dtype=dtypes.to_dtype(dtype) if dtype
                            else None)


def ones_like(x, dtype=None) -> torch.Tensor:
    return torch.ones_like(x, dtype=dtypes.to_dtype(dtype) if dtype
                           else None)


def full_like(x, fill_value, dtype=None) -> torch.Tensor:
    return torch.full_like(x, fill_value, dtype=dtypes.to_dtype(dtype)
                           if dtype else None)


def arange(start=0, end=None, step=1, dtype=None) -> torch.Tensor:
    if end is None:
        start, end = 0, start
    if dtype:
        dtype = dtypes.to_dtype(dtype)
    elif any(isinstance(v, float) for v in (start, end, step)):
        dtype = dtypes.get_default_dtype()
    return torch.arange(start, end, step, dtype=dtype, device=_dev())


def linspace(start, stop, num, dtype=None) -> torch.Tensor:
    return torch.linspace(start, stop, int(num), dtype=_dt(dtype),
                          device=_dev())


def eye(num_rows, num_columns=None, dtype=None) -> torch.Tensor:
    return torch.eye(num_rows, num_rows if num_columns is None
                     else num_columns, dtype=_dt(dtype), device=_dev())


def empty(shape, dtype=None) -> torch.Tensor:
    return zeros(shape, dtype)


def empty_like(x, dtype=None) -> torch.Tensor:
    return zeros_like(x, dtype)


def diag(x, offset: int = 0, padding_value: float = 0) -> torch.Tensor:
    out = torch.diag(x, offset)
    if padding_value != 0 and x.dim() == 1:
        keep = torch.diag(torch.ones(x.shape[0], dtype=torch.bool,
                                     device=x.device), offset)
        out = torch.where(keep, out, padding_value)
    return out


def diagflat(x, offset: int = 0) -> torch.Tensor:
    return torch.diagflat(x, offset)


def tril(x, diagonal: int = 0) -> torch.Tensor:
    return torch.tril(x, diagonal)


def triu(x, diagonal: int = 0) -> torch.Tensor:
    return torch.triu(x, diagonal)


def meshgrid(*args):
    return list(torch.meshgrid(*args, indexing="ij"))


def assign(x, output=None) -> torch.Tensor:
    """``paddle.assign``: a copy of ``x``, written into ``output`` when it
    is given (torch tensors are mutable; JAX's returns the copy only)."""
    value = x.detach().clone() if isinstance(x, torch.Tensor) else \
        to_tensor(x)
    if output is None:
        return value
    with torch.no_grad():
        output.copy_(value)
    return output


def clone(x) -> torch.Tensor:
    return x.clone()


def numel(x) -> int:
    return int(x.numel())


def tolist(x):
    return x.tolist()


def logspace(start, stop, num, base=10.0, dtype=None):
    return torch.logspace(start, stop, int(num), base=base, dtype=_dt(dtype),
                          device=_dev())


def vander(x, n=None, increasing: bool = False):
    return torch.vander(x, N=n, increasing=increasing)


def tril_indices(row, col=None, offset: int = 0):
    return torch.tril_indices(row, row if col is None else col, offset,
                              device=_dev())


def triu_indices(row, col=None, offset: int = 0):
    return torch.triu_indices(row, row if col is None else col, offset,
                              device=_dev())
