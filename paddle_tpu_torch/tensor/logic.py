"""Comparison and logical ops (``paddle_tpu/tensor/logic.py``
counterpart)."""

from __future__ import annotations

import torch

__all__ = [
    "is_empty",
    "equal", "not_equal", "greater_than", "greater_equal", "less_than",
    "less_equal", "logical_and", "logical_or", "logical_not", "logical_xor",
    "equal_all", "allclose", "isclose", "is_tensor", "bitwise_and",
    "bitwise_or", "bitwise_xor", "bitwise_not", "all", "any",
]

equal = torch.eq
not_equal = torch.ne
greater_than = torch.gt
greater_equal = torch.ge
less_than = torch.lt
less_equal = torch.le
logical_and = torch.logical_and
logical_or = torch.logical_or
logical_not = torch.logical_not
logical_xor = torch.logical_xor
bitwise_and = torch.bitwise_and
bitwise_or = torch.bitwise_or
bitwise_xor = torch.bitwise_xor
bitwise_not = torch.bitwise_not


def equal_all(x, y):
    """A 0-d bool tensor: same shape and every element equal."""
    return torch.tensor(torch.equal(x, y), device=x.device)


def allclose(x, y, rtol: float = 1e-5, atol: float = 1e-8,
             equal_nan: bool = False):
    return torch.tensor(torch.allclose(x, y, rtol=rtol, atol=atol,
                                       equal_nan=equal_nan), device=x.device)


def isclose(x, y, rtol: float = 1e-5, atol: float = 1e-8,
            equal_nan: bool = False):
    return torch.isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)


def is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def _reduce(fn, x, axis, keepdim):
    if axis is None:
        out = fn(x)
        return out.reshape((1,) * x.dim()) if keepdim else out
    dim = tuple(axis) if isinstance(axis, (list, tuple)) else axis
    return fn(x, dim=dim, keepdim=keepdim)


def all(x, axis=None, keepdim: bool = False):
    return _reduce(torch.all, x, axis, keepdim)


def any(x, axis=None, keepdim: bool = False):
    return _reduce(torch.any, x, axis, keepdim)


def is_empty(x):
    """True if the tensor has zero elements (a 0-d bool tensor)."""
    return torch.tensor(x.numel() == 0, device=x.device)
