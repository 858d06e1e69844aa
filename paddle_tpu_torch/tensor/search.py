"""Search and sort ops (``paddle_tpu/tensor/search.py`` counterpart).
Indices are int64 unless ``dtype``/``out_int32`` says otherwise."""

from __future__ import annotations

import torch

from ..core import dtype as dtypes

__all__ = ["argmax", "argmin", "argsort", "sort", "topk", "searchsorted",
           "nonzero", "index_sample", "bucketize"]


def _arg(fn, x, axis, keepdim, dtype):
    if axis is None:
        out = fn(x.reshape(-1))
        if keepdim:
            out = out.reshape((1,) * x.dim())
    else:
        out = fn(x, dim=axis, keepdim=keepdim)
    return out.to(dtypes.to_dtype(dtype))


def argmax(x, axis=None, keepdim: bool = False, dtype="int64"):
    return _arg(torch.argmax, x, axis, keepdim, dtype)


def argmin(x, axis=None, keepdim: bool = False, dtype="int64"):
    return _arg(torch.argmin, x, axis, keepdim, dtype)


def argsort(x, axis: int = -1, descending: bool = False, stable: bool = True):
    return torch.argsort(x, dim=axis, descending=descending, stable=stable)


def sort(x, axis: int = -1, descending: bool = False, stable: bool = True):
    return torch.sort(x, dim=axis, descending=descending,
                      stable=stable).values


def topk(x, k: int, axis: int = -1, largest: bool = True, sorted: bool = True):
    vals, idxs = torch.topk(x, k, dim=axis, largest=largest, sorted=sorted)
    return vals, idxs


def searchsorted(sorted_sequence, values, out_int32: bool = False,
                 right: bool = False):
    return torch.searchsorted(sorted_sequence, values, out_int32=out_int32,
                              right=right)


def bucketize(x, sorted_sequence, out_int32: bool = False,
              right: bool = False):
    """``paddle.bucketize``: the buckets x's values fall into —
    searchsorted with the operand order swapped."""
    return searchsorted(sorted_sequence, x, out_int32=out_int32, right=right)


def nonzero(x, as_tuple: bool = False):
    return torch.nonzero(x, as_tuple=as_tuple)


def index_sample(x, index):
    return torch.gather(x, 1, index)
