"""Statistics ops (``paddle_tpu/tensor/stat.py`` counterpart)."""

from __future__ import annotations

import torch

from .creation import _dims

__all__ = ["mean", "std", "var", "median", "quantile", "nanmean", "nansum",
           "nanmedian", "kthvalue", "mode"]


def mean(x, axis=None, keepdim: bool = False):
    return torch.mean(x, dim=_dims(x, axis), keepdim=keepdim)


def std(x, axis=None, unbiased: bool = True, keepdim: bool = False):
    return torch.std(x, dim=_dims(x, axis), correction=1 if unbiased else 0,
                     keepdim=keepdim)


def var(x, axis=None, unbiased: bool = True, keepdim: bool = False):
    return torch.var(x, dim=_dims(x, axis), correction=1 if unbiased else 0,
                     keepdim=keepdim)


def _quantile(fn, x, q, axis, keepdim):
    """``fn`` (``torch.quantile``/``nanquantile``, linear interpolation,
    as numpy's median averages the middle two) over ``axis`` (None: all
    of x)."""
    q = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    if axis is None:
        out = fn(x.reshape(-1), q, dim=0)
        return out.reshape(q.shape + (1,) * x.dim()) if keepdim else out
    return fn(x, q, dim=axis, keepdim=keepdim)


def median(x, axis=None, keepdim: bool = False):
    return _quantile(torch.quantile, x, 0.5, axis, keepdim)


def quantile(x, q, axis=None, keepdim: bool = False):
    return _quantile(torch.quantile, x, q, axis, keepdim)


def nanmean(x, axis=None, keepdim: bool = False):
    return torch.nanmean(x, dim=_dims(x, axis), keepdim=keepdim)


def nansum(x, axis=None, keepdim: bool = False):
    return torch.nansum(x, dim=_dims(x, axis), keepdim=keepdim)


def nanmedian(x, axis=None, keepdim: bool = False):
    return _quantile(torch.nanquantile, x, 0.5, axis, keepdim)


def kthvalue(x, k: int, axis: int = -1, keepdim: bool = False):
    """``(values, indices)`` of the k-th smallest along ``axis``, ties
    taken in order (a stable sort), as JAX's."""
    vals, idx = torch.sort(x, dim=axis, stable=True)
    taken = vals.select(axis, k - 1)
    taken_idx = idx.select(axis, k - 1)
    if keepdim:
        taken, taken_idx = taken.unsqueeze(axis), taken_idx.unsqueeze(axis)
    return taken, taken_idx


def mode(x, axis: int = -1, keepdim: bool = False):
    """``paddle.mode``: ``(values, indices)`` of the most frequent element
    along ``axis``; ties go to the smallest value, and the index is that
    value's last occurrence (JAX's sort-based run counting)."""
    xm = torch.movedim(x, axis, -1)
    xs = torch.sort(xm, dim=-1).values
    n = xs.shape[-1]
    j = torch.arange(n, device=x.device).expand(xs.shape)
    new_run = torch.cat([torch.ones_like(xs[..., :1], dtype=torch.bool),
                         xs[..., 1:] != xs[..., :-1]], -1)
    first = torch.cummax(torch.where(new_run, j, 0), dim=-1).values
    run_last = torch.cat([new_run[..., 1:],
                          torch.ones_like(xs[..., :1], dtype=torch.bool)], -1)
    last = torch.flip(torch.cummin(torch.flip(
        torch.where(run_last, j, n - 1), [-1]), dim=-1).values, [-1])
    count = last - first + 1
    p = torch.argmax(count, dim=-1)      # the first max: the smallest value
    m = torch.gather(xs, -1, p[..., None])
    idx = torch.amax(torch.where(xm == m, torch.arange(n, device=x.device),
                                 -1), dim=-1)
    vals = m.squeeze(-1)
    if keepdim:
        vals, idx = vals.unsqueeze(axis), idx.unsqueeze(axis)
    return vals, idx
