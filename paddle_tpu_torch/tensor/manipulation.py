"""Shape and layout ops (``paddle_tpu/tensor/manipulation.py``
counterpart). The scatter-like ops return a new tensor and leave their
input as it was, as JAX's do."""

from __future__ import annotations

import builtins
from typing import Sequence

import torch

from ..core import dtype as dtypes

__all__ = [
    "masked_scatter",
    "reshape", "flatten", "transpose", "concat", "stack", "unstack", "split",
    "chunk", "squeeze", "unsqueeze", "expand", "expand_as", "tile",
    "broadcast_to", "flip", "roll", "gather", "gather_nd", "scatter",
    "scatter_nd_add", "index_select", "masked_select", "where",
    "take_along_axis", "put_along_axis", "slice", "strided_slice", "cast",
    "repeat_interleave", "unbind", "moveaxis", "swapaxes", "as_complex",
    "as_real", "unique", "masked_fill", "index_put", "rot90", "atleast_1d",
    "atleast_2d", "atleast_3d", "diagonal", "diag_embed", "fill_diagonal",
    "index_add", "index_fill", "reverse", "crop", "unique_consecutive",
]


def reshape(x, shape):
    return torch.reshape(x, tuple(shape))


def flatten(x, start_axis: int = 0, stop_axis: int = -1):
    return torch.flatten(x, start_axis, stop_axis)


def transpose(x, perm: Sequence[int]):
    return x.permute(tuple(perm))


def concat(xs, axis: int = 0):
    return torch.cat(list(xs), dim=axis)


def stack(xs, axis: int = 0):
    return torch.stack(list(xs), dim=axis)


def unstack(x, axis: int = 0, num=None):
    return list(torch.unbind(x, dim=axis))


def split(x, num_or_sections, axis: int = 0):
    """An int splits into that many equal parts (``ValueError`` if it does
    not divide); a list gives the sizes, one of them -1 for the rest."""
    total = x.shape[axis]
    if isinstance(num_or_sections, int):
        if total % num_or_sections:
            raise ValueError(f"array split does not result in an equal "
                             f"division: {total} into {num_or_sections}")
        return list(torch.split(x, total // num_or_sections, dim=axis))
    sections = [int(s) for s in num_or_sections]
    if -1 in sections:
        known = builtins.sum(s for s in sections if s != -1)
        sections = [total - known if s == -1 else s for s in sections]
    return list(torch.split(x, sections, dim=axis))


def chunk(x, chunks: int, axis: int = 0):
    """numpy's ``array_split``: the first ``len % chunks`` parts one
    longer."""
    return list(torch.tensor_split(x, chunks, dim=axis))


def squeeze(x, axis=None):
    if axis is None:
        return torch.squeeze(x)
    return torch.squeeze(x, tuple(axis) if isinstance(axis, (list, tuple))
                         else axis)


def unsqueeze(x, axis):
    if isinstance(axis, (list, tuple)):
        for a in sorted(axis):
            x = torch.unsqueeze(x, a)
        return x
    return torch.unsqueeze(x, axis)


def expand(x, shape):
    shape = [x.shape[i - (len(shape) - x.dim())] if s == -1 else s
             for i, s in enumerate(shape)]
    return torch.broadcast_to(x, shape)


def expand_as(x, y):
    return torch.broadcast_to(x, y.shape)


def tile(x, repeat_times):
    return torch.tile(x, tuple(repeat_times))


def broadcast_to(x, shape):
    return torch.broadcast_to(x, tuple(shape))


def _axes(axis):
    return list(axis) if isinstance(axis, (list, tuple)) else [axis]


def flip(x, axis):
    return torch.flip(x, _axes(axis))


def roll(x, shifts, axis=None):
    return torch.roll(x, shifts, dims=axis)


def gather(x, index, axis: int = 0):
    """``jnp.take`` along ``axis``: index's shape replaces that axis."""
    axis = axis % x.dim()
    out = torch.index_select(x, axis, index.reshape(-1))
    return out.reshape(x.shape[:axis] + index.shape + x.shape[axis + 1:])


def gather_nd(x, index):
    return x[tuple(torch.movedim(index, -1, 0))]


def scatter(x, index, updates, overwrite: bool = True):
    return x.index_put((index,), updates, accumulate=not overwrite)


def scatter_nd_add(x, index, updates):
    return x.index_put(tuple(torch.movedim(index, -1, 0)), updates,
                       accumulate=True)


def index_select(x, index, axis: int = 0):
    return gather(x, index, axis)


def masked_select(x, mask):
    return x[mask]


def masked_fill(x, mask, value):
    return torch.where(mask, torch.as_tensor(value, dtype=x.dtype,
                                             device=x.device), x)


def index_put(x, indices, value, accumulate: bool = False):
    return x.index_put(tuple(indices), torch.as_tensor(
        value, dtype=x.dtype, device=x.device), accumulate=accumulate)


def where(condition, x=None, y=None):
    if x is None and y is None:
        return torch.where(condition)
    return torch.where(condition, x, y)


def take_along_axis(x, indices, axis: int):
    return torch.take_along_dim(x, indices, dim=axis)


def put_along_axis(x, indices, values, axis: int, reduce: str = "assign"):
    if reduce not in ("assign", "add"):
        raise ValueError(reduce)
    axis = axis % x.dim()
    shape = [indices.shape[d] if d == axis else x.shape[d]
             for d in range(x.dim())]
    indices = torch.broadcast_to(indices, shape)
    values = torch.broadcast_to(torch.as_tensor(
        values, dtype=x.dtype, device=x.device), shape)
    if reduce == "assign":
        return x.scatter(axis, indices, values)
    return x.scatter_add(axis, indices, values)


def slice(x, axes, starts, ends):
    sl = [builtins.slice(None)] * x.dim()
    for ax, st, en in zip(axes, starts, ends):
        sl[ax] = builtins.slice(st, en)
    return x[tuple(sl)]


def strided_slice(x, axes, starts, ends, strides):
    """Python slicing per axis; a negative stride walks backwards (a flip
    of the forward slice, torch slices take positive steps only)."""
    for ax, st, en, sd in zip(axes, starts, ends, strides):
        n = x.shape[ax]
        idx = torch.arange(n, device=x.device)[builtins.slice(st, en, sd)] \
            if sd > 0 else torch.as_tensor(
                list(range(n))[builtins.slice(st, en, sd)], dtype=torch.long,
                device=x.device)
        x = torch.index_select(x, ax, idx)
    return x


def cast(x, dtype):
    return x.to(dtypes.to_dtype(dtype))


def repeat_interleave(x, repeats, axis=None):
    return torch.repeat_interleave(x, repeats, dim=axis)


def unbind(x, axis: int = 0):
    return unstack(x, axis)


def moveaxis(x, source, destination):
    return torch.movedim(x, source, destination)


def swapaxes(x, axis1, axis2):
    return torch.swapaxes(x, axis1, axis2)


def as_complex(x):
    return torch.complex(x[..., 0], x[..., 1])


def as_real(x):
    return torch.stack([torch.real(x), torch.imag(x)], dim=-1)


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None):
    """Sorted unique values (over the flattened tensor, or whole slices
    along ``axis``), then as asked: each one's first index, the inverse
    map and the counts, in numpy's order."""
    vals, inverse, counts = torch.unique(x, sorted=True, return_inverse=True,
                                         return_counts=True, dim=axis)
    out = [vals]
    if return_index:
        n = x.numel() if axis is None else x.shape[axis]
        flat_inv = inverse.reshape(-1)
        first = torch.full((vals.shape[0] if axis is None
                            else vals.shape[axis],), n, dtype=torch.long,
                           device=x.device)
        out.append(first.scatter_reduce(
            0, flat_inv, torch.arange(n, device=x.device), "amin"))
    if return_inverse:
        out.append(inverse.reshape(-1) if axis is not None else inverse)
    if return_counts:
        out.append(counts)
    return out[0] if len(out) == 1 else tuple(out)


def rot90(x, k: int = 1, axes=(0, 1)):
    return torch.rot90(x, k, list(axes))


def _atleast(fn, xs):
    out = [fn(x) for x in xs]
    return out[0] if len(out) == 1 else out


def atleast_1d(*xs):
    return _atleast(torch.atleast_1d, xs)


def atleast_2d(*xs):
    return _atleast(torch.atleast_2d, xs)


def atleast_3d(*xs):
    return _atleast(torch.atleast_3d, xs)


def diagonal(x, offset: int = 0, axis1: int = 0, axis2: int = 1):
    return torch.diagonal(x, offset, axis1, axis2)


def diag_embed(x, offset: int = 0, dim1: int = -2, dim2: int = -1):
    """The last dim of ``x`` as the (offset) diagonal of new ``[n, n]``
    dims placed at ``dim1``, ``dim2``."""
    return torch.diag_embed(x, offset, dim1, dim2)


def fill_diagonal(x, value, offset: int = 0, wrap: bool = False):
    """A copy with the (offset) diagonal of the last two dims set to
    ``value``; ``wrap`` restarts the diagonal below the gap of a tall 2-D
    matrix (numpy's rule)."""
    h, w = x.shape[-2], x.shape[-1]
    out = x.clone()
    if wrap and x.dim() == 2 and offset == 0 and h > w:
        out.reshape(-1)[torch.arange(0, h * w, w + 1,
                                     device=x.device)] = value
        return out
    n = builtins.min(h - builtins.max(0, -offset),
                     w - builtins.max(0, offset))
    idx = torch.arange(n, device=x.device)
    out[..., idx + builtins.max(0, -offset),
        idx + builtins.max(0, offset)] = value
    return out


def index_add(x, index, axis: int, value):
    """x with ``value``'s slices added at ``index`` along ``axis``."""
    return x.index_add(axis, index, torch.as_tensor(value, dtype=x.dtype,
                                                    device=x.device))


def index_fill(x, index, axis: int, value):
    return x.index_fill(axis, index, value)


def reverse(x, axis):
    """Alias of flip (the reference keeps both names)."""
    return torch.flip(x, _axes(axis))


def crop(x, shape=None, offsets=None):
    """Take ``shape`` (-1: to the end) from ``offsets``."""
    if shape is None:
        return x
    offsets = offsets or [0] * x.dim()
    return x[tuple(builtins.slice(o, None if s == -1 else o + s)
                   for o, s in zip(offsets, shape))]


def unique_consecutive(x, return_inverse: bool = False,
                       return_counts: bool = False, axis=None):
    """Consecutive duplicates collapsed (over the flattened tensor, or
    whole slices along ``axis``); the inverse map is over the flattened
    positions (or the slices), as JAX's."""
    a = x.reshape(-1) if axis is None else torch.movedim(x, axis, 0)
    keep = torch.ones(a.shape[0], dtype=torch.bool, device=x.device)
    if a.shape[0] > 1:
        diff = a[1:] != a[:-1]
        keep[1:] = diff if axis is None else \
            diff.reshape(a.shape[0] - 1, -1).any(dim=1)
    out = a[keep] if axis is None else torch.movedim(a[keep], 0, axis)
    results = [out]
    if return_inverse:
        results.append(torch.cumsum(keep.long(), 0) - 1)
    if return_counts:
        pos = torch.nonzero(keep)[:, 0]
        results.append(torch.diff(pos, append=torch.tensor(
            [keep.shape[0]], device=x.device)))
    return results[0] if len(results) == 1 else tuple(results)


def masked_scatter(x, mask, value, name=None):
    """``value``'s elements, in row-major order, at the True positions of
    ``mask`` (broadcast to x)."""
    mask = torch.broadcast_to(mask.to(torch.bool), x.shape)
    return x.masked_scatter(mask, value.reshape(-1).to(x.dtype))
