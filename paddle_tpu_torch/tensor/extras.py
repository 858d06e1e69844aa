"""Tensor ops of Paddle's top level beyond the main modules
(``paddle_tpu/tensor/extras.py`` counterpart): take, tensordot, cdist, the
trapezoid family, views, broadcast helpers, randint_like, ..."""

from __future__ import annotations

import torch

from ..core.random import next_key, torch_generator

__all__ = ["take", "scatter_nd", "tensordot", "cdist", "count_nonzero",
           "sgn", "trapezoid", "cumulative_trapezoid", "unflatten",
           "vsplit", "randint_like", "frexp", "ldexp", "logaddexp",
           "broadcast_tensors", "broadcast_shape", "nanquantile", "polar",
           "as_strided", "view", "view_as", "unfold", "rank", "shape",
           "is_complex", "is_integer", "is_floating_point", "floor_mod",
           "renorm", "i0", "polygamma", "iinfo", "finfo",
           "set_printoptions"]


def take(x, index, mode: str = "raise", name=None):
    """Gather from x taken as 1-D. ``mode='clip'`` clamps to ``[0, n-1]``
    (no negative indexing); ``'raise'`` checks the bounds and ``'wrap'``
    wraps, both counting negatives from the end."""
    flat = x.reshape(-1)
    idx = torch.as_tensor(index, device=x.device)
    n = flat.shape[0]
    if mode == "wrap":
        idx = ((idx % n) + n) % n
    elif mode == "clip":
        return flat[torch.clamp(idx, 0, n - 1)]
    if mode == "raise" and idx.numel():
        lo, hi = int(idx.min()), int(idx.max())
        if lo < -n or hi >= n:
            raise IndexError(
                f"take(mode='raise'): index out of range for {n} elements "
                f"(got min {lo}, max {hi})")
    return flat[torch.where(idx < 0, idx + n, idx)]


def scatter_nd(index, updates, shape, name=None):
    """``zeros(shape)`` with ``updates`` added at ``index`` (duplicates
    accumulate)."""
    from .manipulation import scatter_nd_add
    out = torch.zeros(tuple(shape), dtype=updates.dtype,
                      device=updates.device)
    return scatter_nd_add(out, index, updates)


def tensordot(x, y, axes=2, name=None):
    return torch.tensordot(x, y, dims=axes)


def cdist(x, y, p: float = 2.0,
          compute_mode: str = "use_mm_for_euclid_dist_if_necessary",
          name=None):
    """Pairwise distances ``[..., M, D] x [..., N, D] -> [..., M, N]``.
    For p = 2 the matmul form ``x² + y² - 2xy`` in float32 unless
    ``compute_mode='donot_use_mm_for_euclid_dist'``; a zero distance has
    gradient 0."""
    def safe_sqrt(sq):
        positive = sq > 0
        return torch.where(positive, torch.sqrt(torch.where(positive, sq,
                                                            1.0)), 0.0)

    if p == 2.0 and compute_mode != "donot_use_mm_for_euclid_dist":
        x32, y32 = x.float(), y.float()
        x2 = (x32 * x32).sum(-1)[..., :, None]
        y2 = (y32 * y32).sum(-1)[..., None, :]
        xy = torch.einsum("...md,...nd->...mn", x32, y32)
        return safe_sqrt(torch.clamp_min(x2 + y2 - 2.0 * xy, 0.0))
    diff = x[..., :, None, :] - y[..., None, :, :]
    if p == 2.0:
        return safe_sqrt((diff * diff).sum(-1))
    if p == float("inf"):
        return diff.abs().amax(-1)
    return (diff.abs() ** p).sum(-1) ** (1.0 / p)


def count_nonzero(x, axis=None, keepdim: bool = False, name=None):
    dims = tuple(axis) if isinstance(axis, (list, tuple)) else axis
    out = torch.count_nonzero(x, dim=dims)
    if keepdim:
        full = range(x.dim()) if dims is None else \
            ([dims] if isinstance(dims, int) else dims)
        for d in sorted(a % x.dim() for a in full):
            out = out.unsqueeze(d)
    return out


def sgn(x, name=None):
    """sign for real; x/|x| for complex (0 at 0)."""
    return torch.sgn(x)


def trapezoid(y, x=None, dx=None, axis: int = -1, name=None):
    if x is not None:
        return torch.trapezoid(y, x=x, dim=axis)
    return torch.trapezoid(y, dx=1.0 if dx is None else dx, dim=axis)


def cumulative_trapezoid(y, x=None, dx=None, axis: int = -1, name=None):
    y = torch.movedim(y, axis, -1)
    if x is not None:
        xx = torch.movedim(x, axis, -1) if x.dim() == y.dim() else x
        widths = torch.diff(xx, dim=-1)
    else:
        widths = 1.0 if dx is None else dx
    avg = (y[..., 1:] + y[..., :-1]) * 0.5
    return torch.movedim(torch.cumsum(avg * widths, dim=-1), -1, axis)


def unflatten(x, axis: int, shape, name=None):
    """One axis split into ``shape`` (one -1 entry is inferred)."""
    shape = list(shape)
    if shape.count(-1) > 1:
        raise ValueError("only one dimension can be -1")
    return torch.unflatten(x, axis, shape)


def vsplit(x, num_or_sections, name=None):
    """Split along axis 0: an int into equal parts, a list into parts of
    those sizes (Paddle's split, not numpy's indices)."""
    if x.dim() < 2:
        raise ValueError(f"vsplit expects ndim >= 2, got {x.dim()}")
    if isinstance(num_or_sections, (list, tuple)):
        return list(torch.split(x, list(num_or_sections), dim=0))
    if x.shape[0] % num_or_sections:
        raise ValueError(f"array split does not result in an equal "
                         f"division: {x.shape[0]} into {num_or_sections}")
    return list(torch.split(x, x.shape[0] // num_or_sections, dim=0))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    """Integers in ``[low, high)`` of x's shape, from the port's key
    stream (not threefry's bits)."""
    if high is None:
        low, high = 0, low
    out = torch.randint(low, high, tuple(x.shape), device=x.device,
                        generator=torch_generator(next_key(), x.device))
    return out.to(dtype or x.dtype)


def frexp(x, name=None):
    """``(mantissa, exponent)`` with ``x = m * 2**e``, ``0.5 <= |m| < 1``,
    in float32 and int32."""
    return tuple(torch.frexp(x.float()))


def ldexp(x, y, name=None):
    return x * torch.exp2(y.float())


def logaddexp(x, y, name=None):
    return torch.logaddexp(x, y)


def broadcast_tensors(inputs, name=None):
    return list(torch.broadcast_tensors(*inputs))


def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def nanquantile(x, q, axis=None, keepdim: bool = False,
                interpolation: str = "linear", name=None):
    x = x.float()
    q = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    if axis is None:
        out = torch.nanquantile(x.reshape(-1), q, dim=0,
                                interpolation=interpolation)
        return out.reshape(q.shape + (1,) * x.dim()) if keepdim else out
    return torch.nanquantile(x, q, dim=axis, keepdim=keepdim,
                             interpolation=interpolation)


def polar(abs, angle, name=None):
    return torch.polar(abs, angle)


def as_strided(x, shape, stride, offset: int = 0, name=None):
    """The strided view's values (a copy): element ``offset + Σ i_d s_d``
    of the flattened x."""
    flat = x.reshape(-1)
    idx = torch.full((), offset, dtype=torch.long, device=x.device)
    for dim, st in zip(shape, stride):
        idx = idx[..., None] + torch.arange(dim, device=x.device) * st
    return flat[idx]


def view(x, shape_or_dtype, name=None):
    """A reshape, or a reinterpretation as another dtype with the last dim
    resized by the width ratio (Paddle's ``view``)."""
    if isinstance(shape_or_dtype, (list, tuple)):
        return x.reshape(tuple(shape_or_dtype))
    from ..core.dtype import to_dtype
    return x.view(to_dtype(shape_or_dtype))


def view_as(x, other, name=None):
    return x.reshape(other.shape)


def unfold(x, axis: int, size: int, step: int, name=None):
    """Sliding windows along ``axis``, the window as a trailing dim."""
    return x.unfold(axis, size, step)


def rank(x, name=None):
    return torch.tensor(x.dim(), device=x.device)


def shape(x, name=None):
    return torch.tensor(tuple(x.shape), dtype=torch.int32, device=x.device)


def is_complex(x) -> bool:
    return x.is_complex()


def is_integer(x) -> bool:
    return not (x.is_floating_point() or x.is_complex() or
                x.dtype == torch.bool)


def is_floating_point(x) -> bool:
    return x.is_floating_point()


def floor_mod(x, y, name=None):
    return torch.remainder(x, y)


def renorm(x, p: float, axis: int, max_norm: float, name=None):
    """Per-slice norm clipping along ``axis``."""
    axes = tuple(i for i in range(x.dim()) if i != axis % x.dim())
    norms = (x.abs() ** p).sum(dim=axes, keepdim=True) ** (1.0 / p)
    factor = torch.where(norms > max_norm,
                         max_norm / torch.clamp_min(norms, 1e-12), 1.0)
    return x * factor


def i0(x, name=None):
    return torch.special.i0(x)


def polygamma(x, n: int, name=None):
    return torch.special.polygamma(n, x.float())


from ..core.dtype import finfo, iinfo  # noqa: E402


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """``paddle.set_printoptions``: how torch prints tensors (JAX's sets
    numpy's, through which its arrays print)."""
    torch.set_printoptions(precision=precision, threshold=threshold,
                           edgeitems=edgeitems, linewidth=linewidth,
                           sci_mode=sci_mode)

