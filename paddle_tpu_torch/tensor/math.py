"""Elementwise and reduction math (``paddle_tpu/tensor/math.py``
counterpart). Integer and boolean sums are int64, as torch and Paddle
make them (int32 in the JAX package, whose 64-bit types are off)."""

from __future__ import annotations

import math as _math

import torch

from ..core import dtype as dtypes
from .creation import _dims

__all__ = [
    "gammainc", "gammaincc", "igamma", "igammac", "multigammaln",
    "add", "subtract", "multiply", "divide", "floor_divide", "mod", "pow",
    "sqrt", "rsqrt", "square", "abs", "exp", "expm1", "log", "log2", "log10",
    "log1p", "sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh",
    "tanh", "floor", "ceil", "round", "trunc", "sign", "neg", "reciprocal",
    "maximum", "minimum", "fmax", "fmin", "clip", "sum", "mean", "max", "min",
    "prod", "cumsum", "cumprod", "logsumexp", "logcumsumexp", "isnan", "isinf",
    "isfinite", "erf", "erfinv", "lerp", "addmm", "inner", "outer", "trace",
    "kron", "nan_to_num", "amax", "amin", "diff", "angle", "frac", "rad2deg",
    "deg2rad", "gcd", "lcm", "heaviside", "digamma", "lgamma", "multiplex",
    "stanh", "atan2", "logit", "scale", "increment",
    "acosh", "asinh", "atanh", "conj", "real", "imag", "complex",
    "i0", "i0e", "i1", "i1e", "polygamma", "nextafter", "remainder",
    "cummax", "cummin", "renorm", "add_n", "copysign", "ldexp", "hypot",
]

add = torch.add
subtract = torch.subtract
multiply = torch.multiply
divide = torch.divide
floor_divide = torch.floor_divide
mod = torch.remainder          # Python's % (the divisor's sign), as jnp.mod
pow = torch.pow
sqrt = torch.sqrt
rsqrt = torch.rsqrt
square = torch.square
abs = torch.abs
exp = torch.exp
expm1 = torch.expm1
log = torch.log
log2 = torch.log2
log10 = torch.log10
log1p = torch.log1p
sin = torch.sin
cos = torch.cos
tan = torch.tan
asin = torch.asin
acos = torch.acos
atan = torch.atan
atan2 = torch.atan2
sinh = torch.sinh
cosh = torch.cosh
tanh = torch.tanh
floor = torch.floor
ceil = torch.ceil
round = torch.round            # half to even, as jnp.round
trunc = torch.trunc
sign = torch.sign
neg = torch.neg
reciprocal = torch.reciprocal
maximum = torch.maximum
minimum = torch.minimum
fmax = torch.fmax
fmin = torch.fmin
isnan = torch.isnan
isinf = torch.isinf
isfinite = torch.isfinite
erf = torch.special.erf
erfinv = torch.special.erfinv
digamma = torch.special.digamma
lgamma = torch.lgamma
kron = torch.kron
inner = torch.inner
outer = torch.outer
heaviside = torch.heaviside
gcd = torch.gcd
lcm = torch.lcm
angle = torch.angle


def diff(x, n: int = 1, axis: int = -1, prepend=None, append=None):
    return torch.diff(x, n=n, dim=axis, prepend=prepend, append=append)


def clip(x, min=None, max=None):
    return torch.clamp(x, min, max)


def sum(x, axis=None, dtype=None, keepdim: bool = False):
    return torch.sum(x, dim=_dims(x, axis), keepdim=keepdim,
                     dtype=dtypes.to_dtype(dtype) if dtype else None)


def mean(x, axis=None, keepdim: bool = False):
    return torch.mean(x, dim=_dims(x, axis), keepdim=keepdim)


def max(x, axis=None, keepdim: bool = False):
    return torch.amax(x, dim=_dims(x, axis), keepdim=keepdim)


def min(x, axis=None, keepdim: bool = False):
    return torch.amin(x, dim=_dims(x, axis), keepdim=keepdim)


amax = max
amin = min


def prod(x, axis=None, keepdim: bool = False, dtype=None):
    dtype = dtypes.to_dtype(dtype) if dtype else None
    dims = _dims(x, axis)
    dims = sorted((d % x.dim() for d in dims), reverse=True) \
        if isinstance(dims, tuple) else [dims]
    out = x if dtype is None else x.to(dtype)
    for d in dims:
        out = torch.prod(out, dim=d, keepdim=keepdim)
    return out


def cumsum(x, axis=None, dtype=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.cumsum(x, dim=axis,
                        dtype=dtypes.to_dtype(dtype) if dtype else None)


def cumprod(x, dim=None, dtype=None):
    if dim is None:
        x, dim = x.reshape(-1), 0
    return torch.cumprod(x, dim=dim,
                         dtype=dtypes.to_dtype(dtype) if dtype else None)


def logsumexp(x, axis=None, keepdim: bool = False):
    return torch.logsumexp(x, dim=_dims(x, axis), keepdim=keepdim)


def logcumsumexp(x, axis=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.logcumsumexp(x, dim=axis)


def lerp(x, y, weight):
    return x + weight * (y - x)


def addmm(input, x, y, beta: float = 1.0, alpha: float = 1.0):
    return beta * input + alpha * torch.matmul(x, y)


def trace(x, offset: int = 0, axis1: int = 0, axis2: int = 1):
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)


def nan_to_num(x, nan: float = 0.0, posinf=None, neginf=None):
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


def frac(x):
    return x - torch.trunc(x)


def rad2deg(x):
    return torch.rad2deg(x)


def deg2rad(x):
    return torch.deg2rad(x)


def multiplex(inputs, index):
    stacked = torch.stack(list(inputs), dim=0)
    idx = index.reshape(-1)
    return stacked[idx, torch.arange(stacked.shape[1], device=idx.device)]


def stanh(x, scale_a: float = 0.67, scale_b: float = 1.7159):
    return scale_b * torch.tanh(scale_a * x)


def logit(x, eps=None):
    if eps is not None:
        x = torch.clamp(x, eps, 1 - eps)
    return torch.log(x / (1 - x))


def scale(x, scale: float = 1.0, bias: float = 0.0,
          bias_after_scale: bool = True, act=None):
    return x * scale + bias if bias_after_scale else (x + bias) * scale


def increment(x, value: float = 1.0):
    return x + value


acosh = torch.acosh
asinh = torch.asinh
atanh = torch.atanh
nextafter = torch.nextafter
remainder = torch.remainder    # paddle remainder == Python's %
copysign = torch.copysign
ldexp = torch.ldexp
hypot = torch.hypot


def conj(x):
    return torch.conj_physical(x)


def real(x):
    return torch.real(x) if x.is_complex() else x


def imag(x):
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


def complex(real, imag):
    """A complex tensor from its real and imaginary parts."""
    return torch.complex(real, imag)


def i0(x):
    return torch.special.i0(x)


def i0e(x):
    return torch.special.i0e(x)


def i1(x):
    return torch.special.i1(x)


def i1e(x):
    return torch.special.i1e(x)


def polygamma(x, n: int):
    """The n-th derivative of digamma."""
    return torch.special.polygamma(n, x)


def _cum_extreme(x, axis, better):
    """cummax/cummin as ``(values, indices)``: the running extreme and the
    first position that reached it (a tie keeps the earlier index, as
    JAX's strict comparison does)."""
    if axis is None:
        x, axis = x.reshape(-1), 0
    xm = torch.movedim(x, axis, 0)
    vals = (torch.cummax if better == "max" else torch.cummin)(
        xm, dim=0).values
    n = xm.shape[0]
    pos = torch.arange(n, device=x.device).reshape((n,) + (1,) *
                                                   (xm.dim() - 1))
    strict = torch.cat([torch.ones_like(xm[:1], dtype=torch.bool),
                        (xm[1:] > vals[:-1]) if better == "max"
                        else (xm[1:] < vals[:-1])], 0)
    idxs = torch.cummax(torch.where(strict, pos, 0), dim=0).values
    return torch.movedim(vals, 0, axis), torch.movedim(idxs, 0, axis)


def cummax(x, axis=None):
    return _cum_extreme(x, axis, "max")


def cummin(x, axis=None):
    return _cum_extreme(x, axis, "min")


def renorm(x, p: float, axis: int, max_norm: float):
    """Sub-tensors along ``axis`` scaled to p-norm <= max_norm."""
    reduce_axes = tuple(i for i in range(x.dim()) if i != axis)
    norms = torch.sum(torch.abs(x) ** p, dim=reduce_axes,
                      keepdim=True) ** (1.0 / p)
    factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7), 1.0)
    return x * factor


def add_n(inputs):
    """The elementwise sum of a list of tensors."""
    if not isinstance(inputs, (list, tuple)):
        return inputs
    out = inputs[0]
    for t in inputs[1:]:
        out = out + t
    return out


def gammainc(x, y, name=None):
    """Regularized lower incomplete gamma P(x, y)."""
    return torch.special.gammainc(x, y)


def gammaincc(x, y, name=None):
    """Regularized upper incomplete gamma Q(x, y)."""
    return torch.special.gammaincc(x, y)


def igamma(x, y, name=None):
    """``paddle.igamma``: the regularized upper incomplete gamma."""
    return gammaincc(x, y)


def igammac(x, y, name=None):
    """``paddle.igammac``: the regularized lower incomplete gamma."""
    return gammainc(x, y)


def multigammaln(x, p: int, name=None):
    """ln Γ_p(x) = p(p-1)/4 ln π + Σ_{i=1..p} ln Γ(x + (1-i)/2)."""
    dt = x.dtype if x.is_floating_point() else torch.float32
    i = torch.arange(1, p + 1, dtype=dt, device=x.device)
    xf = x.to(dt)
    return (p * (p - 1) / 4.0) * _math.log(_math.pi) + \
        torch.sum(torch.lgamma(xf[..., None] + (1.0 - i) / 2.0), dim=-1)

