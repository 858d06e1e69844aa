"""Weight initializers of the port (``paddle_tpu/nn/initializer.py``
counterpart).

The same classes, arguments and distributions as the JAX package. An
initializer is called as ``init(shape, dtype=None, key=None, device=None)``
and returns a tensor of ``shape`` on ``device``; a random one draws from an
explicit ``torch.Generator`` on that device seeded from ``key`` (by default
the next key of :mod:`paddle_tpu_torch.core.random`'s stream), so a draw
depends only on the key, the shape and the device. The bits are the port's
own, not threefry's. Shapes follow Paddle's layouts, as in JAX: a 2-D shape
is ``[in, out]`` (a Linear weight), a conv weight ``[out, in, *kernel]``
(:func:`_fan_in_out`).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.random import next_key, torch_generator

__all__ = [
    "Orthogonal", "Dirac", "Bilinear", "set_global_initializer",
    "get_global_initializer", "Initializer", "Constant", "Normal",
    "TruncatedNormal", "Uniform", "XavierNormal", "XavierUniform",
    "KaimingNormal", "KaimingUniform", "Assign", "calculate_gain",
]


def calculate_gain(nonlinearity: str, param=None) -> float:
    recipes = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
        "conv3d": 1.0, "tanh": 5.0 / 3, "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(
            2.0 / (1 + (param if param is not None else 0.01) ** 2)),
        "selu": 3.0 / 4,
    }
    if nonlinearity not in recipes:
        raise ValueError(f"Unsupported nonlinearity {nonlinearity!r}")
    return recipes[nonlinearity]


def _fan_in_out(shape: Sequence[int]):
    shape = tuple(shape)
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        # Paddle's Linear layout [in_features, out_features]
        return shape[0], shape[1]
    # conv weights [out_c, in_c, *k]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


def _to_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a name (``"float32"``,
    ``"bfloat16"``, ...) or None (torch's default, float32)."""
    if dtype is None:
        return torch.get_default_dtype()
    if isinstance(dtype, torch.dtype):
        return dtype
    out = getattr(torch, str(dtype), None)
    if not isinstance(out, torch.dtype):
        raise TypeError(f"not a dtype: {dtype!r}")
    return out


class Initializer:
    def __call__(self, shape, dtype=None, key: Optional[int] = None,
                 device=None) -> torch.Tensor:
        if key is None:
            key = next_key()
        device = torch.device(device or "cpu")
        return self._init(tuple(int(s) for s in shape), _to_dtype(dtype),
                          key, device)

    def _init(self, shape, dtype, key, device):
        raise NotImplementedError

    @staticmethod
    def _randn(shape, key, device) -> torch.Tensor:
        return torch.randn(shape, generator=torch_generator(key, device),
                           device=device)

    @staticmethod
    def _rand(shape, key, device, low, high) -> torch.Tensor:
        u = torch.rand(shape, generator=torch_generator(key, device),
                       device=device)
        return low + (high - low) * u


class Constant(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def _init(self, shape, dtype, key, device):
        return torch.full(shape, self.value, dtype=dtype, device=device)


class Normal(Initializer):
    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean, self.std = mean, std

    def _init(self, shape, dtype, key, device):
        return (self.mean + self.std * self._randn(shape, key, device)
                ).to(dtype)


class TruncatedNormal(Initializer):
    """``mean + std * x``, x a standard normal truncated to ``[a, b]``,
    drawn by the inverse CDF of a uniform over ``[Phi(a), Phi(b)]`` as
    ``jax.random.truncated_normal`` draws it."""

    def __init__(self, mean: float = 0.0, std: float = 1.0, a: float = -2.0,
                 b: float = 2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def _init(self, shape, dtype, key, device):
        lo, hi = (math.erf(t / math.sqrt(2.0)) for t in (self.a, self.b))
        u = self._rand(shape, key, device, lo, hi)
        x = torch.clamp(math.sqrt(2.0) * torch.erfinv(u), self.a, self.b)
        return (self.mean + self.std * x).to(dtype)


class Uniform(Initializer):
    def __init__(self, low: float = -1.0, high: float = 1.0):
        self.low, self.high = low, high

    def _init(self, shape, dtype, key, device):
        return self._rand(shape, key, device, self.low, self.high).to(dtype)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain: float = 1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _init(self, shape, dtype, key, device):
        fi, fo = _fan_in_out(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return (std * self._randn(shape, key, device)).to(dtype)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain: float = 1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _init(self, shape, dtype, key, device):
        fi, fo = _fan_in_out(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return self._rand(shape, key, device, -limit, limit).to(dtype)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope: float = 0.0,
                 nonlinearity: str = "relu"):
        self.fan_in, self.negative_slope = fan_in, negative_slope
        self.nonlinearity = nonlinearity

    def _init(self, shape, dtype, key, device):
        fi, _ = _fan_in_out(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        std = gain / math.sqrt(max(fi, 1))
        return (std * self._randn(shape, key, device)).to(dtype)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope: float = 0.0,
                 nonlinearity: str = "relu"):
        self.fan_in, self.negative_slope = fan_in, negative_slope
        self.nonlinearity = nonlinearity

    def _init(self, shape, dtype, key, device):
        fi, _ = _fan_in_out(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        limit = gain * math.sqrt(3.0 / max(fi, 1))
        return self._rand(shape, key, device, -limit, limit).to(dtype)


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def _init(self, shape, dtype, key, device):
        value = self.value
        if isinstance(value, torch.Tensor):
            arr = value.detach().to(device=device, dtype=dtype)
        else:
            arr = torch.as_tensor(np.asarray(value), dtype=dtype,
                                  device=device)
        if tuple(arr.shape) != tuple(shape):
            arr = arr.reshape(shape)
        return arr.clone()


class Orthogonal(Initializer):
    """ref initializer/orthogonal.py: QR-orthogonal init (gain-scaled)."""

    def __init__(self, gain: float = 1.0, name=None):
        self.gain = gain

    def _init(self, shape, dtype, key, device):
        rows = shape[0]
        cols = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        flat = self._randn((max(rows, cols), min(rows, cols)), key, device)
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        return (self.gain * q[:rows, :cols]).reshape(shape).to(dtype)


class Dirac(Initializer):
    """ref initializer/dirac.py: identity-preserving conv init (channel i
    passes through at the kernel centre)."""

    def __init__(self, groups: int = 1, name=None):
        self.groups = groups

    def _init(self, shape, dtype, key, device):
        out = np.zeros(shape, np.float32)
        oc, ic = shape[0], shape[1]
        centre = tuple(s // 2 for s in shape[2:])
        per = max(oc // self.groups, 1)
        for g in range(self.groups):
            for i in range(min(per, ic)):
                if g * per + i < oc:
                    out[(g * per + i, i) + centre] = 1.0
        return torch.from_numpy(out).to(device=device, dtype=dtype)


class Bilinear(Initializer):
    """ref initializer/Bilinear: upsampling-kernel init for transposed
    convolutions."""

    def _init(self, shape, dtype, key, device):
        kh, kw = shape[-2], shape[-1]
        f_h, f_w = (kh + 1) // 2, (kw + 1) // 2
        c_h = f_h - 1 if kh % 2 == 1 else f_h - 0.5
        c_w = f_w - 1 if kw % 2 == 1 else f_w - 0.5
        og = np.ogrid[:kh, :kw]
        filt = (1 - np.abs(og[0] - c_h) / f_h) * \
               (1 - np.abs(og[1] - c_w) / f_w)
        out = np.zeros(shape, np.float32)
        out[...] = filt
        return torch.from_numpy(out).to(device=device, dtype=dtype)


_global_initializer = {"weight": None, "bias": None}


def set_global_initializer(weight_init, bias_init=None):
    """ref initializer/set_global_initializer: defaults consulted by
    ``create_parameter`` when a layer supplies none."""
    _global_initializer["weight"] = weight_init
    _global_initializer["bias"] = bias_init


def get_global_initializer(kind: str = "weight"):
    return _global_initializer.get(kind)
