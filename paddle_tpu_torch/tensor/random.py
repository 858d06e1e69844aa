"""Random ops (``paddle_tpu/tensor/random.py`` counterpart).

Each call draws a key from the port's stream (:mod:`..core.random`: the
global generator, or the active ``rng_scope``) and samples with a
``torch.Generator`` seeded from it on the tensor's device, so the same
``seed`` gives the same draws. The bits are not threefry's: a draw matches
JAX's in shape, dtype, range and distribution, not in value. ``key`` takes
a key of the port's stream.
"""

from __future__ import annotations

import torch

from ..core import dtype as dtypes
from ..core.random import make_key, next_key, torch_generator
from .creation import _dev, _dt, _shape

__all__ = ["rand", "randn", "randint", "uniform", "normal", "randperm",
           "bernoulli", "multinomial", "standard_normal", "poisson",
           "shuffle"]


def _gen(key, device):
    return torch_generator(next_key() if key is None else key, device)


def poisson(x, key=None):
    return torch.poisson(x, generator=_gen(key, x.device)).to(x.dtype)


def rand(shape, dtype=None, key=None):
    dev = _dev()
    return torch.rand(_shape(shape), dtype=_dt(dtype), device=dev,
                      generator=_gen(key, dev))


def uniform(shape, dtype=None, min: float = -1.0, max: float = 1.0,
            seed=None, key=None):
    if seed is not None:
        key = make_key(seed)
    u = rand(shape, dtype, key)
    return u * (max - min) + min


def randn(shape, dtype=None, key=None):
    dev = _dev()
    return torch.randn(_shape(shape), dtype=_dt(dtype), device=dev,
                       generator=_gen(key, dev))


standard_normal = randn


def normal(mean: float = 0.0, std: float = 1.0, shape=None, key=None):
    if shape is None:
        raise ValueError("normal needs a shape")
    return mean + std * randn(shape, key=key)


def randint(low: int = 0, high=None, shape=(1,), dtype="int64", key=None):
    if high is None:
        low, high = 0, low
    dev = _dev()
    return torch.randint(low, high, _shape(shape), device=dev,
                         generator=_gen(key, dev)).to(
                             dtypes.to_dtype(dtype))


def randperm(n: int, dtype="int64", key=None):
    dev = _dev()
    return torch.randperm(n, device=dev, generator=_gen(key, dev)).to(
        dtypes.to_dtype(dtype))


def bernoulli(x, key=None):
    return torch.bernoulli(x, generator=_gen(key, x.device))


def multinomial(x, num_samples: int = 1, replacement: bool = False,
                key=None):
    """Category indices drawn with the probabilities ``x`` (its last axis;
    one or two dims)."""
    return torch.multinomial(x, num_samples, replacement=replacement,
                             generator=_gen(key, x.device))


def shuffle(x, axis: int = 0, key=None):
    perm = torch.randperm(x.shape[axis], device=x.device,
                          generator=_gen(key, x.device))
    return torch.index_select(x, axis, perm)
