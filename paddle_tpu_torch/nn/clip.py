"""Gradient clipping (``paddle_tpu/nn/clip.py`` counterpart).

:class:`ClipGradByGlobalNorm` scales every gradient by
``min(1, clip_norm / max(global_norm, 1e-12))``, the global norm taken in
float32 over all of them, and casts each back to its dtype — the
optimizer applies it before the update. :class:`ClipGradByNorm` does the
same with each gradient's own norm, :class:`ClipGradByValue` clamps each
element to ``[min, max]``. Gradients come as a dict ``{name: tensor}``
(None entries pass through) or a list.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "clip_grads_by_global_norm", "global_norm"]


def _leaves(grads):
    vals = grads.values() if isinstance(grads, Mapping) else grads
    return [g for g in vals if g is not None]


def global_norm(grads) -> torch.Tensor:
    """The L2 norm of all gradients together, float32."""
    leaves = _leaves(grads)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    sq = sum(torch.sum(torch.square(g.float())) for g in leaves)
    return torch.sqrt(sq)


def clip_grads_by_global_norm(grads, clip_norm: float,
                              norm: Optional[torch.Tensor] = None):
    n = global_norm(grads) if norm is None else norm
    scale = torch.clamp(clip_norm / torch.clamp(n, min=1e-12), max=1.0)

    def clip(g):
        return None if g is None else (g.float() * scale).to(g.dtype)

    return _each(clip, grads)


def _each(fn, grads):
    if isinstance(grads, Mapping):
        return {k: fn(g) for k, g in grads.items()}
    return [fn(g) for g in grads]


class ClipGradByGlobalNorm:
    def __init__(self, clip_norm: float, group_name: str = "default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def __call__(self, grads):
        return clip_grads_by_global_norm(grads, self.clip_norm)


class ClipGradByNorm:
    """Each gradient scaled by ``min(1, clip_norm / max(norm, 1e-12))`` of
    its own float32 L2 norm, cast back to its dtype."""

    def __init__(self, clip_norm: float):
        self.clip_norm = float(clip_norm)

    def __call__(self, grads):
        def clip(g):
            if g is None:
                return None
            g32 = g.float()
            n = torch.sqrt(torch.sum(torch.square(g32)))
            scale = torch.clamp(self.clip_norm / torch.clamp(n, min=1e-12),
                                max=1.0)
            return (g32 * scale).to(g.dtype)

        return _each(clip, grads)


class ClipGradByValue:
    """Each element clamped to ``[min, max]`` (``min`` defaults to
    ``-max``)."""

    def __init__(self, max: float, min: Optional[float] = None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, grads):
        return _each(lambda g: None if g is None else
                     torch.clamp(g, self.min, self.max), grads)
