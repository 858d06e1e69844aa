"""Bucketed shapes for ragged serving traffic.

A copy of ``paddle_tpu/serving/buckets.py`` (numpy only; the port imports
nothing of the JAX package). In the port the buckets keep the prefill and
decode steps at a small set of shapes, as the JAX engine's compile budget
needs them; the reasoning below is the reference's.

XLA compiles one executable per abstract input signature, and real
serving traffic is ragged: every distinct prompt length or batch width
would pay a full compile (the recompile churn the O001 sentinel exists
to catch). The fix is the standard one (vLLM / TPU serving stacks):
register a small, fixed set of shape buckets, pad every dispatch up to
its bucket, and the executable count is capped at ``len(buckets)`` no
matter what the traffic looks like. Padding work is bounded by the
bucket spacing (< 2x for the power-of-two ladder) and the padded tail is
masked out of attention by per-sequence lengths.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["BucketSet", "pow2_buckets", "pad_axis"]


def pow2_buckets(lo: int, hi: int) -> Tuple[int, ...]:
    """Power-of-two ladder covering [lo, hi]: the default bucket set
    (≤ log2(hi/lo)+1 executables, ≤ 2x padding waste)."""
    if lo < 1 or hi < lo:
        raise ValueError(f"bad bucket range [{lo}, {hi}]")
    out: List[int] = []
    b = 1
    while b < lo:
        b *= 2
    while b < hi:
        out.append(b)
        b *= 2
    out.append(b)
    return tuple(out)


class BucketSet:
    """A registered, sorted set of sizes with a fit-up policy.

    ``grow=False`` (the serving engine): sizes past the largest bucket
    are a hard error — the compile budget is a promise. ``grow=True``
    (the generic AOT predictor): unseen large sizes extend the ladder by
    powers of two, so the executable count stays logarithmic in the
    largest size ever seen rather than linear in distinct sizes.
    """

    def __init__(self, sizes: Iterable[int], grow: bool = False):
        uniq = sorted({int(s) for s in sizes})
        if not uniq or uniq[0] < 1:
            raise ValueError(f"bucket sizes must be positive: {uniq}")
        self._sizes = uniq
        self.grow = grow

    @property
    def sizes(self) -> List[int]:
        return list(self._sizes)

    def __len__(self) -> int:
        return len(self._sizes)

    def __contains__(self, n: int) -> bool:
        return n in self._sizes

    def fit(self, n: int) -> int:
        """Smallest registered bucket >= n. In ``grow`` mode the set IS
        the power-of-two ladder, materialized rung by rung as sizes are
        seen — fit returns the next power of two >= n (registering it),
        so padding waste stays < 2x and distinct buckets stay
        logarithmic."""
        n = int(n)
        if n < 1:
            raise ValueError(f"size must be positive, got {n}")
        if self.grow:
            b = 1
            while b < n:
                b *= 2
            if b not in self._sizes:
                self._sizes.append(b)
                self._sizes.sort()
            return b
        for s in self._sizes:
            if s >= n:
                return s
        raise ValueError(
            f"size {n} exceeds the largest registered bucket "
            f"{self._sizes[-1]} (buckets: {self._sizes})")

    def __repr__(self) -> str:
        return f"BucketSet({self._sizes}, grow={self.grow})"


def pad_axis(arr: np.ndarray, axis: int, size: int,
             fill=0) -> np.ndarray:
    """Pad one axis of a host array up to ``size`` with ``fill`` (no-op
    when already there)."""
    arr = np.asarray(arr)
    cur = arr.shape[axis]
    if cur == size:
        return arr
    if cur > size:
        raise ValueError(f"axis {axis} is {cur}, larger than bucket {size}")
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, size - cur)
    return np.pad(arr, pad, constant_values=fill)
