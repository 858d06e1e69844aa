"""Random streams of the port (``paddle_tpu/core/random.py`` counterpart).

The JAX package keys its randomness by ``(seed, count)``: a global
:class:`Generator` folds a counter into the key of its seed, and a training
step installs :func:`rng_scope` with ``fold_in(base_key, step_count)`` so
that every draw of the step follows from the step's index. The port keeps
that structure with keys of its own: a key is a 63-bit integer derived from
``(seed, count)`` by a 64-bit mixer (:func:`fold_in`), not threefry's bits.
A draw seeds an explicit ``torch.Generator`` on the tensor's device from the
key (:func:`torch_generator`), so a mask depends only on the key, the shape
and the device, and a resumed run draws what an unbroken one draws.

``RNGStatesTracker`` (the tensor-parallel streams) is not ported: the port
runs on one device.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Tuple

import torch

__all__ = ["seed", "default_generator", "Generator", "rng_scope",
           "next_key", "get_rng_state", "set_rng_state", "make_key",
           "fold_in", "torch_generator", "draw_seed", "stream_position",
           "replay"]

_M64 = (1 << 64) - 1
_KEY_MASK = (1 << 63) - 1   # a torch.Generator takes any non-negative int64


def _mix64(x: int) -> int:
    """splitmix64's finalizer, a bijection of 64-bit integers."""
    x &= _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def make_key(seed_: int) -> int:
    """The key of a seed (``jax.random.key(seed)``)."""
    return _mix64(int(seed_) + 0x9E3779B97F4A7C15) & _KEY_MASK


def fold_in(key: int, data: int) -> int:
    """A new key from ``key`` and an integer (``jax.random.fold_in``)."""
    return _mix64(int(key) ^ _mix64(int(data) * 0x9E3779B97F4A7C15 +
                                    0x632BE59BD9B4E019)) & _KEY_MASK


class Generator:
    """Stateful key source for eager randomness: ``(seed, count)``."""

    def __init__(self, seed_: int = 0):
        self._lock = threading.Lock()
        self.manual_seed(seed_)

    def manual_seed(self, seed_: int) -> "Generator":
        with self._lock:
            self._seed = int(seed_)
            self._count = 0
        return self

    def next_key(self) -> int:
        with self._lock:
            self._count += 1
            count = self._count
        return fold_in(make_key(self._seed), count)

    def get_state(self) -> Tuple[int, int]:
        return (self._seed, self._count)

    def set_state(self, state) -> None:
        with self._lock:
            self._seed, self._count = int(state[0]), int(state[1])


_default_generator = Generator(0)


def default_generator() -> Generator:
    return _default_generator


def seed(seed_: int) -> Generator:
    """``paddle.seed``: reseed the global generator and numpy's global RNG
    (host-side shuffling derives from it)."""
    import numpy as _np
    _default_generator.manual_seed(seed_)
    _np.random.seed(int(seed_) % (2 ** 32))
    return _default_generator


def get_rng_state() -> Tuple[int, int]:
    return _default_generator.get_state()


def set_rng_state(state) -> None:
    _default_generator.set_state(state)


_scope = threading.local()


@contextlib.contextmanager
def rng_scope(key: int) -> Iterator[None]:
    """Draw every key inside from ``key``: the n-th :func:`next_key` in the
    scope is ``fold_in(key, n)``, whatever the global generator holds."""
    prev = getattr(_scope, "state", None)
    _scope.state = [int(key), 0]
    try:
        yield
    finally:
        _scope.state = prev


def next_key() -> int:
    """A fresh key: from the active :func:`rng_scope` if any, else from
    the global generator."""
    state = getattr(_scope, "state", None)
    if state is not None:
        state[1] += 1
        return fold_in(state[0], state[1])
    return _default_generator.next_key()


def stream_position() -> Tuple[str, int, int]:
    """Where the next :func:`next_key` would come from: ``("scope", key,
    count)`` inside an :func:`rng_scope`, else ``("global", seed, count)``
    of the global generator. :func:`replay` draws from it again."""
    state = getattr(_scope, "state", None)
    if state is not None:
        return ("scope", state[0], state[1])
    return ("global",) + _default_generator.get_state()


@contextlib.contextmanager
def replay(position: Tuple[str, int, int]) -> Iterator[None]:
    """Draw every key inside as the draws that followed ``position``
    (:func:`stream_position`) did, then put back the scope and the global
    generator as they were. Activation recompute re-runs a forward under
    it, so the recomputed dropout masks are the forward's: JAX's keys are
    values fixed at trace time, the port's come from these counters."""
    prev_scope = getattr(_scope, "state", None)
    prev_global = _default_generator.get_state()
    kind, a, b = position
    if kind == "scope":
        _scope.state = [int(a), int(b)]
    else:
        _scope.state = None
        _default_generator.set_state((a, b))
    try:
        yield
    finally:
        _scope.state = prev_scope
        _default_generator.set_state(prev_global)


def torch_generator(key: int, device=None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``key``."""
    gen = torch.Generator(device=torch.device(device or "cpu"))
    gen.manual_seed(int(key) & _KEY_MASK)
    return gen


def draw_seed(key: Optional[int] = None) -> int:
    """An int32 seed in ``[0, 2^31 - 1)`` from ``key`` (default: the next
    key), as the JAX package draws the attention-dropout seed with
    ``randint(next_key(), (1,), 0, 2**31 - 1)``. Drawn on the CPU: no
    device synchronisation."""
    key = next_key() if key is None else key
    return int(torch.randint(0, 2 ** 31 - 1, (1,),
                             generator=torch_generator(key)).item())
