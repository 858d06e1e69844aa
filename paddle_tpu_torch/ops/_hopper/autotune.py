"""Kernel autotune harness with a persistent on-disk cache.

Port of ``paddle_tpu/ops/_pallas/autotune.py``. A measured choice (a
kernel's block configuration, the serving engine's draft depth) is stored
in a JSON file keyed by ``(kernel, device, key)`` and read back before any
static table. The differences from the JAX module:

- the device part of the key is the GPU's name as
  ``torch.cuda.get_device_name()`` gives it, spaces as ``_``
  (``NVIDIA_H100_80GB_HBM3``), and ``"cpu"`` without CUDA, where JAX keys
  by the TPU's ``device_kind``;
- :func:`autotune` times each candidate between CUDA events on the card
  (a plain wall clock, after a synchronising call, on the CPU), where JAX
  reads the device time out of a profiler trace;
- the default file is ``~/.cache/paddle_tpu_torch/autotune.json``;
  ``FLAGS_kernel_autotune_cache_path`` overrides it, as in JAX.

The cache only ever holds a choice: a file that cannot be written is
skipped (``save`` swallows ``OSError``, as JAX's does) and an unreadable
one reads as empty. Entries of another ``CACHE_SCHEMA`` are ignored.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from ...core import flags as _flags

__all__ = ["AutotuneCache", "get_cache", "autotune", "chip_kind",
           "CACHE_SCHEMA"]

# Bumped when the measurement methodology changes; entries from older
# schemes are ignored. 2 is JAX's number, kept so the two files agree on
# what an entry is.
CACHE_SCHEMA = 2


def chip_kind() -> str:
    """The device part of a cache key: the current GPU's name with spaces
    as ``_``, or ``"cpu"`` when CUDA is absent."""
    if not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name().replace(" ", "_")


def _default_path() -> str:
    p = str(_flags.flag("kernel_autotune_cache_path") or "")
    if p:
        return p
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "paddle_tpu_torch", "autotune.json")


class AutotuneCache:
    """(kernel, device, key) -> config, persisted as JSON."""

    def __init__(self, path: Optional[str] = None):
        self.path = path or _default_path()
        self._data: Dict[str, Any] = {}
        self._loaded = False

    def _key(self, kernel: str, key, device: Optional[str] = None) -> str:
        return f"{kernel}|{device or chip_kind()}|{key}"

    def load(self) -> None:
        if self._loaded:
            return
        self._loaded = True
        try:
            with open(self.path) as f:
                self._data = json.load(f)
        except (OSError, ValueError):
            self._data = {}

    def save(self) -> None:
        """Write the file atomically (a temporary file, then
        ``os.replace``)."""
        try:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self._data, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except OSError:
            pass  # the cache holds a choice; never fail the program

    def get(self, kernel: str, key, device: Optional[str] = None
            ) -> Optional[Any]:
        """The config stored for ``kernel`` and ``key`` on ``device`` (the
        device part of the key; default :func:`chip_kind`), or None."""
        if not _flags.flag("kernel_autotune"):
            return None
        self.load()
        ent = self._data.get(self._key(kernel, key, device))
        if not ent or ent.get("schema") != CACHE_SCHEMA:
            return None
        return ent["config"]

    def put(self, kernel: str, key, config, measured_ms: float,
            device: Optional[str] = None) -> None:
        self.load()
        self._data[self._key(kernel, key, device)] = {
            "config": config,
            "measured_ms": round(measured_ms, 4),
            "tuned_at": time.strftime("%Y-%m-%d %H:%M:%S"),
            "schema": CACHE_SCHEMA,
        }
        self.save()

    def stats(self) -> Dict[str, Any]:
        self.load()
        return dict(self._data)


_cache: Optional[AutotuneCache] = None


def get_cache() -> AutotuneCache:
    """The process-wide cache, made at first use from the flag's path."""
    global _cache
    if _cache is None:
        _cache = AutotuneCache()
    return _cache


def _sync_result(r) -> None:
    """Wait for ``r``'s work: the first tensor found in it."""
    stack = [r]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
            return
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))


def _measure(run: Callable[[], Any], warmup: int, iters: int,
             host: bool = False) -> float:
    """Mean milliseconds of one ``run()``: between CUDA events on the
    card, on the host clock around synchronised calls on the CPU (or with
    ``host``, for work that runs on the CPU of a machine with a card)."""
    for _ in range(max(warmup, 1)):
        r = run()
    _sync_result(r)
    if not host and torch.cuda.is_available() and \
            torch.cuda.is_initialized():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        r = run()
    _sync_result(r)
    return (time.perf_counter() - t0) / iters * 1e3


def autotune(kernel: str, key, candidates: Sequence[Any],
             run_fn: Callable[[Any], Any], warmup: int = 1, iters: int = 3,
             measure: Optional[Callable[[Callable[[], Any]], float]] = None,
             cache: Optional[AutotuneCache] = None,
             device: Optional[str] = None):
    """Sweep ``candidates`` on the device, persist and return the winner.

    ``run_fn(config)`` runs the kernel once under ``config``. A cached
    entry short-circuits the sweep. ``device`` is the device part of the
    cache key (default :func:`chip_kind`). A candidate whose plan refuses the
    shape (``ValueError`` or ``NotImplementedError``) is skipped; any
    other error (a build, a launch, a device) propagates, so no kernel
    fault is hidden behind another configuration. If none runs,
    ``ValueError``."""
    c = cache or get_cache()
    hit = c.get(kernel, key, device)
    if hit is not None:
        return hit
    meas = measure or (lambda run: _measure(run, warmup, iters))
    best_cfg, best_ms = None, float("inf")
    for cfg in candidates:
        try:
            ms = meas(lambda: run_fn(cfg))
        except (ValueError, NotImplementedError):
            continue
        if ms < best_ms:
            best_cfg, best_ms = cfg, ms
    if best_cfg is None:
        raise ValueError(f"autotune({kernel}): no candidate ran for {key}")
    c.put(kernel, key, best_cfg, best_ms, device)
    return best_cfg
