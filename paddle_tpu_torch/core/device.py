"""Device management (``paddle_tpu/core/device.py`` counterpart).

Paddle's device strings over torch devices. One accelerator kind, CUDA,
answers to ``"gpu"``, ``"tpu"`` and ``"xpu"`` alike, as JAX's answers to
all three with the TPU; it is named ``gpu:<i>``. :func:`set_device` picks
the device for this thread, as JAX's does.

The port runs on the GPU unless the caller asks for the CPU:
:func:`resolve_device` turns ``None`` into the device :func:`set_device`
chose for this thread, else ``cuda:0``, and raises when CUDA is absent, so
a missing card is an error and never a quiet fall back to the CPU.
``set_device("cpu")`` is an explicit ask for the CPU.
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

__all__ = ["set_device", "get_device", "get_all_devices", "device_count",
           "is_compiled_with_tpu", "get_default_device", "synchronize",
           "resolve_device", "device_guard", "as_device_tensor",
           "as_host_array"]

DeviceLike = Union[str, torch.device, None]

_state = threading.local()

#: the kinds that name the accelerator (CUDA here, the TPU in JAX)
_ACCELERATOR = ("gpu", "tpu", "xpu")


def _parse(device: str) -> Tuple[str, int]:
    device = device.lower().strip()
    if ":" in device:
        kind, _, idx = device.partition(":")
        return kind, int(idx)
    return device, 0


def _platform_devices(kind: str) -> List[torch.device]:
    if kind in _ACCELERATOR:
        if not torch.cuda.is_available():
            return []
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if kind == "cpu":
        return [torch.device("cpu")]
    return []


def _name(dev: torch.device) -> str:
    return f"gpu:{dev.index}" if dev.type == "cuda" else "cpu:0"


def get_all_devices() -> List[str]:
    """``gpu:<i>`` for each card, or ``["cpu:0"]`` without CUDA."""
    devs = _platform_devices("gpu") or _platform_devices("cpu")
    return [_name(d) for d in devs]


def device_count(kind: str = "gpu") -> int:
    return len(_platform_devices(kind))


def is_compiled_with_tpu() -> bool:
    """Whether the accelerator is there (JAX's name; CUDA here)."""
    return device_count("tpu") > 0


def set_device(device: str) -> torch.device:
    """``paddle.set_device``: the device this thread's entry points use
    when given none (``"gpu"``, ``"gpu:1"``, ``"cpu"``). A kind with no
    device raises ``ValueError``, as in JAX."""
    kind, idx = _parse(device)
    devs = _platform_devices(kind)
    if not devs:
        raise ValueError(f"No devices of kind {kind!r}; have "
                         f"{get_all_devices()}")
    if idx >= len(devs):
        raise ValueError(f"Device index {idx} out of range for {kind} "
                         f"({len(devs)} present)")
    _state.device = devs[idx]
    return devs[idx]


def get_default_device() -> torch.device:
    """:func:`resolve_device` of None."""
    return resolve_device(None)


def get_device() -> str:
    """This thread's device as Paddle names it: what :func:`set_device`
    chose, else ``gpu:0``, or ``cpu:0`` without CUDA."""
    dev = getattr(_state, "device", None)
    if dev is not None:
        return _name(dev)
    return get_all_devices()[0]


def synchronize() -> None:
    """Wait until the work queued on this thread's card has finished (a
    no-op on the CPU)."""
    dev = getattr(_state, "device", None)
    if dev is None and torch.cuda.is_available():
        dev = torch.device("cuda", 0)
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> this thread's :func:`set_device`, else ``cuda:0``
    (raises without CUDA); Paddle's ``"gpu"``/``"gpu:<i>"`` (and ``"tpu"``,
    ``"xpu"``) -> ``cuda:<i>``; ``"cuda"`` -> the current CUDA device;
    anything else as ``torch.device`` parses it."""
    if device is None:
        dev = getattr(_state, "device", None)
        if dev is not None:
            return dev
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: paddle_tpu_torch runs on the GPU by "
                "default; pass device='cpu' (or call set_device('cpu')) to "
                "run the plain versions on the CPU")
        return torch.device("cuda", 0)
    if isinstance(device, str):
        kind, idx = _parse(device)
        if kind in _ACCELERATOR:
            device = torch.device("cuda", idx)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is absent")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def as_device_tensor(x, dtype=None, like: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """``x`` as an op's input: a tensor stays where it is (cast to
    ``dtype`` if given); an array, list or number goes to ``like``'s
    device, else to :func:`resolve_device`'s for None."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    dev = like.device if like is not None else resolve_device(None)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)


def as_host_array(x) -> np.ndarray:
    """``x`` as a host numpy array: a tensor is copied off its device, an
    array, list or number goes through ``np.asarray``."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def same_device(a: torch.device, b: Optional[torch.device]) -> bool:
    """Equality that treats ``cuda`` and ``cuda:<current>`` alike."""
    if b is None:
        return False
    return resolve_device(a) == resolve_device(b)


@contextlib.contextmanager
def device_guard(device: DeviceLike = None):
    """Within the block, :func:`resolve_device` of None is ``device``
    (itself resolved first: None is this thread's device, else
    ``cuda:0``); the thread's device is put back after. A model builds its
    layers under it, so every layer lands where the model's ``device=``
    says."""
    dev = resolve_device(device)
    prev = getattr(_state, "device", None)
    _state.device = dev
    try:
        yield dev
    finally:
        _state.device = prev
