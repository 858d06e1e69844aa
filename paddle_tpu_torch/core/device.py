"""Device resolution for the port's entry points.

The port runs on the GPU unless the caller asks for the CPU: ``None``
means ``cuda:0`` and raises when CUDA is absent, so a missing card is an
error and never a quiet fall back to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda:0`` (raises without CUDA); ``"cuda"`` -> the
    current CUDA device; anything else as ``torch.device`` parses it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: paddle_tpu_torch runs on the GPU by "
                "default; pass device='cpu' to run the plain versions on "
                "the CPU")
        return torch.device("cuda", 0)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is absent")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def same_device(a: torch.device, b: Optional[torch.device]) -> bool:
    """Equality that treats ``cuda`` and ``cuda:<current>`` alike."""
    if b is None:
        return False
    return resolve_device(a) == resolve_device(b)
