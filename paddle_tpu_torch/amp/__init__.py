"""Mixed precision of the port (``paddle_tpu/amp`` counterpart):
``auto_cast`` (O1 and O2 op lists), ``decorate`` and dynamic loss
scaling."""

import torch

from .auto_cast import (AmpState, amp_guard, auto_cast,  # noqa: F401
                        black_list, decorate, get_amp_state,
                        maybe_cast_input, white_list)
from .grad_scaler import AmpScaler, GradScaler  # noqa: F401

__all__ = ["auto_cast", "amp_guard", "get_amp_state", "AmpState",
           "white_list", "black_list", "decorate", "maybe_cast_input",
           "GradScaler", "AmpScaler", "is_float16_supported",
           "is_bfloat16_supported"]


def is_float16_supported(device=None) -> bool:
    """True on the card (the tensor-core bodies take float16), False on
    the CPU, as JAX's answers off an accelerator."""
    from ..core.device import resolve_device
    if device is None:
        return torch.cuda.is_available()
    return resolve_device(device).type == "cuda"


def is_bfloat16_supported(device=None) -> bool:
    """True: the card computes bf16 natively, the CPU emulates it (JAX's
    answer everywhere)."""
    return True
