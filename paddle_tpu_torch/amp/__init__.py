"""Mixed precision of the port (``paddle_tpu/amp`` counterpart):
``auto_cast`` (O1 and O2 op lists), ``decorate`` and dynamic loss
scaling."""

from .auto_cast import (AmpState, amp_guard, auto_cast,  # noqa: F401
                        black_list, decorate, get_amp_state,
                        maybe_cast_input, white_list)
from .grad_scaler import AmpScaler, GradScaler  # noqa: F401

__all__ = ["auto_cast", "amp_guard", "get_amp_state", "AmpState",
           "white_list", "black_list", "decorate", "maybe_cast_input",
           "GradScaler", "AmpScaler"]
