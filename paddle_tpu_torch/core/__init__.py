"""Core of the port: device, dtypes, flags and the random key streams
(``paddle_tpu/core/__init__.py`` counterpart, with the same re-exports)."""

from . import device, dtype, flags, random  # noqa: F401
from .flags import get_flags, set_flags, define_flag, flag  # noqa: F401
from .device import (set_device, get_device, device_count,  # noqa: F401
                     is_compiled_with_tpu, synchronize, resolve_device)
from .random import seed, get_rng_state, set_rng_state, rng_scope  # noqa: F401
