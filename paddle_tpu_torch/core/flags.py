"""Flags of the port (``paddle_tpu/core/flags.py`` counterpart, the subset
the port reads).

``set_flags({"FLAGS_pallas_conv": 1})`` and ``get_flags(["pallas_conv"])``
work as in the JAX package, under the same names, so a caller's settings
carry over. Four flags are defined, with JAX's defaults:

- ``fused_conv_bn``: ResNet blocks in training take the deferred-BN units of
  :mod:`paddle_tpu_torch.nn.fused_conv_bn`;
- ``pallas_conv``: inside those units, a supported convolution runs on the
  hand-written conv kernels (``ops/_hopper/conv.py``, K5-K8). The name is
  the JAX package's; on the GPU it means the CUDA kernels;
- ``flash_head_pack`` (on): d=64 attention whose heads match takes K4, the
  head-dim-64 kernels (``ops/_hopper/flash_attention_packed.py``); at 0 it
  takes K1-K3, as in JAX;
- ``amp_dtype`` (``"bfloat16"``): the dtype :func:`paddle_tpu_torch.amp.
  decorate` casts to when it is given none.

Unlike the JAX registry, no ``FLAGS_*`` environment variable is read.
"""

from __future__ import annotations

import difflib
import threading
from typing import Any, Dict, Iterable, Union

__all__ = ["define_flag", "flag", "get_flags", "set_flags"]

_defaults: Dict[str, Any] = {}
_values: Dict[str, Any] = {}
_lock = threading.RLock()


def _unknown(name: str) -> KeyError:
    close = difflib.get_close_matches(name, _values, n=1)
    hint = f" (did you mean {close[0]!r}?)" if close else ""
    return KeyError(f"Unknown flag {name!r}{hint}; valid flags: "
                    f"{sorted(_values)}")


def define_flag(name: str, default: Any, help: str = "") -> None:
    """Register ``name`` with its default (its type coerces later
    values). ``help`` documents it, as in JAX."""
    with _lock:
        _defaults[name] = default
        _values[name] = default


def flag(name: str) -> Any:
    try:
        return _values[name]
    except KeyError:
        raise _unknown(name) from None


def get_flags(names: Union[str, Iterable[str], None] = None
              ) -> Dict[str, Any]:
    """``{name: value}`` for ``names`` (one name, several, or all)."""
    with _lock:
        if names is None:
            return dict(_values)
        if isinstance(names, str):
            names = [names]
        return {n: flag(n) for n in names}


def set_flags(flags_map: Dict[str, Any]) -> None:
    """Set flags by name, with or without the ``FLAGS_`` prefix; an
    unknown name raises ``KeyError``."""
    with _lock:
        for name, value in flags_map.items():
            if name.startswith("FLAGS_"):
                name = name[len("FLAGS_"):]
            if name not in _values:
                raise _unknown(name)
            _values[name] = type(_defaults[name])(value)


define_flag("fused_conv_bn", 0,
            "use the deferred-BN fused conv units in ResNet-class models "
            "in training (default off, as in the JAX package)")
define_flag("pallas_conv", 0,
            "route supported convs (1x1 as a matmul, NHWC 3x3 at stride 1 "
            "or 2) inside the fused units through the hand-written conv "
            "kernels with in-kernel BN prologue and stat epilogue (default "
            "off, as in the JAX package)")
define_flag("flash_head_pack", 1,
            "route d=64 dense-head attention to the head-packed kernel")
define_flag("amp_dtype", "bfloat16",
            "Preferred mixed-precision compute dtype.")
