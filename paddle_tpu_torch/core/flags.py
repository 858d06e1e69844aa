"""Flags of the port (``paddle_tpu/core/flags.py`` counterpart, the subset
the port reads).

``set_flags({"FLAGS_pallas_conv": 1})`` and ``get_flags(["pallas_conv"])``
work as in the JAX package, under the same names, so a caller's settings
carry over. These flags are defined, with JAX's defaults:

- ``fused_conv_bn``: ResNet blocks in training take the deferred-BN units of
  :mod:`paddle_tpu_torch.nn.fused_conv_bn`;
- ``pallas_conv``: inside those units, a supported convolution runs on the
  hand-written conv kernels (``ops/_hopper/conv.py``, K5-K8). The name is
  the JAX package's; on the GPU it means the CUDA kernels;
- ``flash_head_pack`` (on): d=64 attention whose heads match takes K4, the
  head-dim-64 kernels (``ops/_hopper/flash_attention_packed.py``); at 0 it
  takes K1-K3, as in JAX;
- ``amp_dtype`` (``"bfloat16"``): the dtype :func:`paddle_tpu_torch.amp.
  decorate` casts to when it is given none;
- ``serve_prefix_cache``, ``serve_chunked_prefill``, ``serve_speculative``:
  the serving engine's three throughput tiers, read when the engine's own
  argument is ``None`` (all off);
- ``kernel_autotune`` (on) and ``kernel_autotune_cache_path`` (``""``: the
  default file): the autotune cache of :mod:`paddle_tpu_torch.ops._hopper.
  autotune`, which ``serve_speculative=-1`` reads.

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
define_flag("serve_prefix_cache", False,
            "Radix prefix-sharing KV cache (serving/prefix_tree.py): "
            "requests whose prompts share a full-block prefix attach to "
            "the same immutable pages copy-on-write (refcounted "
            "BlockAllocator; only the partial tail block is private), "
            "eviction is LRU over refcount-0 trie leaves with a one-copy "
            "host spill tier. Off (default) keeps the engine "
            "byte-identical to the private-KV path.")
define_flag("serve_chunked_prefill", 0,
            "Chunked-prefill token budget for the serving engine: 0 "
            "(default) prefills every prompt in one bucketed dispatch "
            "(byte-identical to the pre-chunking engine); N > 0 splits "
            "prompts longer than N tokens into N-token chunks "
            "interleaved with the decode iterations so a long prompt "
            "no longer stalls resident decodes (N is rounded down to a "
            "multiple of the engine block size).")
define_flag("serve_speculative", 0,
            "Speculative-decoding draft depth (gamma) for the serving "
            "engine: 0 (default) decodes one token per iteration "
            "(byte-identical); N > 0 proposes N tokens per iteration "
            "from the drafter (NGramDrafter by default, or a "
            "ModelDrafter over a mirrored paged pool) and verifies them "
            "in ONE bucketed decode-gamma dispatch with the greedy "
            "accept-prefix rule; -1 consults the persistent autotune "
            "cache's accepted-length-derived gamma (falls back to 4).")
define_flag("kernel_autotune", 1,
            "consult the persistent kernel-autotune cache")
define_flag("kernel_autotune_cache_path", "",
            "override the autotune cache file location")
