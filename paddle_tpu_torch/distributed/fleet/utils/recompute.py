"""Activation recompute (``paddle_tpu/distributed/fleet/utils/recompute.py``
counterpart).

The JAX package wraps a function in ``jax.checkpoint`` under one of
``jax.checkpoint_policies``; the port wraps it in non-reentrant
``torch.utils.checkpoint.checkpoint``, and a policy decides op by op, at
the dispatcher (``create_selective_checkpoint_contexts``), which outputs
the forward keeps and which the backward computes again:

==========================  ==============================================
``None`` (``FULL``),        nothing: the whole forward runs again
``"nothing_saveable"``
``"dots_saveable"``         the products: ``mm``, ``addmm``, ``bmm``,
                            ``baddbmm`` (JAX's ``dot_general``)
``"dots_with_no_batch_``    ``mm`` and ``addmm``: no batched product
``dims_saveable"``
``"dots_and_flash_``        the products, K1's and K4's ``(o, lse)`` (the
``saveable"``               operators ``paddle_tpu_torch::flash_fwd`` and
                            ``paddle_tpu_torch::flash_packed_fwd``; JAX's
                            ``flash_out``/``flash_lse``) and LayerNorm's
                            outputs (``native_layer_norm``: JAX's
                            ``norm_out``/``norm_xhat``/``norm_stat``)
``"everything_saveable"``   every output: the function runs as it is,
                            with nothing to recompute
==========================  ==============================================

Dropout replays its masks. JAX's keys are values fixed when the function
is traced, so its recompute sees the forward's randomness. The port draws
keys from counters (:mod:`paddle_tpu_torch.core.random`): the wrapped
function notes the stream's position when the forward enters it and
re-runs under :func:`~paddle_tpu_torch.core.random.replay` of that
position, so hidden dropout and the attention-dropout seed draw what the
forward drew, and the outer stream is left as it was. The recompute also
runs under the forward's :func:`~paddle_tpu_torch.amp.auto_cast` state:
autograd runs a CUDA backward on a thread of its own, where that
thread-local state would otherwise be off and the recomputed products
would not be cast as the forward's were.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ....amp.auto_cast import current as amp_state, installed
from ....core import random as rng
# register the operators torch.ops.paddle_tpu_torch.flash_fwd (K1) and
# .flash_packed_fwd (K4)
from ....ops._hopper import flash_attention  # noqa: F401
from ....ops._hopper import flash_attention_packed  # noqa: F401

__all__ = ["recompute", "recompute_sequential", "RecomputePolicy"]

_aten = torch.ops.aten
_MM = frozenset({_aten.mm.default, _aten.addmm.default})
_BATCHED_MM = frozenset({_aten.bmm.default, _aten.baddbmm.default})
_FLASH_AND_NORM = frozenset({
    torch.ops.paddle_tpu_torch.flash_fwd.default,
    torch.ops.paddle_tpu_torch.flash_packed_fwd.default,
    _aten.native_layer_norm.default})


class RecomputePolicy:
    """The JAX package's policy names; :meth:`resolve` gives the set of
    operators whose outputs the forward keeps, None for full recompute."""

    FULL = None  # recompute everything
    DOTS = "dots_saveable"
    DOTS_NO_BATCH = "dots_with_no_batch_dims_saveable"
    NOTHING = "nothing_saveable"
    EVERYTHING = "everything_saveable"
    # dots + K1's and K4's (o, lse) + LayerNorm's outputs: the backward
    # then runs neither K1, K4's forward nor a LayerNorm again
    DOTS_AND_FLASH = "dots_and_flash_saveable"

    NAMES = (FULL, DOTS, DOTS_NO_BATCH, NOTHING, EVERYTHING, DOTS_AND_FLASH)

    @staticmethod
    def resolve(name):
        """None (save nothing), ``"all"`` (save everything) or the
        frozenset of operators whose outputs are saved."""
        if name is None or name == RecomputePolicy.NOTHING:
            return None
        if name == RecomputePolicy.EVERYTHING:
            return "all"
        if name == RecomputePolicy.DOTS_NO_BATCH:
            return _MM
        if name == RecomputePolicy.DOTS:
            return _MM | _BATCHED_MM
        if name == RecomputePolicy.DOTS_AND_FLASH:
            return _MM | _BATCHED_MM | _FLASH_AND_NORM
        raise ValueError(f"unknown recompute policy {name!r}; expected one "
                         f"of {RecomputePolicy.NAMES}")


def _decide(saved, ctx, op, *args, **kwargs):
    if op in saved:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _replaying(fn: Callable) -> Callable:
    """``fn`` whose second and later calls (the recompute) draw the keys
    its first call drew, under the AMP state its first call saw."""
    start = []

    def run(*args, **kwargs):
        if not start:
            start.append((rng.stream_position(), amp_state()))
            return fn(*args, **kwargs)
        position, saw = start[0]
        with rng.replay(position), installed(saw):
            return fn(*args, **kwargs)

    return run


def _checkpoint(fn: Callable, args, kwargs, policy):
    saved = RecomputePolicy.resolve(policy)
    if saved == "all":
        return fn(*args, **kwargs)
    extra = {} if saved is None else {"context_fn": functools.partial(
        create_selective_checkpoint_contexts,
        functools.partial(_decide, saved))}
    # every draw of the port goes through core.random, which _replaying
    # replays; torch's own generators hold nothing to preserve
    return checkpoint(_replaying(fn), *args, use_reentrant=False,
                      preserve_rng_state=False, **extra, **kwargs)


def recompute(function, *args, policy: Optional[str] = None,
              prevent_cse: bool = True, use_reentrant: bool = True,
              **kwargs):
    """ref ``recompute()``: run ``function`` (a module or a callable) on
    ``args`` and keep only what ``policy`` saves; the backward runs the rest
    again. The checkpoint is always the non-reentrant one (a policy needs
    it), so ``use_reentrant`` is taken and unused, as ``prevent_cse`` is
    (an XLA option)."""
    return _checkpoint(function, args, kwargs, policy)


def recompute_sequential(ctx: dict, functions, *args, **kwargs):
    """ref ``recompute_sequential`` (``:508``): the layers in
    ``ctx["segments"]`` chunks of ``len // segments`` layers, each chunk
    recomputed in full."""
    segments = ctx.get("segments", 1)
    layers = list(functions)
    per = max(1, len(layers) // segments)
    x = args[0] if len(args) == 1 else args

    def chunk(part):
        def run(x):
            for layer in part:
                x = layer(x)
            return x
        return run

    for s in range(0, len(layers), per):
        x = _checkpoint(chunk(layers[s:s + per]), (x,), {}, None)
    return x
