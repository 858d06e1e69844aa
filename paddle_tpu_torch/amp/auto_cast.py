"""Mixed precision (``paddle_tpu/amp/auto_cast.py`` counterpart).

As in the JAX package, mixed precision is a dtype policy that the compute
layers consult, not a cast of every op: ``auto_cast(level="O1")`` installs
a thread-local :class:`AmpState`, and :class:`~paddle_tpu_torch.nn.Linear`
and :class:`~paddle_tpu_torch.nn.Conv2D` ask :func:`maybe_cast_input`
whether to cast their float32 input, weight and bias to the AMP dtype
(bfloat16 by default, the flag ``amp_dtype``). An op is cast under O1 when
it is on the white list (or ``custom_white_list``) and not on the black
list (or ``custom_black_list``); under O2 every op not on a black list.
Norms, softmax and the losses compute in float32 anyway. ``decorate``
casts the models' parameters at O2 and casts nothing at O1 (the layers cast
per call); ``master_weight`` sets the optimizers' ``multi_precision``.
Loss scaling for float16 is :mod:`.grad_scaler`.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Optional, Set

import torch

__all__ = ["auto_cast", "amp_guard", "get_amp_state", "AmpState",
           "white_list", "black_list", "decorate", "maybe_cast_input"]

#: ops (by layer-family name) that run in low precision under O1
WHITE_LIST: Set[str] = {
    "linear", "matmul", "conv2d", "attention", "einsum", "bmm", "mm",
}
#: ops kept in float32 even under O2
BLACK_LIST: Set[str] = {
    "layer_norm", "batch_norm", "softmax", "cross_entropy", "log_softmax",
    "mean", "sum", "exp", "log", "rms_norm", "group_norm",
}

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def _to_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype)
    if name not in _DTYPES:
        raise ValueError(f"dtype must be one of {sorted(_DTYPES)}; got "
                         f"{dtype!r}")
    return _DTYPES[name]


def white_list():
    return set(WHITE_LIST)


def black_list():
    return set(BLACK_LIST)


@dataclass
class AmpState:
    enable: bool = False
    level: str = "O0"
    dtype: Optional[torch.dtype] = None
    custom_white_list: Set[str] = field(default_factory=set)
    custom_black_list: Set[str] = field(default_factory=set)

    def should_cast(self, op: str) -> bool:
        if not self.enable:
            return False
        if op in self.custom_black_list or op in BLACK_LIST:
            return False
        if self.level == "O2":
            return True
        return op in WHITE_LIST or op in self.custom_white_list


_state = threading.local()


def get_amp_state() -> AmpState:
    st = getattr(_state, "amp", None)
    return st if st is not None else AmpState()


@contextlib.contextmanager
def auto_cast(enable: bool = True, custom_white_list=None,
              custom_black_list=None, level: str = "O1",
              dtype: Optional[str] = None):
    """``paddle.amp.auto_cast``: the layers inside cast as :class:`AmpState`
    says; the previous state comes back on exit."""
    from ..core import flags
    dtype = dtype or flags.flag("amp_dtype")
    with installed(AmpState(
            enable=enable, level=level if enable else "O0",
            dtype=_to_dtype(dtype),
            custom_white_list=set(custom_white_list or ()),
            custom_black_list=set(custom_black_list or ()))):
        yield


@contextlib.contextmanager
def installed(st: Optional[AmpState]):
    """Make ``st`` (a value of :func:`current`) this thread's state
    inside, and put back the previous one on exit. Activation recompute
    re-runs a forward under it: autograd runs a CUDA backward on a thread
    of its own, where the forward's ``auto_cast`` is not active."""
    prev = getattr(_state, "amp", None)
    _state.amp = st
    try:
        yield
    finally:
        _state.amp = prev


def current() -> Optional[AmpState]:
    """This thread's state as :func:`installed` takes it back: None when
    no :func:`auto_cast` is active."""
    return getattr(_state, "amp", None)


amp_guard = auto_cast


def maybe_cast_input(op: str, *tensors):
    """Called by the compute layers: the float32 ones of ``tensors`` cast
    to the AMP dtype where :meth:`AmpState.should_cast` says so, the others
    (None, other dtypes) as they are. One tensor comes back alone, several
    as a tuple."""
    st = current()
    if st is not None and st.should_cast(op):
        tensors = tuple(
            t.to(st.dtype) if t is not None and t.dtype == torch.float32
            else t for t in tensors)
    return tensors if len(tensors) > 1 else tensors[0]


def decorate(models, optimizers=None, level: str = "O2",
             dtype: Optional[str] = None,
             master_weight: Optional[bool] = None,
             save_dtype: Optional[str] = None):
    """``paddle.amp.decorate``: at O2 cast every floating-point parameter
    and buffer of the models to the AMP dtype (the flag ``amp_dtype``,
    bfloat16 by default); at O1 cast nothing (``auto_cast`` casts per
    call). ``master_weight`` sets the optimizers' ``multi_precision``
    (float32 masters, on by default). Returns ``models`` or ``(models,
    optimizers)``, each as given (one object or a list)."""
    if level not in ("O1", "O2"):
        raise ValueError(f"level must be 'O1' or 'O2'; got {level!r}")
    from ..core import flags
    dtype = _to_dtype(dtype or flags.flag("amp_dtype"))
    if dtype == torch.float32:
        raise ValueError("decorate casts to bfloat16 or float16, not "
                         "float32")
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == "O2":
        for m in model_list:
            m.to(dtype)
    if optimizers is None:
        return models if single else model_list
    opt_single = not isinstance(optimizers, (list, tuple))
    opt_list = [optimizers] if opt_single else list(optimizers)
    if master_weight is not None:
        for o in opt_list:
            o.multi_precision = bool(master_weight)
    return (models if single else model_list,
            optimizers if opt_single else opt_list)
