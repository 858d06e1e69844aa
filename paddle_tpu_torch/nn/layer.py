"""``ParamAttr`` and the parameter factory of the port's layers
(``paddle_tpu/nn/layer.py`` counterpart, ``:39-72`` and ``:265-281``).

The port's layers are ``torch.nn.Module``\\ s; what they take from the JAX
``Layer`` is how a parameter is made: :func:`create_parameter` reads a
``weight_attr``/``bias_attr`` (a :class:`ParamAttr`, an initializer, a
name, or None) and draws the value with the initializer JAX's precedence
picks. ``trainable=False`` gives ``requires_grad=False``, so ``TrainStep``
and the imperative optimizers leave the parameter out. ``learning_rate``,
``regularizer``, ``need_clip`` and ``partition_spec`` are kept on the
attribute (``param.param_attr``) and not acted on, as the JAX optimizers
read none of them.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core.device import resolve_device
from . import initializer as I

__all__ = ["ParamAttr", "create_parameter"]


class ParamAttr:
    """Parity with ``paddle.ParamAttr``: per-parameter config."""

    def __init__(self, name: Optional[str] = None, initializer=None,
                 learning_rate: float = 1.0, trainable: bool = True,
                 regularizer=None, need_clip: bool = True,
                 partition_spec=None):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.trainable = trainable
        self.regularizer = regularizer
        self.need_clip = need_clip
        self.partition_spec = partition_spec

    @staticmethod
    def _to_attr(attr) -> "ParamAttr":
        if attr is None or attr is True:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, I.Initializer):
            return ParamAttr(initializer=attr)
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        raise TypeError(f"Cannot interpret {attr!r} as ParamAttr")


def create_parameter(shape, attr=None, dtype=None, is_bias: bool = False,
                     default_initializer: Optional[I.Initializer] = None,
                     device=None) -> nn.Parameter:
    """A parameter of ``shape`` (Paddle's layout) on ``device`` (resolved
    as the entry points resolve it: None is ``cuda:0``, and raises
    without CUDA). The initializer is, in order: the attribute's, the
    global one (:func:`~.initializer.set_global_initializer`), the
    layer's ``default_initializer``, then ``Constant(0)`` for a bias and
    ``XavierNormal`` otherwise."""
    attr = ParamAttr._to_attr(attr)
    init = attr.initializer \
        or I.get_global_initializer("bias" if is_bias else "weight") \
        or default_initializer
    if init is None:
        init = I.Constant(0.0) if is_bias else I.XavierNormal()
    value = init(shape, dtype=dtype, device=resolve_device(device))
    param = nn.Parameter(value, requires_grad=bool(attr.trainable))
    param.param_attr = attr
    return param
