"""Optimizers and learning-rate schedulers of the port
(``paddle_tpu/optimizer`` counterpart; LBFGS is not ported yet)."""

from . import lr  # noqa: F401
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax,  # noqa: F401
                        AdamW, Lamb, Lars, Momentum, Optimizer, RMSProp)

__all__ = ["lr", "Optimizer", "SGD", "Momentum", "Adam", "AdamW",
           "Adagrad", "RMSProp", "Lamb", "Lars", "Adamax", "Adadelta"]
