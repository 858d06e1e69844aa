"""Optimizers and learning-rate schedulers of the port
(``paddle_tpu/optimizer`` counterpart)."""

from . import lr  # noqa: F401
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax,  # noqa: F401
                        AdamW, Lamb, Lars, LBFGS, Momentum, Optimizer,
                        RMSProp)

__all__ = ["lr", "Optimizer", "SGD", "Momentum", "Adam", "AdamW",
           "Adagrad", "RMSProp", "Lamb", "Lars", "Adamax", "Adadelta",
           "LBFGS"]
