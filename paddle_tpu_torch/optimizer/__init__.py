"""Optimizers and learning-rate schedulers of the port
(``paddle_tpu/optimizer`` counterpart; the training slice's subset)."""

from . import lr  # noqa: F401
from .optimizer import SGD, Adam, AdamW, Momentum, Optimizer  # noqa: F401

__all__ = ["lr", "Optimizer", "SGD", "Momentum", "Adam", "AdamW"]
