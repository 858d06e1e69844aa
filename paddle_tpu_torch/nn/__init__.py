"""Layers' functional ops and gradient clipping of the port
(``paddle_tpu/nn`` counterpart; the training slice's subset)."""

from . import functional  # noqa: F401
from .clip import ClipGradByGlobalNorm  # noqa: F401

__all__ = ["functional", "ClipGradByGlobalNorm"]
