"""Layers, functional ops and gradient clipping of the port
(``paddle_tpu/nn`` counterpart; the GPT and BERT training slices' subset)."""

from . import functional  # noqa: F401
from .clip import ClipGradByGlobalNorm  # noqa: F401
from .layers import (Dropout, MultiHeadAttention,  # noqa: F401
                     TransformerEncoder, TransformerEncoderLayer)

__all__ = ["functional", "ClipGradByGlobalNorm", "Dropout",
           "MultiHeadAttention", "TransformerEncoder",
           "TransformerEncoderLayer"]
