"""Layers, functional ops and gradient clipping of the port
(``paddle_tpu/nn`` counterpart; the GPT, BERT and ResNet training slices'
subset)."""

from . import functional  # noqa: F401
from .clip import ClipGradByGlobalNorm  # noqa: F401
from .layers import (AdaptiveAvgPool2D, BatchNorm2D,  # noqa: F401
                     Conv2D, Dropout, MaxPool2D, MultiHeadAttention, ReLU,
                     Sequential, TransformerEncoder, TransformerEncoderLayer)

__all__ = ["functional", "ClipGradByGlobalNorm", "AdaptiveAvgPool2D",
           "BatchNorm2D", "Conv2D", "Dropout", "MaxPool2D",
           "MultiHeadAttention", "ReLU", "Sequential", "TransformerEncoder",
           "TransformerEncoderLayer"]
