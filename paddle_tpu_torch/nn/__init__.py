"""Layers, functional ops and gradient clipping of the port
(``paddle_tpu/nn`` counterpart; the GPT, BERT, ResNet and LeNet training
slices' subset)."""

from . import functional  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue)
from .layers import (AdaptiveAvgPool2D, BatchNorm2D,  # noqa: F401
                     Conv2D, CrossEntropyLoss, Dropout, Linear, MaxPool2D,
                     MultiHeadAttention, ReLU, Sequential,
                     TransformerEncoder, TransformerEncoderLayer)

__all__ = ["functional", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "AdaptiveAvgPool2D", "BatchNorm2D", "Conv2D",
           "CrossEntropyLoss", "Dropout", "Linear", "MaxPool2D",
           "MultiHeadAttention", "ReLU", "Sequential", "TransformerEncoder",
           "TransformerEncoderLayer"]
