"""Layers, functional ops, initializers and gradient clipping of the port
(``paddle_tpu/nn`` counterpart; the GPT, BERT, ResNet, LeNet and
Transformer slices' subset)."""

from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue)
from .layer import ParamAttr, create_parameter  # noqa: F401
from .layers import (AdaptiveAvgPool2D, AvgPool2D,  # noqa: F401
                     BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                     BeamSearchDecoder, Conv2D, CrossEntropyLoss, Dropout,
                     Embedding, Flatten, Identity, LayerList, LayerNorm,
                     Linear, MaxPool2D, MultiHeadAttention, Pad2D, ReLU,
                     Sequential,
                     Transformer, TransformerDecoder,
                     TransformerDecoderLayer, TransformerEncoder,
                     TransformerEncoderLayer, dynamic_decode)

__all__ = ["functional", "initializer", "ClipGradByGlobalNorm",
           "ClipGradByNorm", "ClipGradByValue", "ParamAttr",
           "create_parameter", "AdaptiveAvgPool2D", "AvgPool2D",
           "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "BeamSearchDecoder", "Conv2D", "CrossEntropyLoss", "Dropout",
           "Embedding", "Flatten", "Identity", "LayerList", "LayerNorm",
           "Linear", "MaxPool2D", "MultiHeadAttention", "Pad2D", "ReLU",
           "Sequential",
           "Transformer", "TransformerDecoder", "TransformerDecoderLayer",
           "TransformerEncoder", "TransformerEncoderLayer",
           "dynamic_decode"]
