"""``paddle.nn`` of the port (``paddle_tpu/nn`` counterpart): the ``Layer``
API, every layer, the recurrences, the functional ops, initializers,
gradient clipping and ``nn.utils``."""

from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue)
from .layer import (HookRemoveHelper, Layer, ParamAttr,  # noqa: F401
                    Parameter, ParamRef, create_parameter)
from .layers import *  # noqa: F401,F403
from .layers import __all__ as _layers_all
from .rnn import *  # noqa: F401,F403
from .rnn import __all__ as _rnn_all
from . import utils  # noqa: F401,E402

__all__ = ["functional", "initializer", "utils", "ClipGradByGlobalNorm",
           "ClipGradByNorm", "ClipGradByValue", "HookRemoveHelper", "Layer",
           "ParamAttr", "Parameter", "ParamRef", "create_parameter",
           *_layers_all, *_rnn_all]
