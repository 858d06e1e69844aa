"""The tensor op surface (``paddle_tpu/tensor`` counterpart): Paddle's
names over torch tensors, with the JAX package's ``__all__`` lists and
argument names (``axis``, ``keepdim``, ``name=``). A tensor is a
``torch.Tensor``; ``paddle.to_tensor`` makes one on this thread's device.
"""

from .creation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from .stat import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
from .extras import *  # noqa: F401,F403
