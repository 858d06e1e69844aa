"""The high-level API of the port (``paddle_tpu/hapi`` counterpart):
``Model``, its callbacks and ``summary``."""

from .model import Model  # noqa: F401
from . import callbacks  # noqa: F401
