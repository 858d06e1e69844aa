"""Vision models of the port (``paddle_tpu/vision`` counterpart; ResNet so
far)."""

from . import models  # noqa: F401
