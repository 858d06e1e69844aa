"""Mixed precision of the port (``paddle_tpu/amp`` counterpart): O2
``decorate`` so far."""

from .auto_cast import decorate  # noqa: F401

__all__ = ["decorate"]
