"""Core helpers of the port (device resolution, flags, the random key
streams of :mod:`.random`)."""

from .device import resolve_device  # noqa: F401

__all__ = ["resolve_device"]
