"""Core helpers of the port (device resolution)."""

from .device import resolve_device  # noqa: F401

__all__ = ["resolve_device"]
