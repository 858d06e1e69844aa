"""Vision of the port (``paddle_tpu/vision`` counterpart): the model zoo of
:mod:`.models`, the datasets of :mod:`.datasets`, the host-side
:mod:`.transforms`, the detection operators of :mod:`.ops`, and the image
backend functions."""

from . import datasets, models, ops, transforms  # noqa: F401

__all__ = ["set_image_backend", "get_image_backend", "image_load"]

_image_backend = "pil"


def set_image_backend(backend: str):
    """``'pil'`` or ``'cv2'``, recorded for :func:`image_load`; cv2 is
    imported only when an image is loaded, so asking for it where it is
    absent fails there, as in JAX."""
    global _image_backend
    if backend not in ("pil", "cv2"):
        raise ValueError(f"unknown image backend {backend!r}")
    _image_backend = backend


def get_image_backend() -> str:
    return _image_backend


def image_load(path, backend=None):
    """The file as a PIL image (or, under ``'cv2'``, cv2's array)."""
    b = backend or _image_backend
    if b == "cv2":
        import cv2  # raises where cv2 is absent, as in JAX
        return cv2.imread(path)
    from PIL import Image
    return Image.open(path)
