"""``paddle.fft`` of the port (``paddle_tpu/fft.py`` counterpart) on
``torch.fft`` (cuFFT on the card), with JAX's argument names, defaults and
``norm`` names (``"backward"``, ``"ortho"``, ``"forward"``).

Real float32 input gives complex64, as in JAX; float64 keeps 64 bits (JAX,
with 64-bit types off, gives complex64). ``hfft2``, ``ihfft2``, ``hfftn``
and ``ihfftn`` are JAX's own definitions, not numpy's: ``hfftn`` inverts
each leading axis (``ifft`` at ``norm``) and takes ``hfft`` on the last;
``ihfftn`` takes ``ihfft`` on the last and ``fft`` on each leading axis.
Outputs carry no lazy conjugation (torch may return ``ifft`` of a real
input as one): they are resolved, so ``.numpy()`` works on them.
``fftfreq`` and ``rfftfreq`` are made on the thread's device
(:func:`~.core.device.resolve_device`).
"""

from __future__ import annotations

import torch

from .core import dtype as dtypes
from .core.device import as_device_tensor as _t
from .core.device import resolve_device

__all__ = [
    "hfft2", "ihfft2", "hfftn", "ihfftn", "fft", "ifft", "rfft", "irfft",
    "hfft", "ihfft", "fft2", "ifft2", "rfft2", "irfft2", "fftn", "ifftn",
    "rfftn", "irfftn", "fftfreq", "rfftfreq", "fftshift", "ifftshift"]


def _dims(s, axes, ndim):
    """JAX's ``s``/``axes`` as torch's ``s``/``dim``: with ``axes`` None
    and ``s`` given, the last ``len(s)`` axes."""
    if axes is None and s is not None:
        axes = tuple(range(ndim - len(s), ndim))
    return (None if s is None else tuple(s),
            None if axes is None else tuple(axes))


def fft(x, n=None, axis=-1, norm="backward"):
    return torch.fft.fft(_t(x), n=n, dim=axis, norm=norm).resolve_conj()


def ifft(x, n=None, axis=-1, norm="backward"):
    return torch.fft.ifft(_t(x), n=n, dim=axis, norm=norm).resolve_conj()


def rfft(x, n=None, axis=-1, norm="backward"):
    return torch.fft.rfft(_t(x), n=n, dim=axis, norm=norm).resolve_conj()


def irfft(x, n=None, axis=-1, norm="backward"):
    return torch.fft.irfft(_t(x), n=n, dim=axis, norm=norm).resolve_conj()


def hfft(x, n=None, axis=-1, norm="backward"):
    return torch.fft.hfft(_t(x), n=n, dim=axis, norm=norm).resolve_conj()


def ihfft(x, n=None, axis=-1, norm="backward"):
    return torch.fft.ihfft(_t(x), n=n, dim=axis, norm=norm).resolve_conj()


def _nd(fn, x, s, axes, norm):
    x = _t(x)
    s, dim = _dims(s, axes, x.dim())
    return fn(x, s=s, dim=dim, norm=norm).resolve_conj()


def fft2(x, s=None, axes=(-2, -1), norm="backward"):
    return _nd(torch.fft.fftn, x, s, axes, norm)


def ifft2(x, s=None, axes=(-2, -1), norm="backward"):
    return _nd(torch.fft.ifftn, x, s, axes, norm)


def rfft2(x, s=None, axes=(-2, -1), norm="backward"):
    return _nd(torch.fft.rfftn, x, s, axes, norm)


def irfft2(x, s=None, axes=(-2, -1), norm="backward"):
    return _nd(torch.fft.irfftn, x, s, axes, norm)


def fftn(x, s=None, axes=None, norm="backward"):
    return _nd(torch.fft.fftn, x, s, axes, norm)


def ifftn(x, s=None, axes=None, norm="backward"):
    return _nd(torch.fft.ifftn, x, s, axes, norm)


def rfftn(x, s=None, axes=None, norm="backward"):
    return _nd(torch.fft.rfftn, x, s, axes, norm)


def irfftn(x, s=None, axes=None, norm="backward"):
    return _nd(torch.fft.irfftn, x, s, axes, norm)


def fftfreq(n, d=1.0, dtype=None):
    out = torch.fft.fftfreq(n, d=d, device=resolve_device(None))
    return out.to(dtypes.to_dtype(dtype)) if dtype is not None else out


def rfftfreq(n, d=1.0, dtype=None):
    out = torch.fft.rfftfreq(n, d=d, device=resolve_device(None))
    return out.to(dtypes.to_dtype(dtype)) if dtype is not None else out


def fftshift(x, axes=None):
    return torch.fft.fftshift(_t(x), dim=axes)


def ifftshift(x, axes=None):
    return torch.fft.ifftshift(_t(x), dim=axes)


def _axes(x, axes):
    if axes is None:
        axes = tuple(range(x.dim()))
    return tuple(a % x.dim() for a in axes)


def hfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    """2-D :func:`hfftn`."""
    return hfftn(x, s, axes, norm)


def ihfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    """2-D :func:`ihfftn`."""
    return ihfftn(x, s, axes, norm)


def hfftn(x, s=None, axes=None, norm="backward", name=None):
    """JAX's N-D Hermitian-input FFT: ``ifft`` over every axis but the
    last (at ``norm``), ``hfft`` on the last (its default length
    ``2·(m - 1)``)."""
    x = _t(x)
    axes = _axes(x, axes)
    if s is None:
        s = [2 * (x.shape[a] - 1) if a == axes[-1] else x.shape[a]
             for a in axes]
    out = x
    for a, n in zip(axes[:-1], s[:-1]):
        out = torch.fft.ifft(out, n=n, dim=a, norm=norm)
    return torch.fft.hfft(out, n=s[-1], dim=axes[-1],
                          norm=norm).resolve_conj()


def ihfftn(x, s=None, axes=None, norm="backward", name=None):
    """JAX's inverse of :func:`hfftn`: ``ihfft`` on the last axis, then
    ``fft`` over the others."""
    x = _t(x)
    axes = _axes(x, axes)
    if s is None:
        s = [x.shape[a] for a in axes]
    out = torch.fft.ihfft(x, n=s[-1], dim=axes[-1], norm=norm)
    for a, n in zip(axes[:-1], s[:-1]):
        out = torch.fft.fft(out, n=n, dim=a, norm=norm)
    return out.resolve_conj()
