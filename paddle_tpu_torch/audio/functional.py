"""``paddle.audio.functional`` of the port
(``paddle_tpu/audio/functional.py`` counterpart): mel scales, the mel
filter bank, decibels, the DCT basis and the windows, in float32 torch as
JAX computes them (its ``linspace`` too: ``start·(1 - i/d) + stop·i/d``).

A function of an array keeps the array's device; one that makes its
output from sizes (the frequencies, the filter bank, the DCT, a window)
makes it on the thread's device (:func:`~..core.device.resolve_device`).
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch

from ..core import dtype as dtypes
from ..core.device import as_device_tensor, resolve_device

__all__ = ["hz_to_mel", "mel_to_hz", "mel_frequencies", "fft_frequencies",
           "compute_fbank_matrix", "power_to_db", "create_dct",
           "get_window"]

_F32 = torch.float32


def _f32(x) -> torch.Tensor:
    return as_device_tensor(x, _F32)


def _linspace(lo: torch.Tensor, hi: torch.Tensor, num: int) -> torch.Tensor:
    """``jnp.linspace(lo, hi, num)`` in float32, as JAX computes it."""
    if num == 1:
        return lo.reshape(1)
    div = num - 1
    step = torch.arange(div, dtype=_F32, device=lo.device) / \
        torch.tensor(div, dtype=_F32, device=lo.device)
    return torch.cat([lo * (1 - step) + hi * step, hi.reshape(1)])


def hz_to_mel(freq, htk: bool = False):
    """Hz to mels: Slaney's scale (linear below 1 kHz, logarithmic
    above), or HTK's ``2595·log10(1 + f/700)``."""
    freq = _f32(freq)
    if htk:
        return 2595.0 * torch.log10(1.0 + freq / 700.0)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = math.log(6.4) / 27.0
    return torch.where(freq >= min_log_hz,
                       min_log_mel + torch.log(freq / min_log_hz) / logstep,
                       mels)


def mel_to_hz(mel, htk: bool = False):
    """The inverse of :func:`hz_to_mel`."""
    mel = _f32(mel)
    if htk:
        return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mel
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = math.log(6.4) / 27.0
    return torch.where(mel >= min_log_mel,
                       min_log_hz * torch.exp(logstep * (mel - min_log_mel)),
                       freqs)


def mel_frequencies(n_mels: int = 64, f_min: float = 0.0,
                    f_max: float = 11025.0, htk: bool = False,
                    dtype="float32"):
    """``n_mels`` frequencies evenly spaced in mels from ``f_min`` to
    ``f_max``."""
    mels = _linspace(hz_to_mel(f_min, htk), hz_to_mel(f_max, htk), n_mels)
    return mel_to_hz(mels, htk).to(dtypes.to_dtype(dtype))


def fft_frequencies(sr: int, n_fft: int, dtype="float32"):
    """The ``1 + n_fft // 2`` bin frequencies of a real FFT at ``sr``."""
    dev = resolve_device(None)
    return _linspace(torch.tensor(0.0, device=dev),
                     torch.tensor(sr / 2.0, dtype=_F32, device=dev),
                     1 + n_fft // 2).to(dtypes.to_dtype(dtype))


def compute_fbank_matrix(sr: int, n_fft: int, n_mels: int = 64,
                         f_min: float = 0.0, f_max: Optional[float] = None,
                         htk: bool = False, norm: Union[str, float] = "slaney",
                         dtype="float32"):
    """The triangular mel filter bank ``[n_mels, 1 + n_fft // 2]``, each
    filter scaled to unit area (``"slaney"``) or unit p-norm (a number
    ``p``)."""
    f_max = f_max if f_max is not None else float(sr) / 2
    fftfreqs = fft_frequencies(sr, n_fft)
    mel_f = mel_frequencies(n_mels + 2, f_min, f_max, htk)
    fdiff = torch.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = torch.minimum(lower, upper).clamp_min(0.0)
    if norm == "slaney":
        enorm = 2.0 / (mel_f[2: n_mels + 2] - mel_f[:n_mels])
        weights = weights * enorm[:, None]
    elif isinstance(norm, (int, float)):
        weights = weights / (torch.sum(weights.abs() ** norm, dim=1,
                                       keepdim=True)
                             ** (1.0 / norm)).clamp_min(1e-10)
    return weights.to(dtypes.to_dtype(dtype))


def power_to_db(spect, ref_value: float = 1.0, amin: float = 1e-10,
                top_db: Optional[float] = 80.0):
    """Power to decibels, ``10·log10(max(amin, x)) - 10·log10(max(amin,
    ref))``, floored at ``top_db`` below the largest value of the whole
    input."""
    spect = spect if isinstance(spect, torch.Tensor) else _f32(spect)
    log_spec = 10.0 * torch.log10(spect.clamp_min(amin))
    log_spec = log_spec - 10.0 * math.log10(max(amin, ref_value))
    if top_db is not None:
        if top_db < 0:
            raise ValueError("top_db must be non-negative")
        log_spec = torch.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def create_dct(n_mfcc: int, n_mels: int, norm: Optional[str] = "ortho",
               dtype="float32"):
    """The DCT-II basis ``[n_mels, n_mfcc]``, orthonormal for
    ``"ortho"``."""
    dev = resolve_device(None)
    n = torch.arange(n_mels, dtype=_F32, device=dev)
    k = torch.arange(n_mfcc, dtype=_F32, device=dev)[None, :]
    basis = torch.cos(math.pi / n_mels * (n[:, None] + 0.5) * k)
    if norm is None:
        basis = basis * 2.0
    elif norm == "ortho":
        scale = torch.where(k == 0, math.sqrt(1.0 / (4 * n_mels)),
                            math.sqrt(1.0 / (2 * n_mels)))
        basis = basis * 2.0 * scale
    else:
        raise ValueError(f"unsupported norm {norm!r}")
    return basis.to(dtypes.to_dtype(dtype))


_WINDOWS = {}


def _register(name):
    def deco(fn):
        _WINDOWS[name] = fn
        return fn
    return deco


def _extend(M: int, sym: bool):
    return (M + 1, True) if not sym else (M, False)


def _truncate(w, trunc: bool):
    return w[:-1] if trunc else w


def _n(M2: int) -> torch.Tensor:
    return torch.arange(M2, dtype=_F32, device=resolve_device(None))


@_register("hann")
def _hann(M: int, sym: bool = True):
    M2, trunc = _extend(M, sym)
    return _truncate(0.5 - 0.5 * torch.cos(2 * math.pi * _n(M2) / (M2 - 1)),
                     trunc)


@_register("hamming")
def _hamming(M: int, sym: bool = True):
    M2, trunc = _extend(M, sym)
    return _truncate(0.54 - 0.46 * torch.cos(2 * math.pi * _n(M2)
                                             / (M2 - 1)), trunc)


@_register("blackman")
def _blackman(M: int, sym: bool = True):
    M2, trunc = _extend(M, sym)
    n = _n(M2)
    w = (0.42 - 0.5 * torch.cos(2 * math.pi * n / (M2 - 1))
         + 0.08 * torch.cos(4 * math.pi * n / (M2 - 1)))
    return _truncate(w, trunc)


@_register("bartlett")
def _bartlett(M: int, sym: bool = True):
    M2, trunc = _extend(M, sym)
    n = _n(M2)
    w = 2.0 / (M2 - 1) * ((M2 - 1) / 2.0 - torch.abs(n - (M2 - 1) / 2.0))
    return _truncate(w, trunc)


@_register("cosine")
def _cosine(M: int, sym: bool = True):
    M2, trunc = _extend(M, sym)
    return _truncate(torch.sin(math.pi / M2 * (_n(M2) + 0.5)), trunc)


@_register("gaussian")
def _gaussian(M: int, std: float = 7.0, sym: bool = True):
    M2, trunc = _extend(M, sym)
    n = _n(M2) - (M2 - 1) / 2.0
    return _truncate(torch.exp(-(n ** 2) / (2 * std ** 2)), trunc)


def get_window(window: Union[str, tuple], win_length: int,
               fftbins: bool = True, dtype="float32"):
    """A window by name, or ``(name, parameter)``: hann, hamming,
    blackman, bartlett, cosine, gaussian (its std); periodic when
    ``fftbins``."""
    if isinstance(window, tuple):
        name, *args = window
    else:
        name, args = window, []
    fn = _WINDOWS.get(name)
    if fn is None:
        raise ValueError(f"unknown window {name!r} "
                         f"(available: {sorted(_WINDOWS)})")
    return fn(win_length, *args, sym=not fftbins).to(
        dtypes.to_dtype(dtype))
