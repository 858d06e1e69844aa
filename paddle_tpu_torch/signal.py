"""``paddle.signal`` of the port (``paddle_tpu/signal.py`` counterpart):
``frame``, ``overlap_add``, ``stft`` and ``istft`` as torch ops on the
input's device, with JAX's formulas.

``frame`` gathers through one index grid and ``overlap_add`` sums frames
back with ``index_add``. ``stft`` pads the signal by ``n_fft // 2`` at both
ends in ``pad_mode`` (``np.pad``'s modes, taken through an index grid),
centres a shorter window in the frame, and divides by ``sqrt(n_fft)`` when
``normalized``. ``istft`` is JAX's least-squares inverse: the overlap-added
windowed frames over the overlap-added squared window where that exceeds
1e-11 (``torch.istft`` would raise where the window fails NOLA; this
returns a value there, as JAX's does).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .core.device import as_device_tensor as _t

__all__ = ["frame", "overlap_add", "stft", "istft"]


def _num_frames(seq_len: int, frame_length: int, hop_length: int) -> int:
    if frame_length > seq_len:
        raise ValueError(
            f"frame_length ({frame_length}) > sequence length ({seq_len})")
    return 1 + (seq_len - frame_length) // hop_length


def _grid(frame_length: int, hop_length: int, n: int, device):
    """``[frame_length, n]``: sample ``i`` of frame ``f`` at ``i + hop·f``."""
    return (torch.arange(frame_length, device=device)[:, None]
            + hop_length * torch.arange(n, device=device)[None, :])


def _check(hop_length: int, axis: int) -> None:
    if hop_length <= 0:
        raise ValueError(f"hop_length must be positive, got {hop_length}")
    if axis not in (0, -1):
        raise ValueError(f"axis must be 0 or -1, got {axis}")


def frame(x, frame_length: int, hop_length: int, axis: int = -1, name=None):
    """Overlapping frames along the last (``axis=-1``: ``[..., T]`` ->
    ``[..., frame_length, n]``) or first axis (``axis=0``: ``[T, ...]``
    -> ``[n, frame_length, ...]``)."""
    _check(hop_length, axis)
    x = _t(x)
    seq_len = x.shape[-1] if axis == -1 else x.shape[0]
    n = _num_frames(seq_len, frame_length, hop_length)
    idx = _grid(frame_length, hop_length, n, x.device)
    if axis == -1:
        return x[..., idx]
    return torch.movedim(x[idx], 0, 1)


def overlap_add(x, hop_length: int, axis: int = -1, name=None):
    """The inverse of :func:`frame`: overlapping frames summed.
    ``axis=-1``: ``[..., frame_length, n]`` -> ``[..., out]``;
    ``axis=0``: ``[n, frame_length, ...]`` -> ``[out, ...]``; ``out =
    (n - 1)·hop + frame_length``."""
    _check(hop_length, axis)
    x = _t(x)
    if axis == 0:
        moved = torch.movedim(x, (0, 1), (-1, -2))
        return torch.movedim(overlap_add(moved, hop_length, axis=-1), -1, 0)
    frame_length, n = x.shape[-2], x.shape[-1]
    out_len = (n - 1) * hop_length + frame_length
    pos = _grid(frame_length, hop_length, n, x.device).reshape(-1)
    out = torch.zeros(x.shape[:-2] + (out_len,), dtype=x.dtype,
                      device=x.device)
    return out.index_add(-1, pos, x.reshape(x.shape[:-2] + (-1,)))


def _resolve_window(window, win_length: int, n_fft: int, dtype, device):
    if window is None:
        w = torch.ones((win_length,), dtype=dtype, device=device)
    else:
        w = _t(window).to(device=device, dtype=dtype)
        if tuple(w.shape) != (win_length,):
            raise ValueError(
                f"window must have shape ({win_length},), got "
                f"{tuple(w.shape)}")
    pad = n_fft - win_length
    if pad > 0:  # centre the window in the FFT frame
        w = torch.nn.functional.pad(w, (pad // 2, pad - pad // 2))
    return w


def _pad_last(x: torch.Tensor, pad: int, mode: str) -> torch.Tensor:
    """``jnp.pad`` of the last axis by ``pad`` at both ends: the zeros of
    ``"constant"``, else ``np.pad``'s index map in ``mode``."""
    if mode == "constant":
        return torch.nn.functional.pad(x, (pad, pad))
    idx = np.pad(np.arange(x.shape[-1]), pad, mode=mode)
    return x[..., torch.as_tensor(idx, device=x.device)]


def stft(x, n_fft: int, hop_length: Optional[int] = None,
         win_length: Optional[int] = None, window=None, center: bool = True,
         pad_mode: str = "reflect", normalized: bool = False,
         onesided: bool = True, name=None):
    """The short-time Fourier transform of a real or complex signal:
    ``[..., T]`` -> ``[..., n_fft // 2 + 1`` (or ``n_fft``), ``frames]``."""
    x = _t(x)
    hop_length = n_fft // 4 if hop_length is None else hop_length
    win_length = n_fft if win_length is None else win_length
    if not 0 < win_length <= n_fft:
        raise ValueError(
            f"win_length must be in (0, {n_fft}], got {win_length}")
    is_complex = x.is_complex()
    if is_complex and onesided:
        raise ValueError("onesided must be False for complex inputs")
    real = x.real.dtype if is_complex else x.dtype
    w = _resolve_window(window, win_length, n_fft, real, x.device)
    if center:
        x = _pad_last(x, n_fft // 2, pad_mode)
    frames = frame(x, n_fft, hop_length, axis=-1) * w[:, None]
    if onesided and not is_complex:
        spec = torch.fft.rfft(frames, n=n_fft, dim=-2)
    else:
        spec = torch.fft.fft(frames, n=n_fft, dim=-2)
    if normalized:
        spec = spec / torch.tensor(n_fft, dtype=real,
                                   device=x.device).sqrt()
    return spec


def istft(x, n_fft: int, hop_length: Optional[int] = None,
          win_length: Optional[int] = None, window=None, center: bool = True,
          normalized: bool = False, onesided: bool = True,
          length: Optional[int] = None, return_complex: bool = False,
          name=None):
    """The inverse STFT: ``[..., n_fft // 2 + 1`` (or ``n_fft``),
    ``frames]`` -> ``[..., out]``, JAX's least-squares window
    compensation (see the module docstring)."""
    x = _t(x)
    hop_length = n_fft // 4 if hop_length is None else hop_length
    win_length = n_fft if win_length is None else win_length
    n_bins = x.shape[-2]
    expected = n_fft // 2 + 1 if onesided else n_fft
    if n_bins != expected:
        raise ValueError(f"expected {expected} frequency bins, got {n_bins}")
    rdtype = x.real.dtype if x.is_complex() else x.dtype
    w = _resolve_window(window, win_length, n_fft, rdtype, x.device)
    if normalized:
        x = x * torch.tensor(n_fft, dtype=rdtype, device=x.device).sqrt()
    if onesided:
        frames = torch.fft.irfft(x, n=n_fft, dim=-2)
    else:
        frames = torch.fft.ifft(x, n=n_fft, dim=-2)
        if not return_complex:
            frames = frames.real
    out = overlap_add(frames * w[:, None], hop_length, axis=-1)
    n = x.shape[-1]
    denom = overlap_add((w * w)[:, None].expand(n_fft, n), hop_length,
                        axis=-1)
    out = out / torch.where(denom > 1e-11, denom, torch.ones_like(denom))
    if center:
        pad = n_fft // 2
        out = out[..., pad:out.shape[-1] - pad]
    if length is not None:
        if out.shape[-1] < length:
            out = torch.nn.functional.pad(out, (0, length - out.shape[-1]))
        else:
            out = out[..., :length]
    return out
