"""Audio file IO of the port (``paddle_tpu/audio/backends.py``
counterpart): ``load``, ``save`` and ``info``.

The default backend reads and writes PCM WAV (8-bit unsigned, 16- and
32-bit signed) through the standard library's ``wave``; where
``soundfile`` is installed it is preferred and adds its other formats, as
in JAX. File IO is host-side: ``load`` returns a host tensor.
"""

from __future__ import annotations

import wave as _wave
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

__all__ = ["AudioInfo", "load", "save", "info", "list_available_backends",
           "get_current_backend", "set_backend"]


@dataclass
class AudioInfo:
    sample_rate: int
    num_samples: int
    num_channels: int
    bits_per_sample: int
    encoding: str = "PCM_S"


def _soundfile():
    try:
        import soundfile
        return soundfile
    except ImportError:
        return None


def list_available_backends():
    out = ["wave"]
    if _soundfile() is not None:
        out.append("soundfile")
    return out


_backend = "soundfile" if _soundfile() is not None else "wave"


def get_current_backend() -> str:
    return _backend


def set_backend(backend_name: str) -> None:
    global _backend
    if backend_name not in list_available_backends():
        raise ValueError(f"backend {backend_name!r} not available; have "
                         f"{list_available_backends()}")
    _backend = backend_name


_PCM = {1: np.uint8, 2: np.int16, 4: np.int32}


def load(filepath: str, frame_offset: int = 0, num_frames: int = -1,
         normalize: bool = True, channels_first: bool = True
         ) -> Tuple[torch.Tensor, int]:
    """Returns (waveform [C, T] (channels_first) float32 in [-1, 1] when
    normalized, sample_rate)."""
    if _backend == "soundfile":
        sf = _soundfile()
        if normalize:
            dtype = "float32"
        else:
            # match the file's native PCM width (the wave backend's
            # behavior) instead of force-truncating to int16
            subtype = (sf.info(filepath).subtype or "PCM_16").upper()
            dtype = "int32" if "32" in subtype else "int16"
        data, sr = sf.read(filepath, start=frame_offset,
                           frames=num_frames if num_frames > 0 else -1,
                           dtype=dtype, always_2d=True)
        wav = data.T if channels_first else data
        return torch.from_numpy(np.array(wav)), sr
    with _wave.open(filepath, "rb") as f:
        sr = f.getframerate()
        ch = f.getnchannels()
        width = f.getsampwidth()
        f.setpos(frame_offset)
        n = num_frames if num_frames > 0 else f.getnframes() - frame_offset
        raw = f.readframes(n)
    dtype = _PCM.get(width)
    if dtype is None:
        raise ValueError(f"unsupported PCM sample width {width}")
    data = np.frombuffer(raw, dtype=dtype).reshape(-1, ch)
    if normalize:
        if width == 1:
            data = (data.astype(np.float32) - 128.0) / 128.0
        else:
            data = data.astype(np.float32) / float(2 ** (8 * width - 1))
    wav = data.T if channels_first else data
    return torch.from_numpy(np.array(wav)), sr


def save(filepath: str, src, sample_rate: int, channels_first: bool = True,
         encoding: str = "PCM_S", bits_per_sample: int = 16) -> None:
    """Write PCM WAV. float input in [-1, 1] is quantized to the requested
    bit depth."""
    data = src.detach().cpu().numpy() if isinstance(src, torch.Tensor) \
        else np.asarray(src)
    if channels_first:
        data = data.T                               # [T, C]
    if data.ndim == 1:
        data = data[:, None]
    if bits_per_sample not in (8, 16, 32):
        raise ValueError(f"bits_per_sample must be 8/16/32, got "
                         f"{bits_per_sample}")
    target = _PCM[bits_per_sample // 8]
    if np.issubdtype(data.dtype, np.floating):
        data = np.clip(data, -1.0, 1.0)
        if bits_per_sample == 16:
            data = (data * 32767.0).astype(np.int16)
        elif bits_per_sample == 32:
            data = (data * 2147483647.0).astype(np.int32)
        else:
            data = ((data * 127.0) + 128.0).astype(np.uint8)
    elif data.dtype != target:
        raise ValueError(
            f"integer input dtype {data.dtype} does not match "
            f"bits_per_sample={bits_per_sample} (expected {target.__name__});"
            f" pass float samples in [-1, 1] or matching-width integers")
    with _wave.open(filepath, "wb") as f:
        f.setnchannels(data.shape[1])
        f.setsampwidth(bits_per_sample // 8)
        f.setframerate(sample_rate)
        f.writeframes(np.ascontiguousarray(data).tobytes())


def info(filepath: str) -> AudioInfo:
    if _backend == "soundfile":
        sf = _soundfile()
        i = sf.info(filepath)
        subtype = (i.subtype or "PCM_16").upper()
        bits = 32 if "32" in subtype else (8 if subtype.endswith("8")
                                           else 16)
        return AudioInfo(sample_rate=int(i.samplerate),
                         num_samples=int(i.frames),
                         num_channels=int(i.channels),
                         bits_per_sample=bits, encoding=i.subtype or "PCM_S")
    with _wave.open(filepath, "rb") as f:
        return AudioInfo(sample_rate=f.getframerate(),
                         num_samples=f.getnframes(),
                         num_channels=f.getnchannels(),
                         bits_per_sample=8 * f.getsampwidth())
