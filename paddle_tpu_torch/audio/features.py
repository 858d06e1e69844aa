"""``paddle.audio.features`` of the port (``paddle_tpu/audio/features.py``
counterpart): ``Spectrogram``, ``MelSpectrogram``, ``LogMelSpectrogram``
and ``MFCC`` as port layers, their window, filter bank and DCT basis
buffers. The STFT is :func:`~..signal.stft` (JAX's ``features.py`` frames,
windows and runs ``rfft`` itself, to the same formula); the mel and DCT
projections are matmuls. Each layer builds its buffers on ``device``
(None: the thread's, ``cuda:0`` by default), as the port's layers do.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..core.device import device_guard
from ..nn.layer import Layer
from ..signal import stft
from . import functional as AF

__all__ = ["Spectrogram", "MelSpectrogram", "LogMelSpectrogram", "MFCC"]


class Spectrogram(Layer):
    """``|STFT|^power``."""

    def __init__(self, n_fft: int = 512, hop_length: Optional[int] = None,
                 win_length: Optional[int] = None, window: str = "hann",
                 power: float = 2.0, center: bool = True,
                 pad_mode: str = "reflect", dtype: str = "float32", *,
                 device=None):
        super().__init__()
        self.n_fft = n_fft
        self.hop_length = hop_length or n_fft // 4
        self.win_length = win_length or n_fft
        self.power = power
        self.center = center
        self.pad_mode = pad_mode
        with device_guard(device):
            self.register_buffer(
                "window", AF.get_window(window, self.win_length,
                                        dtype=dtype))

    def forward(self, x):
        spec = stft(x, self.n_fft, self.hop_length, self.win_length,
                    self.window, self.center, self.pad_mode)
        return spec.abs() ** self.power


class MelSpectrogram(Layer):
    """The filter bank ``[n_mels, bins]`` times the spectrogram."""

    def __init__(self, sr: int = 22050, n_fft: int = 512,
                 hop_length: Optional[int] = None,
                 win_length: Optional[int] = None, window: str = "hann",
                 power: float = 2.0, center: bool = True,
                 pad_mode: str = "reflect", n_mels: int = 64,
                 f_min: float = 50.0, f_max: Optional[float] = None,
                 htk: bool = False, norm: Union[str, float] = "slaney",
                 dtype: str = "float32", *, device=None):
        super().__init__()
        self.spectrogram = Spectrogram(n_fft, hop_length, win_length, window,
                                       power, center, pad_mode, dtype,
                                       device=device)
        with device_guard(device):
            self.register_buffer(
                "fbank", AF.compute_fbank_matrix(sr, n_fft, n_mels, f_min,
                                                 f_max, htk, norm, dtype))

    def forward(self, x):
        return torch.matmul(self.fbank, self.spectrogram(x))


class LogMelSpectrogram(Layer):
    """:func:`~.functional.power_to_db` of the mel spectrogram."""

    def __init__(self, sr: int = 22050, n_fft: int = 512,
                 hop_length: Optional[int] = None,
                 win_length: Optional[int] = None, window: str = "hann",
                 power: float = 2.0, center: bool = True,
                 pad_mode: str = "reflect", n_mels: int = 64,
                 f_min: float = 50.0, f_max: Optional[float] = None,
                 htk: bool = False, norm: Union[str, float] = "slaney",
                 ref_value: float = 1.0, amin: float = 1e-10,
                 top_db: Optional[float] = None, dtype: str = "float32", *,
                 device=None):
        super().__init__()
        self.mel = MelSpectrogram(sr, n_fft, hop_length, win_length, window,
                                  power, center, pad_mode, n_mels, f_min,
                                  f_max, htk, norm, dtype, device=device)
        self.ref_value, self.amin, self.top_db = ref_value, amin, top_db

    def forward(self, x):
        return AF.power_to_db(self.mel(x), self.ref_value, self.amin,
                              self.top_db)


class MFCC(Layer):
    """The DCT basis' transpose times the log-mel spectrogram."""

    def __init__(self, sr: int = 22050, n_mfcc: int = 40, n_fft: int = 512,
                 hop_length: Optional[int] = None,
                 win_length: Optional[int] = None, window: str = "hann",
                 power: float = 2.0, center: bool = True,
                 pad_mode: str = "reflect", n_mels: int = 64,
                 f_min: float = 50.0, f_max: Optional[float] = None,
                 htk: bool = False, norm: Union[str, float] = "slaney",
                 ref_value: float = 1.0, amin: float = 1e-10,
                 top_db: Optional[float] = None, dtype: str = "float32", *,
                 device=None):
        super().__init__()
        self.log_mel = LogMelSpectrogram(sr, n_fft, hop_length, win_length,
                                         window, power, center, pad_mode,
                                         n_mels, f_min, f_max, htk, norm,
                                         ref_value, amin, top_db, dtype,
                                         device=device)
        with device_guard(device):
            self.register_buffer("dct", AF.create_dct(n_mfcc, n_mels,
                                                      dtype=dtype))

    def forward(self, x):
        return torch.matmul(self.dct.T, self.log_mel(x))
