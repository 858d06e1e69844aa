"""``paddle.audio.datasets`` of the port (``paddle_tpu/audio/datasets.py``
counterpart): TESS and ESC50 as JAX makes them, synthetic (a tone a class
plus noise, one second at 16 kHz, from ``default_rng(0)`` for train and
``(1)`` otherwise). With ``feat_type`` other than ``"raw"`` an item is the
port's :class:`~.features.LogMelSpectrogram` of its wave, computed on the
host (a DataLoader's workers never touch the card): JAX gives the log-mel
spectrogram for every such ``feat_type``, and so does the port.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..io.dataset import Dataset

__all__ = ["TESS", "ESC50"]


class _SyntheticAudio(Dataset):
    n_classes = 10
    sample_rate = 16000

    def __init__(self, mode: str = "train", feat_type: str = "raw",
                 archive=None, synthetic_size: Optional[int] = None,
                 **kwargs):
        self.mode = mode
        self.feat_type = feat_type
        n = synthetic_size or (80 if mode == "train" else 20)
        rng = np.random.default_rng(0 if mode == "train" else 1)
        self._labels = rng.integers(0, self.n_classes, n)
        t = np.arange(self.sample_rate) / self.sample_rate
        self._waves = [
            (0.5 * np.sin(2 * np.pi * (220 + 40 * lbl) * t)
             + 0.05 * rng.standard_normal(self.sample_rate)
             ).astype(np.float32)
            for lbl in self._labels]
        self._feature = None

    def __getitem__(self, idx):
        wav = self._waves[idx]
        if self.feat_type != "raw":
            if self._feature is None:
                from .features import LogMelSpectrogram
                self._feature = LogMelSpectrogram(sr=self.sample_rate,
                                                  device="cpu")
            wav = self._feature(torch.from_numpy(wav[None]))[0].numpy()
        return wav, int(self._labels[idx])

    def __len__(self):
        return len(self._waves)


class TESS(_SyntheticAudio):
    """The Toronto emotional speech set's 7 classes."""
    n_classes = 7


class ESC50(_SyntheticAudio):
    """ESC-50's 50 environmental-sound classes."""
    n_classes = 50
