"""Vision datasets of the port (``paddle_tpu/vision/datasets``
counterpart): MNIST and FashionMNIST, numpy code as in the JAX package.

With a local ``image_path``/``label_path`` they read the standard IDX files
(gzipped or not). Otherwise they make a deterministic synthetic set, bit
for bit the JAX package's: class prototypes from ``default_rng(12345)``,
shared by the splits, and labels and noise from ``default_rng(0)`` for
``train`` and ``default_rng(1)`` for ``test``. Nothing is downloaded:
``download=True`` without local files raises.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional

import numpy as np

from ...io.dataset import Dataset

__all__ = ["MNIST", "FashionMNIST"]


class MNIST(Dataset):
    def __init__(self, image_path: Optional[str] = None,
                 label_path: Optional[str] = None, mode: str = "train",
                 transform=None, download: bool = False,
                 backend: str = "numpy", synthetic_size: Optional[int] = None):
        self.transform = transform
        have_files = bool(image_path and os.path.exists(image_path))
        if download and not have_files:
            raise ValueError("MNIST(download=True): downloading is not "
                             "supported; pass local IDX files as "
                             "image_path/label_path, or use the synthetic "
                             "set (download=False)")
        if have_files:
            self.images = self._read_idx_images(image_path)
            self.labels = self._read_idx_labels(label_path)
        else:
            # Synthetic fallback: deterministic pseudo-MNIST. Class
            # prototypes are shared across train/test (fixed seed) so
            # generalization is measurable; noise/labels differ per split.
            n = synthetic_size or (6000 if mode == "train" else 1000)
            base = np.random.default_rng(12345).standard_normal(
                (10, 28, 28)).astype(np.float32)
            rng = np.random.default_rng(0 if mode == "train" else 1)
            self.labels = rng.integers(0, 10, size=(n,)).astype(np.int64)
            noise = 0.3 * rng.standard_normal((n, 28, 28)).astype(np.float32)
            self.images = base[self.labels] + noise

    @staticmethod
    def _read_idx_images(path):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            data = np.frombuffer(f.read(), dtype=np.uint8)
        return (data.reshape(n, rows, cols).astype(np.float32) / 255.0)

    @staticmethod
    def _read_idx_labels(path):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            magic, n = struct.unpack(">II", f.read(8))
            data = np.frombuffer(f.read(), dtype=np.uint8)
        return data.astype(np.int64)

    def __getitem__(self, idx):
        img = self.images[idx][None, :, :]  # CHW
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]

    def __len__(self):
        return len(self.labels)


class FashionMNIST(MNIST):
    pass
