"""Vision datasets of the port (``paddle_tpu/vision/datasets``
counterpart): MNIST, FashionMNIST, Cifar10, Cifar100, Flowers,
DatasetFolder, ImageFolder and VOC2012, numpy code as in the JAX package.
Items are numpy arrays, made on the host (a DataLoader's workers index
them and never touch the card).

With a local ``image_path``/``label_path`` they read the standard IDX files
(gzipped or not). Otherwise they make a deterministic synthetic set, bit
for bit the JAX package's: class prototypes from ``default_rng(12345)``,
shared by the splits, and labels and noise from ``default_rng(0)`` for
``train`` and ``default_rng(1)`` for ``test``. Nothing is downloaded:
``download=True`` without local files raises. The CIFAR sets read the
python-pickle tarball or one batch file; without a file they, Flowers and
VOC2012 make JAX's synthetic sets bit for bit (``default_rng(54321)``
prototypes, ``default_rng(0)``/``(1)`` for the splits). ``DatasetFolder``
and ``ImageFolder`` read ``.npy`` files with numpy and other images
through PIL.
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


__all__ += ["Cifar10", "Cifar100", "Flowers", "DatasetFolder", "ImageFolder"]


class Cifar10(Dataset):
    """CIFAR-10: with ``data_file`` the python-pickle tarball (or one
    batch file), its images as float32 CHW in [0, 1]; otherwise JAX's
    synthetic set (class prototypes plus noise, the splits sharing the
    prototypes, as MNIST's do)."""

    _n_classes = 10

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 transform=None, download: bool = False,
                 backend: str = "numpy", synthetic_size: Optional[int] = None):
        self.transform = transform
        if data_file and os.path.exists(data_file):
            self.images, self.labels = self._load_real(data_file, mode)
        else:
            n = synthetic_size or (5000 if mode == "train" else 1000)
            base = np.random.default_rng(54321).standard_normal(
                (self._n_classes, 3, 32, 32)).astype(np.float32)
            rng = np.random.default_rng(0 if mode == "train" else 1)
            self.labels = rng.integers(0, self._n_classes,
                                       size=(n,)).astype(np.int64)
            noise = 0.3 * rng.standard_normal((n, 3, 32, 32)) \
                .astype(np.float32)
            self.images = base[self.labels] + noise

    def _load_real(self, data_file, mode):
        import pickle
        import tarfile
        label_key = b"labels" if self._n_classes == 10 else b"fine_labels"
        imgs, labels = [], []

        def want(name):
            if self._n_classes == 10:
                return ("data_batch" in name) if mode == "train" \
                    else ("test_batch" in name)
            return name.endswith("train" if mode == "train" else "test")

        if tarfile.is_tarfile(data_file):
            with tarfile.open(data_file) as tf:
                for m in tf.getmembers():
                    if m.isfile() and want(m.name):
                        d = pickle.load(tf.extractfile(m), encoding="bytes")
                        imgs.append(d[b"data"])
                        labels.extend(d[label_key])
        else:
            with open(data_file, "rb") as f:
                d = pickle.load(f, encoding="bytes")
            imgs.append(d[b"data"])
            labels.extend(d[label_key])
        images = np.concatenate(imgs).reshape(-1, 3, 32, 32) \
            .astype(np.float32) / 255.0
        return images, np.asarray(labels, dtype=np.int64)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]

    def __len__(self):
        return len(self.labels)


class Cifar100(Cifar10):
    _n_classes = 100


class Flowers(Cifar10):
    """Flowers102's 102 classes, synthetic only: the real ``.mat`` files
    are not read (passing one raises, as in JAX)."""

    _n_classes = 102

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode: str = "train", transform=None, download: bool = False,
                 backend: str = "numpy", synthetic_size: Optional[int] = None):
        if data_file or label_file or setid_file:
            raise NotImplementedError(
                "Flowers: reading the real .mat files is not supported in "
                "this build (no scipy.io loader wired); only the synthetic "
                "mode is available — do not pass data/label/setid files")
        super().__init__(data_file=None, mode=mode, transform=transform,
                         synthetic_size=synthetic_size or
                         (1020 if mode == "train" else 102))


def _default_loader(path: str):
    if path.endswith(".npy"):
        return np.load(path)
    try:
        import PIL.Image
        with PIL.Image.open(path) as img:
            return np.asarray(img.convert("RGB"))
    except ImportError as e:
        raise RuntimeError(
            f"cannot load {path}: PIL unavailable and not a .npy file") from e


IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".npy")


class DatasetFolder(Dataset):
    """A folder a class: ``root/<class>/<file>`` gives ``(sample,
    class_index)``, the classes and files in sorted order."""

    def __init__(self, root: str, loader=None, extensions=None,
                 transform=None, is_valid_file=None):
        self.root = root
        self.loader = loader or _default_loader
        self.transform = transform
        extensions = tuple(extensions) if extensions else IMG_EXTENSIONS
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        if not classes:
            raise RuntimeError(f"no class directories under {root}")
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for dirpath, _, files in sorted(os.walk(cdir)):
                for fname in sorted(files):
                    path = os.path.join(dirpath, fname)
                    ok = is_valid_file(path) if is_valid_file else \
                        fname.lower().endswith(extensions)
                    if ok:
                        self.samples.append((path, self.class_to_idx[c]))
        if not self.samples:
            raise RuntimeError(f"no valid files found under {root}")

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        sample = self.loader(path)
        if self.transform is not None:
            sample = self.transform(sample)
        return sample, target

    def __len__(self):
        return len(self.samples)


class ImageFolder(Dataset):
    """Every image under ``root``, unlabelled: ``[sample]`` an item."""

    def __init__(self, root: str, loader=None, extensions=None,
                 transform=None, is_valid_file=None):
        self.root = root
        self.loader = loader or _default_loader
        self.transform = transform
        extensions = tuple(extensions) if extensions else IMG_EXTENSIONS
        self.samples = []
        for dirpath, _, files in sorted(os.walk(root)):
            for fname in sorted(files):
                path = os.path.join(dirpath, fname)
                ok = is_valid_file(path) if is_valid_file else \
                    fname.lower().endswith(extensions)
                if ok:
                    self.samples.append(path)
        if not self.samples:
            raise RuntimeError(f"no valid files found under {root}")

    def __getitem__(self, idx):
        sample = self.loader(self.samples[idx])
        if self.transform is not None:
            sample = self.transform(sample)
        return [sample]

    def __len__(self):
        return len(self.samples)


class VOC2012(Dataset):
    """Segmentation pairs (image, label mask), synthetic as in JAX:
    coloured rectangles on noise with their class masks, drawn from
    ``default_rng(0)`` (train) or ``(1)``."""

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 transform=None, download: bool = True,
                 backend: str = "numpy", synthetic_size: Optional[int] = None):
        self.mode = mode
        self.transform = transform
        n = synthetic_size or (100 if mode == "train" else 20)
        rng = np.random.default_rng(0 if mode == "train" else 1)
        self._images = []
        self._labels = []
        for _ in range(n):
            img = rng.integers(0, 64, (64, 64, 3)).astype(np.uint8)
            mask = np.zeros((64, 64), np.uint8)
            for _ in range(int(rng.integers(1, 4))):
                cls = int(rng.integers(1, 21))
                y0, x0 = rng.integers(0, 40, 2)
                hh, ww = rng.integers(8, 24, 2)
                img[y0:y0 + hh, x0:x0 + ww] = (cls * 12) % 255
                mask[y0:y0 + hh, x0:x0 + ww] = cls
            self._images.append(img)
            self._labels.append(mask)

    def __getitem__(self, idx):
        img, mask = self._images[idx], self._labels[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, mask

    def __len__(self):
        return len(self._images)


__all__ += ["VOC2012"]
