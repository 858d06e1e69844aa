"""Vision transforms of the port (``paddle_tpu/vision/transforms``
counterpart): host-side numpy preprocessing, as in the JAX package, for a
DataLoader's workers to run.

Each random transform draws from its own ``numpy.random.Generator``, held
in ``_rng`` as in JAX, so a caller that sets ``_rng`` to a seeded
generator gets JAX's draws exactly. Two differences, each a fault of the
reference not copied:

- **Process workers draw streams of their own.** JAX's generators are made
  when the transform is built, so every forked DataLoader worker inherits
  the same state and all workers draw the same augmentations. Here a
  transform first used in a process other than the one that set its
  generator draws from a new one: ``default_rng([worker_seed, k])``, with
  ``worker_seed`` the worker's :func:`~...io.get_worker_info` seed and
  ``k`` the number of transforms that began drawing in that worker before
  it (fresh entropy in a process that is no DataLoader worker). A fixed
  base seed thus gives the same augmentations on a rerun.
- **``Resize`` is Paddle's.** JAX's class ignores ``interpolation``,
  makes an int ``size`` square and picks top-left nearest pixels; here it
  is :func:`functional.resize`: an int ``size`` sets the shorter edge, and
  ``interpolation`` (bilinear by default) is honoured.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from ...io.worker import get_worker_info
from . import functional as F
from .functional import (to_tensor, hflip, vflip, resize, pad,  # noqa: F401
                         affine, rotate, perspective, to_grayscale, crop,
                         center_crop, adjust_brightness, adjust_contrast,
                         adjust_hue, normalize, erase)

functional = F

__all__ = ["Compose", "Normalize", "ToTensor", "Resize",
           "RandomHorizontalFlip", "RandomCrop", "CenterCrop", "Transpose",
           "functional", "RandomVerticalFlip", "RandomResizedCrop",
           "RandomRotation", "ColorJitter", "BrightnessTransform",
           "ContrastTransform", "SaturationTransform", "HueTransform",
           "Grayscale", "Pad", "RandomErasing", "BaseTransform",
           "RandomAffine", "RandomPerspective", "to_tensor", "hflip",
           "vflip", "resize", "pad", "affine", "rotate", "perspective",
           "to_grayscale", "crop", "center_crop", "adjust_brightness",
           "adjust_contrast", "adjust_hue", "normalize", "erase"]

# the process whose streams _worker_generator has counted, and how many
_streams = {"pid": None, "count": 0}


def _worker_generator() -> np.random.Generator:
    """A generator for a transform that begins drawing in this process:
    the ``k``-th of this worker's, ``default_rng([worker_seed, k])``."""
    pid = os.getpid()
    if _streams["pid"] != pid:
        _streams.update(pid=pid, count=0)
    k = _streams["count"]
    _streams["count"] = k + 1
    info = get_worker_info()
    if info is None:
        return np.random.default_rng()
    return np.random.default_rng([info.seed, k])


class _Random:
    """A transform that draws: ``_rng`` is its generator, replaced by
    :func:`_worker_generator`'s on its first draw in another process."""

    def __init__(self):
        self._rng = np.random.default_rng()

    @property
    def _rng(self) -> np.random.Generator:
        if self._owner != os.getpid():
            self._rng = _worker_generator()
        return self._gen

    @_rng.setter
    def _rng(self, generator: np.random.Generator) -> None:
        self._gen = generator
        self._owner = os.getpid()


def _hw(arr):
    chw = arr.ndim == 3 and arr.shape[0] in (1, 3, 4)
    return (arr.shape[1:3] if chw else arr.shape[:2]), chw


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


class Normalize:
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False):
        self.mean = mean
        self.std = std
        self.data_format = data_format

    def __call__(self, img):
        return F.normalize(img, self.mean, self.std, self.data_format)


class ToTensor:
    """:func:`functional.to_tensor`: a float32 numpy array, as in JAX."""

    def __init__(self, data_format="CHW"):
        self.data_format = data_format

    def __call__(self, img):
        return F.to_tensor(img, self.data_format)


class Resize:
    """Paddle's ``Resize`` through :func:`functional.resize` (see the
    module docstring); a PIL image is taken as its numpy array."""

    def __init__(self, size, interpolation="bilinear"):
        self.size = size if isinstance(size, int) else tuple(size)
        self.interpolation = interpolation

    def __call__(self, img):
        return F.resize(np.asarray(img), self.size, self.interpolation)


class RandomHorizontalFlip(_Random):
    def __init__(self, prob: float = 0.5):
        super().__init__()
        self.prob = prob

    def __call__(self, img):
        if self._rng.random() < self.prob:
            return np.asarray(img)[..., ::-1].copy()
        return img


class RandomCrop(_Random):
    def __init__(self, size, padding=0):
        super().__init__()
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding

    def __call__(self, img):
        img = np.asarray(img)
        chw = img.ndim == 3 and img.shape[0] in (1, 3, 4)
        if self.padding:
            widths = [(0, 0)] * img.ndim
            if chw:
                widths[1] = widths[2] = (self.padding, self.padding)
            else:
                widths[0] = widths[1] = (self.padding, self.padding)
            img = np.pad(img, widths, mode="constant")
        h, w = img.shape[1:3] if chw else img.shape[:2]
        th, tw = self.size
        i = self._rng.integers(0, h - th + 1)
        j = self._rng.integers(0, w - tw + 1)
        if chw:
            return img[:, i:i + th, j:j + tw]
        return img[i:i + th, j:j + tw]


class CenterCrop:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img):
        img = np.asarray(img)
        (h, w), chw = _hw(img)
        th, tw = self.size
        i, j = (h - th) // 2, (w - tw) // 2
        if chw:
            return img[:, i:i + th, j:j + tw]
        return img[i:i + th, j:j + tw]


class Transpose:
    def __init__(self, order=(2, 0, 1)):
        self.order = order

    def __call__(self, img):
        return np.asarray(img).transpose(self.order)


class RandomVerticalFlip(_Random):
    def __init__(self, prob: float = 0.5):
        super().__init__()
        self.prob = prob

    def __call__(self, img):
        if self._rng.random() < self.prob:
            return F.vflip(img)
        return img


class RandomResizedCrop(_Random):
    """A crop of random area and aspect, resized to ``size``: up to 10
    draws, then the centred square."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3. / 4., 4. / 3.),
                 interpolation: str = "bilinear"):
        super().__init__()
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation

    def __call__(self, img):
        arr = np.asarray(img)
        (h, w), _ = _hw(arr)
        area = h * w
        for _ in range(10):
            target = self._rng.uniform(*self.scale) * area
            log_r = self._rng.uniform(np.log(self.ratio[0]),
                                      np.log(self.ratio[1]))
            aspect = np.exp(log_r)
            tw = int(round(np.sqrt(target * aspect)))
            th = int(round(np.sqrt(target / aspect)))
            if 0 < tw <= w and 0 < th <= h:
                i = int(self._rng.integers(0, h - th + 1))
                j = int(self._rng.integers(0, w - tw + 1))
                return F.resize(F.crop(arr, i, j, th, tw), self.size,
                                self.interpolation)
        return F.resize(F.center_crop(arr, min(h, w)), self.size,
                        self.interpolation)


class RandomRotation(_Random):
    def __init__(self, degrees, interpolation: str = "nearest",
                 expand: bool = False, center=None, fill=0):
        super().__init__()
        if isinstance(degrees, (int, float)):
            degrees = (-abs(degrees), abs(degrees))
        self.degrees = degrees
        self.interpolation = interpolation
        self.expand = expand
        self.center = center
        self.fill = fill

    def __call__(self, img):
        angle = float(self._rng.uniform(*self.degrees))
        return F.rotate(img, angle, self.interpolation, self.expand,
                        self.center, self.fill)


class BrightnessTransform(_Random):
    def __init__(self, value: float):
        super().__init__()
        self.value = value

    def _factor(self):
        return float(self._rng.uniform(max(0, 1 - self.value),
                                       1 + self.value))

    def __call__(self, img):
        return F.adjust_brightness(img, self._factor())


class ContrastTransform(BrightnessTransform):
    def __call__(self, img):
        return F.adjust_contrast(img, self._factor())


class SaturationTransform(BrightnessTransform):
    def __call__(self, img):
        return F.adjust_saturation(img, self._factor())


class HueTransform(_Random):
    def __init__(self, value: float):
        if not 0 <= value <= 0.5:
            raise ValueError(f"hue value must be in [0, 0.5], got {value}")
        super().__init__()
        self.value = value

    def __call__(self, img):
        return F.adjust_hue(img, float(self._rng.uniform(-self.value,
                                                         self.value)))


class ColorJitter(_Random):
    """Brightness, contrast, saturation and hue jitter in a random
    order."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self.transforms = []
        if brightness:
            self.transforms.append(BrightnessTransform(brightness))
        if contrast:
            self.transforms.append(ContrastTransform(contrast))
        if saturation:
            self.transforms.append(SaturationTransform(saturation))
        if hue:
            self.transforms.append(HueTransform(hue))

    def __call__(self, img):
        for idx in self._rng.permutation(len(self.transforms)):
            img = self.transforms[idx](img)
        return img


class Grayscale:
    def __init__(self, num_output_channels: int = 1):
        self.num_output_channels = num_output_channels

    def __call__(self, img):
        return F.to_grayscale(img, self.num_output_channels)


class Pad:
    def __init__(self, padding, fill=0, padding_mode: str = "constant"):
        self.padding, self.fill, self.padding_mode = padding, fill, padding_mode

    def __call__(self, img):
        return F.pad(img, self.padding, self.fill, self.padding_mode)


class RandomErasing(_Random):
    """A random rectangle set to ``value``."""

    def __init__(self, prob: float = 0.5, scale=(0.02, 0.33),
                 ratio=(0.3, 3.3), value=0):
        super().__init__()
        self.prob, self.scale, self.ratio, self.value = \
            prob, scale, ratio, value

    def __call__(self, img):
        if self._rng.random() >= self.prob:
            return img
        arr = np.asarray(img)
        (h, w), _ = _hw(arr)
        area = h * w
        for _ in range(10):
            target = self._rng.uniform(*self.scale) * area
            aspect = np.exp(self._rng.uniform(np.log(self.ratio[0]),
                                              np.log(self.ratio[1])))
            eh = int(round(np.sqrt(target * aspect)))
            ew = int(round(np.sqrt(target / aspect)))
            if eh < h and ew < w:
                i = int(self._rng.integers(0, h - eh + 1))
                j = int(self._rng.integers(0, w - ew + 1))
                return F.erase(arr, i, j, eh, ew, self.value)
        return arr


class BaseTransform:
    """A transform over ``keys``: a subclass implements ``_apply_image``
    and, for the other keys it changes, ``_apply_<key>``."""

    def __init__(self, keys=None):
        self.keys = keys or ("image",)

    def _apply_image(self, image):
        raise NotImplementedError

    def __call__(self, inputs):
        if not isinstance(inputs, (list, tuple)):
            return self._apply_image(inputs)
        outs = []
        for key, data in zip(self.keys, inputs):
            fn = getattr(self, f"_apply_{key}", None)
            outs.append(fn(data) if fn else data)
        return tuple(outs)


def _hw_last(arr):
    # RandomAffine's and RandomPerspective's own test, kept from JAX: a
    # last axis of at most 4 is HWC (or the array is 2-D), else CHW
    return (arr.shape[:2] if arr.ndim == 2 or arr.shape[-1] <= 4
            else arr.shape[1:3])


class RandomAffine(BaseTransform, _Random):
    """A random rotation, translation, scale and shear. JAX draws from a
    new unseeded generator each call; here from ``_rng``, in the same
    order: angle, (tx, ty), scale, shear."""

    def __init__(self, degrees, translate=None, scale=None, shear=None,
                 interpolation="nearest", fill=0, center=None, keys=None):
        BaseTransform.__init__(self, keys)
        _Random.__init__(self)
        self.degrees = (-degrees, degrees) if np.isscalar(degrees) \
            else tuple(degrees)
        self.translate = translate
        self.scale = scale
        self.shear = shear
        self.interpolation = interpolation
        self.fill = fill
        self.center = center

    def _apply_image(self, img):
        rng = self._rng
        angle = rng.uniform(*self.degrees)
        h, w = _hw_last(np.asarray(img))
        tx = ty = 0.0
        if self.translate is not None:
            tx = rng.uniform(-self.translate[0], self.translate[0]) * w
            ty = rng.uniform(-self.translate[1], self.translate[1]) * h
        sc = rng.uniform(*self.scale) if self.scale else 1.0
        sh = rng.uniform(*self.shear) if self.shear else 0.0
        return affine(img, angle, (tx, ty), sc, sh,
                      interpolation=self.interpolation, fill=self.fill,
                      center=self.center)


class RandomPerspective(BaseTransform, _Random):
    """A warp of the four corners by random displacements, with
    probability ``prob``; draws from ``_rng`` as :class:`RandomAffine`
    does."""

    def __init__(self, prob: float = 0.5, distortion_scale: float = 0.5,
                 interpolation="nearest", fill=0, keys=None):
        BaseTransform.__init__(self, keys)
        _Random.__init__(self)
        self.prob = prob
        self.distortion_scale = distortion_scale
        self.interpolation = interpolation
        self.fill = fill

    def _apply_image(self, img):
        rng = self._rng
        if rng.random() >= self.prob:
            return img
        h, w = _hw_last(np.asarray(img))
        d = self.distortion_scale
        dx = int(d * w / 2)
        dy = int(d * h / 2)
        start = [(0, 0), (w - 1, 0), (w - 1, h - 1), (0, h - 1)]
        end = [(rng.integers(0, dx + 1), rng.integers(0, dy + 1)),
               (w - 1 - rng.integers(0, dx + 1), rng.integers(0, dy + 1)),
               (w - 1 - rng.integers(0, dx + 1),
                h - 1 - rng.integers(0, dy + 1)),
               (rng.integers(0, dx + 1), h - 1 - rng.integers(0, dy + 1))]
        return perspective(img, start, end,
                           interpolation=self.interpolation, fill=self.fill)
