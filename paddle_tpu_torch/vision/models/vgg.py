"""VGG 11/13/16/19, with or without BatchNorm
(``paddle_tpu/vision/models/vgg.py`` counterpart; conventions as in
:mod:`.alexnet`)."""

from __future__ import annotations

from ... import nn
from ...core.device import device_guard

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19"]

# conv output channels, "M" a 2x2 max pool
_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
          512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
          512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
          512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


def _make_features(cfg, batch_norm: bool):
    layers, in_ch = [], 3
    for v in cfg:
        if v == "M":
            layers.append(nn.MaxPool2D(2, stride=2))
            continue
        layers.append(nn.Conv2D(in_ch, v, 3, padding=1))
        if batch_norm:
            layers.append(nn.BatchNorm2D(v))
        layers.append(nn.ReLU())
        in_ch = v
    return nn.Sequential(*layers)


class VGG(nn.Layer):
    """``features`` (a Sequential, built on its own device), then the
    pool and the classifier on ``device``."""

    def __init__(self, features, num_classes: int = 1000,
                 with_pool: bool = True, *, device=None):
        super().__init__()
        self.features = features
        self.num_classes = num_classes
        self.with_pool = with_pool
        with device_guard(device):
            if with_pool:
                self.avgpool = nn.AdaptiveAvgPool2D((7, 7))
            if num_classes > 0:
                self.classifier = nn.Sequential(
                    nn.Linear(512 * 7 * 7, 4096), nn.ReLU(), nn.Dropout(),
                    nn.Linear(4096, 4096), nn.ReLU(), nn.Dropout(),
                    nn.Linear(4096, num_classes),
                )

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(x.reshape(x.shape[0], -1))
        return x


def _vgg(cfg, batch_norm, device=None, **kwargs):
    with device_guard(device) as dev:
        return VGG(_make_features(_CFGS[cfg], batch_norm), device=dev,
                   **kwargs)


def vgg11(pretrained: bool = False, batch_norm: bool = False, **kwargs):
    return _vgg("A", batch_norm, **kwargs)


def vgg13(pretrained: bool = False, batch_norm: bool = False, **kwargs):
    return _vgg("B", batch_norm, **kwargs)


def vgg16(pretrained: bool = False, batch_norm: bool = False, **kwargs):
    return _vgg("D", batch_norm, **kwargs)


def vgg19(pretrained: bool = False, batch_norm: bool = False, **kwargs):
    return _vgg("E", batch_norm, **kwargs)
