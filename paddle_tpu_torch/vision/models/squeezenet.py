"""SqueezeNet 1.0 and 1.1 (``paddle_tpu/vision/models/squeezenet.py``
counterpart; conventions as in :mod:`.alexnet`)."""

from __future__ import annotations

import torch

from ... import nn
from ...core.device import device_guard

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class Fire(nn.Layer):
    def __init__(self, in_ch, squeeze_ch, e1_ch, e3_ch):
        super().__init__()
        self.squeeze = nn.Conv2D(in_ch, squeeze_ch, 1)
        self.relu = nn.ReLU()
        self.expand1 = nn.Conv2D(squeeze_ch, e1_ch, 1)
        self.expand3 = nn.Conv2D(squeeze_ch, e3_ch, 3, padding=1)

    def forward(self, x):
        s = self.relu(self.squeeze(x))
        return torch.cat([self.relu(self.expand1(s)),
                          self.relu(self.expand3(s))], dim=1)


class SqueezeNet(nn.Layer):
    def __init__(self, version: str = "1.0", num_classes: int = 1000,
                 with_pool: bool = True, *, device=None):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        if version not in ("1.0", "1.1"):
            raise ValueError(f"unknown SqueezeNet version {version!r}")
        with device_guard(device):
            if version == "1.0":
                self.features = nn.Sequential(
                    nn.Conv2D(3, 96, 7, stride=2), nn.ReLU(),
                    nn.MaxPool2D(3, stride=2),
                    Fire(96, 16, 64, 64), Fire(128, 16, 64, 64),
                    Fire(128, 32, 128, 128), nn.MaxPool2D(3, stride=2),
                    Fire(256, 32, 128, 128), Fire(256, 48, 192, 192),
                    Fire(384, 48, 192, 192), Fire(384, 64, 256, 256),
                    nn.MaxPool2D(3, stride=2), Fire(512, 64, 256, 256),
                )
            else:
                self.features = nn.Sequential(
                    nn.Conv2D(3, 64, 3, stride=2), nn.ReLU(),
                    nn.MaxPool2D(3, stride=2),
                    Fire(64, 16, 64, 64), Fire(128, 16, 64, 64),
                    nn.MaxPool2D(3, stride=2),
                    Fire(128, 32, 128, 128), Fire(256, 32, 128, 128),
                    nn.MaxPool2D(3, stride=2),
                    Fire(256, 48, 192, 192), Fire(384, 48, 192, 192),
                    Fire(384, 64, 256, 256), Fire(512, 64, 256, 256),
                )
            if num_classes > 0:
                self.classifier = nn.Sequential(
                    nn.Dropout(0.5), nn.Conv2D(512, num_classes, 1),
                    nn.ReLU())
            if with_pool:
                self.pool = nn.AdaptiveAvgPool2D((1, 1))

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = self.classifier(x)
        if self.with_pool:
            x = self.pool(x)
            x = x.reshape(x.shape[0], -1)
        return x


def squeezenet1_0(pretrained: bool = False, **kwargs):
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(pretrained: bool = False, **kwargs):
    return SqueezeNet("1.1", **kwargs)
