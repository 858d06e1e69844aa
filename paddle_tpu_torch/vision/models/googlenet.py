"""GoogLeNet / Inception v1 (``paddle_tpu/vision/models/googlenet.py``
counterpart; conventions as in :mod:`.alexnet`). With classes the forward
returns ``(main, aux1, aux2)`` logits, as JAX's does; the aux heads'
``fc1``/``fc2`` are Linears (convert with ``module=``)."""

from __future__ import annotations

import torch

from ... import nn
from ...core.device import device_guard

__all__ = ["GoogLeNet", "googlenet"]


def _conv_relu(in_ch, out_ch, kernel, stride=1, padding=0):
    return nn.Sequential(
        nn.Conv2D(in_ch, out_ch, kernel, stride=stride, padding=padding),
        nn.ReLU())


class Inception(nn.Layer):
    def __init__(self, in_ch, c1, c3r, c3, c5r, c5, proj):
        super().__init__()
        self.b1 = _conv_relu(in_ch, c1, 1)
        self.b2 = nn.Sequential(_conv_relu(in_ch, c3r, 1),
                                _conv_relu(c3r, c3, 3, padding=1))
        self.b3 = nn.Sequential(_conv_relu(in_ch, c5r, 1),
                                _conv_relu(c5r, c5, 5, padding=2))
        self.b4 = nn.Sequential(nn.MaxPool2D(3, stride=1, padding=1),
                                _conv_relu(in_ch, proj, 1))

    def forward(self, x):
        return torch.cat([self.b1(x), self.b2(x), self.b3(x), self.b4(x)],
                         dim=1)


class _AuxHead(nn.Layer):
    def __init__(self, in_ch, num_classes):
        super().__init__()
        self.pool = nn.AdaptiveAvgPool2D((4, 4))
        self.conv = _conv_relu(in_ch, 128, 1)
        self.fc1 = nn.Linear(128 * 4 * 4, 1024)
        self.relu = nn.ReLU()
        self.dropout = nn.Dropout(0.7)
        self.fc2 = nn.Linear(1024, num_classes)

    def forward(self, x):
        x = self.conv(self.pool(x))
        x = x.reshape(x.shape[0], -1)
        return self.fc2(self.dropout(self.relu(self.fc1(x))))


class GoogLeNet(nn.Layer):
    def __init__(self, num_classes: int = 1000, with_pool: bool = True, *,
                 device=None):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        with device_guard(device):
            self.stem = nn.Sequential(
                _conv_relu(3, 64, 7, stride=2, padding=3),
                nn.MaxPool2D(3, stride=2, padding=1),
                _conv_relu(64, 64, 1),
                _conv_relu(64, 192, 3, padding=1),
                nn.MaxPool2D(3, stride=2, padding=1))
            self.inc3a = Inception(192, 64, 96, 128, 16, 32, 32)
            self.inc3b = Inception(256, 128, 128, 192, 32, 96, 64)
            self.pool3 = nn.MaxPool2D(3, stride=2, padding=1)
            self.inc4a = Inception(480, 192, 96, 208, 16, 48, 64)
            self.inc4b = Inception(512, 160, 112, 224, 24, 64, 64)
            self.inc4c = Inception(512, 128, 128, 256, 24, 64, 64)
            self.inc4d = Inception(512, 112, 144, 288, 32, 64, 64)
            self.inc4e = Inception(528, 256, 160, 320, 32, 128, 128)
            self.pool4 = nn.MaxPool2D(3, stride=2, padding=1)
            self.inc5a = Inception(832, 256, 160, 320, 32, 128, 128)
            self.inc5b = Inception(832, 384, 192, 384, 48, 128, 128)
            if with_pool:
                self.pool5 = nn.AdaptiveAvgPool2D((1, 1))
            if num_classes > 0:
                self.dropout = nn.Dropout(0.4)
                self.fc = nn.Linear(1024, num_classes)
                self.aux1 = _AuxHead(512, num_classes)
                self.aux2 = _AuxHead(528, num_classes)

    def forward(self, x):
        x = self.stem(x)
        x = self.pool3(self.inc3b(self.inc3a(x)))
        x = self.inc4a(x)
        aux1 = self.aux1(x) if self.num_classes > 0 else None
        x = self.inc4d(self.inc4c(self.inc4b(x)))
        aux2 = self.aux2(x) if self.num_classes > 0 else None
        x = self.pool4(self.inc4e(x))
        x = self.inc5b(self.inc5a(x))
        if self.with_pool:
            x = self.pool5(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(x.reshape(x.shape[0], -1)))
            return x, aux1, aux2
        return x


def googlenet(pretrained: bool = False, **kwargs):
    return GoogLeNet(**kwargs)
