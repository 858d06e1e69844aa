"""Inception v3 (``paddle_tpu/vision/models/inceptionv3.py`` counterpart;
its published input is 299x299; conventions as in :mod:`.alexnet`)."""

from __future__ import annotations

import torch

from ... import nn
from ...core.device import device_guard

__all__ = ["InceptionV3", "inception_v3"]


def _conv_bn(in_ch, out_ch, kernel, stride=1, padding=0):
    return nn.Sequential(
        nn.Conv2D(in_ch, out_ch, kernel, stride=stride, padding=padding,
                  bias_attr=False),
        nn.BatchNorm2D(out_ch), nn.ReLU())


class InceptionA(nn.Layer):
    def __init__(self, in_ch, pool_features):
        super().__init__()
        self.b1 = _conv_bn(in_ch, 64, 1)
        self.b5 = nn.Sequential(_conv_bn(in_ch, 48, 1),
                                _conv_bn(48, 64, 5, padding=2))
        self.b3 = nn.Sequential(_conv_bn(in_ch, 64, 1),
                                _conv_bn(64, 96, 3, padding=1),
                                _conv_bn(96, 96, 3, padding=1))
        self.bp = nn.Sequential(nn.AvgPool2D(3, stride=1, padding=1),
                                _conv_bn(in_ch, pool_features, 1))

    def forward(self, x):
        return torch.cat([self.b1(x), self.b5(x), self.b3(x), self.bp(x)],
                         dim=1)


class InceptionB(nn.Layer):  # grid reduction 35 -> 17
    def __init__(self, in_ch):
        super().__init__()
        self.b3 = _conv_bn(in_ch, 384, 3, stride=2)
        self.b3d = nn.Sequential(_conv_bn(in_ch, 64, 1),
                                 _conv_bn(64, 96, 3, padding=1),
                                 _conv_bn(96, 96, 3, stride=2))
        self.pool = nn.MaxPool2D(3, stride=2)

    def forward(self, x):
        return torch.cat([self.b3(x), self.b3d(x), self.pool(x)], dim=1)


class InceptionC(nn.Layer):  # factorized 7x7
    def __init__(self, in_ch, ch7):
        super().__init__()
        self.b1 = _conv_bn(in_ch, 192, 1)
        self.b7 = nn.Sequential(
            _conv_bn(in_ch, ch7, 1),
            _conv_bn(ch7, ch7, (1, 7), padding=(0, 3)),
            _conv_bn(ch7, 192, (7, 1), padding=(3, 0)))
        self.b7d = nn.Sequential(
            _conv_bn(in_ch, ch7, 1),
            _conv_bn(ch7, ch7, (7, 1), padding=(3, 0)),
            _conv_bn(ch7, ch7, (1, 7), padding=(0, 3)),
            _conv_bn(ch7, ch7, (7, 1), padding=(3, 0)),
            _conv_bn(ch7, 192, (1, 7), padding=(0, 3)))
        self.bp = nn.Sequential(nn.AvgPool2D(3, stride=1, padding=1),
                                _conv_bn(in_ch, 192, 1))

    def forward(self, x):
        return torch.cat([self.b1(x), self.b7(x), self.b7d(x), self.bp(x)],
                         dim=1)


class InceptionD(nn.Layer):  # grid reduction 17 -> 8
    def __init__(self, in_ch):
        super().__init__()
        self.b3 = nn.Sequential(_conv_bn(in_ch, 192, 1),
                                _conv_bn(192, 320, 3, stride=2))
        self.b7 = nn.Sequential(
            _conv_bn(in_ch, 192, 1),
            _conv_bn(192, 192, (1, 7), padding=(0, 3)),
            _conv_bn(192, 192, (7, 1), padding=(3, 0)),
            _conv_bn(192, 192, 3, stride=2))
        self.pool = nn.MaxPool2D(3, stride=2)

    def forward(self, x):
        return torch.cat([self.b3(x), self.b7(x), self.pool(x)], dim=1)


class InceptionE(nn.Layer):  # expanded filter bank
    def __init__(self, in_ch):
        super().__init__()
        self.b1 = _conv_bn(in_ch, 320, 1)
        self.b3_stem = _conv_bn(in_ch, 384, 1)
        self.b3_a = _conv_bn(384, 384, (1, 3), padding=(0, 1))
        self.b3_b = _conv_bn(384, 384, (3, 1), padding=(1, 0))
        self.b3d_stem = nn.Sequential(_conv_bn(in_ch, 448, 1),
                                      _conv_bn(448, 384, 3, padding=1))
        self.b3d_a = _conv_bn(384, 384, (1, 3), padding=(0, 1))
        self.b3d_b = _conv_bn(384, 384, (3, 1), padding=(1, 0))
        self.bp = nn.Sequential(nn.AvgPool2D(3, stride=1, padding=1),
                                _conv_bn(in_ch, 192, 1))

    def forward(self, x):
        s = self.b3_stem(x)
        d = self.b3d_stem(x)
        return torch.cat([self.b1(x),
                          torch.cat([self.b3_a(s), self.b3_b(s)], dim=1),
                          torch.cat([self.b3d_a(d), self.b3d_b(d)], dim=1),
                          self.bp(x)], dim=1)


class InceptionV3(nn.Layer):
    def __init__(self, num_classes: int = 1000, with_pool: bool = True, *,
                 device=None):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        with device_guard(device):
            self.stem = nn.Sequential(
                _conv_bn(3, 32, 3, stride=2),
                _conv_bn(32, 32, 3),
                _conv_bn(32, 64, 3, padding=1),
                nn.MaxPool2D(3, stride=2),
                _conv_bn(64, 80, 1),
                _conv_bn(80, 192, 3),
                nn.MaxPool2D(3, stride=2))
            self.blocks = nn.Sequential(
                InceptionA(192, 32), InceptionA(256, 64),
                InceptionA(288, 64), InceptionB(288),
                InceptionC(768, 128), InceptionC(768, 160),
                InceptionC(768, 160), InceptionC(768, 192),
                InceptionD(768), InceptionE(1280), InceptionE(2048))
            if with_pool:
                self.pool = nn.AdaptiveAvgPool2D((1, 1))
            if num_classes > 0:
                self.dropout = nn.Dropout(0.5)
                self.fc = nn.Linear(2048, num_classes)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(x.reshape(x.shape[0], -1)))
        return x


def inception_v3(pretrained: bool = False, **kwargs):
    return InceptionV3(**kwargs)
