"""DenseNet 121/161/169/201/264 (``paddle_tpu/vision/models/densenet.py``
counterpart; conventions as in :mod:`.alexnet`)."""

from __future__ import annotations

import torch

from ... import nn
from ...core.device import device_guard

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201", "densenet264"]

# layers: (initial features, growth rate, layers of each dense block)
_CFGS = {
    121: (64, 32, (6, 12, 24, 16)),
    161: (96, 48, (6, 12, 36, 24)),
    169: (64, 32, (6, 12, 32, 32)),
    201: (64, 32, (6, 12, 48, 32)),
    264: (64, 32, (6, 12, 64, 48)),
}


class _DenseLayer(nn.Layer):
    def __init__(self, in_ch, growth_rate, bn_size, dropout):
        super().__init__()
        self.norm1 = nn.BatchNorm2D(in_ch)
        self.relu = nn.ReLU()
        self.conv1 = nn.Conv2D(in_ch, bn_size * growth_rate, 1,
                               bias_attr=False)
        self.norm2 = nn.BatchNorm2D(bn_size * growth_rate)
        self.conv2 = nn.Conv2D(bn_size * growth_rate, growth_rate, 3,
                               padding=1, bias_attr=False)
        self.dropout = nn.Dropout(dropout) if dropout else None

    def forward(self, x):
        out = self.conv1(self.relu(self.norm1(x)))
        out = self.conv2(self.relu(self.norm2(out)))
        if self.dropout is not None:
            out = self.dropout(out)
        return torch.cat([x, out], dim=1)


class _Transition(nn.Layer):
    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.norm = nn.BatchNorm2D(in_ch)
        self.relu = nn.ReLU()
        self.conv = nn.Conv2D(in_ch, out_ch, 1, bias_attr=False)
        self.pool = nn.AvgPool2D(2, stride=2)

    def forward(self, x):
        return self.pool(self.conv(self.relu(self.norm(x))))


class DenseNet(nn.Layer):
    def __init__(self, layers: int = 121, bn_size: int = 4,
                 dropout: float = 0.0, num_classes: int = 1000,
                 with_pool: bool = True, *, device=None):
        super().__init__()
        if layers not in _CFGS:
            raise ValueError(f"layers must be one of {sorted(_CFGS)}")
        num_init, growth, block_cfg = _CFGS[layers]
        self.num_classes = num_classes
        self.with_pool = with_pool
        with device_guard(device):
            feats = [nn.Sequential(
                nn.Conv2D(3, num_init, 7, stride=2, padding=3,
                          bias_attr=False),
                nn.BatchNorm2D(num_init), nn.ReLU(),
                nn.MaxPool2D(3, stride=2, padding=1))]
            ch = num_init
            for bi, n_layers in enumerate(block_cfg):
                for _ in range(n_layers):
                    feats.append(_DenseLayer(ch, growth, bn_size, dropout))
                    ch += growth
                if bi != len(block_cfg) - 1:
                    feats.append(_Transition(ch, ch // 2))
                    ch //= 2
            feats += [nn.BatchNorm2D(ch), nn.ReLU()]
            self.features = nn.Sequential(*feats)
            if with_pool:
                self.pool = nn.AdaptiveAvgPool2D((1, 1))
            if num_classes > 0:
                self.fc = nn.Linear(ch, num_classes)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(x.reshape(x.shape[0], -1))
        return x


def densenet121(pretrained: bool = False, **kwargs):
    return DenseNet(121, **kwargs)


def densenet161(pretrained: bool = False, **kwargs):
    return DenseNet(161, **kwargs)


def densenet169(pretrained: bool = False, **kwargs):
    return DenseNet(169, **kwargs)


def densenet201(pretrained: bool = False, **kwargs):
    return DenseNet(201, **kwargs)


def densenet264(pretrained: bool = False, **kwargs):
    return DenseNet(264, **kwargs)
