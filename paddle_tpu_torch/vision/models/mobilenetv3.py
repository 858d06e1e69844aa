"""MobileNetV3 Small and Large (``paddle_tpu/vision/models/mobilenetv3.py``
counterpart): inverted residuals with squeeze-excite and hardswish. The
squeeze-excite's ``fc1``/``fc2`` are 1x1 convolutions, not Linears
(convert with ``module=``). Conventions as in :mod:`.alexnet`."""

from __future__ import annotations

from ... import nn
from ...core.device import device_guard
from .mobilenetv2 import _make_divisible

__all__ = ["MobileNetV3Small", "MobileNetV3Large", "mobilenet_v3_small",
           "mobilenet_v3_large"]


class SqueezeExcite(nn.Layer):
    def __init__(self, ch, squeeze_factor=4):
        super().__init__()
        sq = _make_divisible(ch // squeeze_factor)
        self.pool = nn.AdaptiveAvgPool2D((1, 1))
        self.fc1 = nn.Conv2D(ch, sq, 1)
        self.relu = nn.ReLU()
        self.fc2 = nn.Conv2D(sq, ch, 1)
        self.hsig = nn.Hardsigmoid()

    def forward(self, x):
        return x * self.hsig(self.fc2(self.relu(self.fc1(self.pool(x)))))


class _Bneck(nn.Layer):
    def __init__(self, in_ch, exp_ch, out_ch, kernel, stride, use_se,
                 use_hs):
        super().__init__()
        self.use_res = stride == 1 and in_ch == out_ch
        act = nn.Hardswish if use_hs else nn.ReLU
        layers = []
        if exp_ch != in_ch:
            layers += [nn.Conv2D(in_ch, exp_ch, 1, bias_attr=False),
                       nn.BatchNorm2D(exp_ch), act()]
        layers += [
            nn.Conv2D(exp_ch, exp_ch, kernel, stride=stride,
                      padding=kernel // 2, groups=exp_ch, bias_attr=False),
            nn.BatchNorm2D(exp_ch), act(),
        ]
        if use_se:
            layers.append(SqueezeExcite(exp_ch))
        layers += [nn.Conv2D(exp_ch, out_ch, 1, bias_attr=False),
                   nn.BatchNorm2D(out_ch)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class _MobileNetV3(nn.Layer):
    # rows of cfg: kernel, expanded, out, use_se, use_hs, stride
    def __init__(self, cfg, last_exp, last_ch, scale, num_classes,
                 with_pool, device=None):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool

        def c(ch):
            return _make_divisible(ch * scale)

        with device_guard(device):
            in_ch = c(16)
            blocks = [nn.Sequential(
                nn.Conv2D(3, in_ch, 3, stride=2, padding=1, bias_attr=False),
                nn.BatchNorm2D(in_ch), nn.Hardswish())]
            for k, exp, out, se, hs, s in cfg:
                blocks.append(_Bneck(in_ch, c(exp), c(out), k, s, se, hs))
                in_ch = c(out)
            blocks.append(nn.Sequential(
                nn.Conv2D(in_ch, c(last_exp), 1, bias_attr=False),
                nn.BatchNorm2D(c(last_exp)), nn.Hardswish()))
            self.features = nn.Sequential(*blocks)
            if with_pool:
                self.pool = nn.AdaptiveAvgPool2D((1, 1))
            if num_classes > 0:
                self.classifier = nn.Sequential(
                    nn.Linear(c(last_exp), last_ch), nn.Hardswish(),
                    nn.Dropout(0.2), nn.Linear(last_ch, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(x.reshape(x.shape[0], -1))
        return x


class MobileNetV3Small(_MobileNetV3):
    def __init__(self, scale: float = 1.0, num_classes: int = 1000,
                 with_pool: bool = True, *, device=None):
        cfg = [
            (3, 16, 16, True, False, 2),
            (3, 72, 24, False, False, 2),
            (3, 88, 24, False, False, 1),
            (5, 96, 40, True, True, 2),
            (5, 240, 40, True, True, 1),
            (5, 240, 40, True, True, 1),
            (5, 120, 48, True, True, 1),
            (5, 144, 48, True, True, 1),
            (5, 288, 96, True, True, 2),
            (5, 576, 96, True, True, 1),
            (5, 576, 96, True, True, 1),
        ]
        super().__init__(cfg, 576, 1024, scale, num_classes, with_pool,
                         device)


class MobileNetV3Large(_MobileNetV3):
    def __init__(self, scale: float = 1.0, num_classes: int = 1000,
                 with_pool: bool = True, *, device=None):
        cfg = [
            (3, 16, 16, False, False, 1),
            (3, 64, 24, False, False, 2),
            (3, 72, 24, False, False, 1),
            (5, 72, 40, True, False, 2),
            (5, 120, 40, True, False, 1),
            (5, 120, 40, True, False, 1),
            (3, 240, 80, False, True, 2),
            (3, 200, 80, False, True, 1),
            (3, 184, 80, False, True, 1),
            (3, 184, 80, False, True, 1),
            (3, 480, 112, True, True, 1),
            (3, 672, 112, True, True, 1),
            (5, 672, 160, True, True, 2),
            (5, 960, 160, True, True, 1),
            (5, 960, 160, True, True, 1),
        ]
        super().__init__(cfg, 960, 1280, scale, num_classes, with_pool,
                         device)


def mobilenet_v3_small(pretrained: bool = False, scale: float = 1.0,
                       **kwargs):
    return MobileNetV3Small(scale=scale, **kwargs)


def mobilenet_v3_large(pretrained: bool = False, scale: float = 1.0,
                       **kwargs):
    return MobileNetV3Large(scale=scale, **kwargs)
