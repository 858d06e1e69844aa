"""MobileNetV2 (``paddle_tpu/vision/models/mobilenetv2.py`` counterpart):
inverted residuals with linear bottlenecks. Conventions as in
:mod:`.alexnet`."""

from __future__ import annotations

from ... import nn
from ...core.device import device_guard

__all__ = ["MobileNetV2", "mobilenet_v2"]


def _make_divisible(v, divisor=8, min_value=None):
    """``v`` rounded to the nearest multiple of ``divisor`` (at least
    ``min_value``), never more than 10% below ``v``."""
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class InvertedResidual(nn.Layer):
    def __init__(self, in_ch, out_ch, stride, expand_ratio):
        super().__init__()
        hidden = int(round(in_ch * expand_ratio))
        self.use_res = stride == 1 and in_ch == out_ch
        layers = []
        if expand_ratio != 1:
            layers += [nn.Conv2D(in_ch, hidden, 1, bias_attr=False),
                       nn.BatchNorm2D(hidden), nn.ReLU6()]
        layers += [
            nn.Conv2D(hidden, hidden, 3, stride=stride, padding=1,
                      groups=hidden, bias_attr=False),
            nn.BatchNorm2D(hidden), nn.ReLU6(),
            nn.Conv2D(hidden, out_ch, 1, bias_attr=False),
            nn.BatchNorm2D(out_ch),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(nn.Layer):
    def __init__(self, scale: float = 1.0, num_classes: int = 1000,
                 with_pool: bool = True, *, device=None):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        # t (expansion), c (channels), n (repeats), s (first stride)
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        in_ch = _make_divisible(32 * scale)
        last_ch = _make_divisible(1280 * max(1.0, scale))
        with device_guard(device):
            blocks = [nn.Sequential(
                nn.Conv2D(3, in_ch, 3, stride=2, padding=1, bias_attr=False),
                nn.BatchNorm2D(in_ch), nn.ReLU6())]
            for t, c, n, s in cfg:
                out_ch = _make_divisible(c * scale)
                for i in range(n):
                    blocks.append(InvertedResidual(in_ch, out_ch,
                                                   s if i == 0 else 1, t))
                    in_ch = out_ch
            blocks.append(nn.Sequential(
                nn.Conv2D(in_ch, last_ch, 1, bias_attr=False),
                nn.BatchNorm2D(last_ch), nn.ReLU6()))
            self.features = nn.Sequential(*blocks)
            if with_pool:
                self.pool = nn.AdaptiveAvgPool2D((1, 1))
            if num_classes > 0:
                self.classifier = nn.Sequential(
                    nn.Dropout(0.2), nn.Linear(last_ch, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(x.reshape(x.shape[0], -1))
        return x


def mobilenet_v2(pretrained: bool = False, scale: float = 1.0, **kwargs):
    return MobileNetV2(scale=scale, **kwargs)
