"""MobileNetV1 (``paddle_tpu/vision/models/mobilenetv1.py`` counterpart):
depthwise-separable convolutions; a depthwise conv is a grouped library
convolution with ``groups == channels`` (cuDNN on the card). Conventions
as in :mod:`.alexnet`."""

from __future__ import annotations

from ... import nn
from ...core.device import device_guard

__all__ = ["MobileNetV1", "mobilenet_v1"]


def _conv_bn(in_ch, out_ch, kernel, stride=1, padding=0, groups=1):
    return nn.Sequential(
        nn.Conv2D(in_ch, out_ch, kernel, stride=stride, padding=padding,
                  groups=groups, bias_attr=False),
        nn.BatchNorm2D(out_ch),
        nn.ReLU(),
    )


def _depthwise_separable(in_ch, out_ch, stride):
    return nn.Sequential(
        _conv_bn(in_ch, in_ch, 3, stride=stride, padding=1, groups=in_ch),
        _conv_bn(in_ch, out_ch, 1),
    )


class MobileNetV1(nn.Layer):
    def __init__(self, scale: float = 1.0, num_classes: int = 1000,
                 with_pool: bool = True, *, device=None):
        super().__init__()
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool

        def c(ch):
            return max(8, int(ch * scale))

        # (out_channels, stride) of each depthwise-separable stage
        plan = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
                (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
                (1024, 1)]
        with device_guard(device):
            blocks = [_conv_bn(3, c(32), 3, stride=2, padding=1)]
            in_ch = c(32)
            for out, stride in plan:
                blocks.append(_depthwise_separable(in_ch, c(out), stride))
                in_ch = c(out)
            self.features = nn.Sequential(*blocks)
            if with_pool:
                self.pool = nn.AdaptiveAvgPool2D((1, 1))
            if num_classes > 0:
                self.fc = nn.Linear(c(1024), num_classes)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(x.reshape(x.shape[0], -1))
        return x


def mobilenet_v1(pretrained: bool = False, scale: float = 1.0, **kwargs):
    return MobileNetV1(scale=scale, **kwargs)
