"""ShuffleNetV2 at every width, and its swish form
(``paddle_tpu/vision/models/shufflenetv2.py`` counterpart; conventions as in
:mod:`.alexnet`)."""

from __future__ import annotations

import torch

from ... import nn
from ...core.device import device_guard
from ...nn.functional import channel_shuffle

__all__ = ["ShuffleNetV2", "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
           "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
           "shufflenet_v2_x2_0", "shufflenet_v2_swish"]

_STAGE_OUT = {
    0.25: (24, 24, 48, 96, 512),
    0.33: (24, 32, 64, 128, 512),
    0.5: (24, 48, 96, 192, 1024),
    1.0: (24, 116, 232, 464, 1024),
    1.5: (24, 176, 352, 704, 1024),
    2.0: (24, 244, 488, 976, 2048),
}
_REPEATS = (4, 8, 4)


def _conv_bn_act(in_ch, out_ch, kernel, stride=1, padding=0, groups=1,
                 act=None):
    layers = [nn.Conv2D(in_ch, out_ch, kernel, stride=stride, padding=padding,
                        groups=groups, bias_attr=False),
              nn.BatchNorm2D(out_ch)]
    if act is not None:
        layers.append(act())
    return nn.Sequential(*layers)


class _ShuffleUnit(nn.Layer):
    def __init__(self, in_ch, out_ch, stride, act):
        super().__init__()
        self.stride = stride
        branch_ch = out_ch // 2
        if stride == 1:
            # the input is split in half; the right branch transforms one
            self.branch2 = nn.Sequential(
                _conv_bn_act(in_ch // 2, branch_ch, 1, act=act),
                _conv_bn_act(branch_ch, branch_ch, 3, stride=1, padding=1,
                             groups=branch_ch),
                _conv_bn_act(branch_ch, branch_ch, 1, act=act))
            self.branch1 = None
        else:
            self.branch1 = nn.Sequential(
                _conv_bn_act(in_ch, in_ch, 3, stride=stride, padding=1,
                             groups=in_ch),
                _conv_bn_act(in_ch, branch_ch, 1, act=act))
            self.branch2 = nn.Sequential(
                _conv_bn_act(in_ch, branch_ch, 1, act=act),
                _conv_bn_act(branch_ch, branch_ch, 3, stride=stride,
                             padding=1, groups=branch_ch),
                _conv_bn_act(branch_ch, branch_ch, 1, act=act))

    def forward(self, x):
        if self.stride == 1:
            half = x.shape[1] // 2
            out = torch.cat([x[:, :half], self.branch2(x[:, half:])], dim=1)
        else:
            out = torch.cat([self.branch1(x), self.branch2(x)], dim=1)
        return channel_shuffle(out, 2)


class ShuffleNetV2(nn.Layer):
    def __init__(self, scale: float = 1.0, act: str = "relu",
                 num_classes: int = 1000, with_pool: bool = True, *,
                 device=None):
        super().__init__()
        if scale not in _STAGE_OUT:
            raise ValueError(f"scale must be one of {sorted(_STAGE_OUT)}")
        act_layer = nn.Silu if act == "swish" else nn.ReLU
        c0, c1, c2, c3, c_last = _STAGE_OUT[scale]
        self.num_classes = num_classes
        self.with_pool = with_pool
        with device_guard(device):
            self.conv1 = _conv_bn_act(3, c0, 3, stride=2, padding=1,
                                      act=act_layer)
            self.maxpool = nn.MaxPool2D(3, stride=2, padding=1)
            stages, in_ch = [], c0
            for out_ch, n in zip((c1, c2, c3), _REPEATS):
                units = [_ShuffleUnit(in_ch, out_ch, 2, act_layer)]
                units += [_ShuffleUnit(out_ch, out_ch, 1, act_layer)
                          for _ in range(n - 1)]
                stages.append(nn.Sequential(*units))
                in_ch = out_ch
            self.stages = nn.Sequential(*stages)
            self.conv_last = _conv_bn_act(in_ch, c_last, 1, act=act_layer)
            if with_pool:
                self.pool = nn.AdaptiveAvgPool2D((1, 1))
            if num_classes > 0:
                self.fc = nn.Linear(c_last, num_classes)

    def forward(self, x):
        x = self.conv_last(self.stages(self.maxpool(self.conv1(x))))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(x.reshape(x.shape[0], -1))
        return x


def shufflenet_v2_x0_25(pretrained: bool = False, **kwargs):
    return ShuffleNetV2(scale=0.25, **kwargs)


def shufflenet_v2_x0_33(pretrained: bool = False, **kwargs):
    return ShuffleNetV2(scale=0.33, **kwargs)


def shufflenet_v2_x0_5(pretrained: bool = False, **kwargs):
    return ShuffleNetV2(scale=0.5, **kwargs)


def shufflenet_v2_x1_0(pretrained: bool = False, **kwargs):
    return ShuffleNetV2(scale=1.0, **kwargs)


def shufflenet_v2_x1_5(pretrained: bool = False, **kwargs):
    return ShuffleNetV2(scale=1.5, **kwargs)


def shufflenet_v2_x2_0(pretrained: bool = False, **kwargs):
    return ShuffleNetV2(scale=2.0, **kwargs)


def shufflenet_v2_swish(pretrained: bool = False, **kwargs):
    return ShuffleNetV2(scale=1.0, act="swish", **kwargs)
