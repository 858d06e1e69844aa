"""ResNet family (``paddle_tpu/vision/models/resnet.py`` counterpart) —
BASELINE config 2, ResNet-50 trained on ImageNet-shaped batches.

The layers keep the JAX attribute names (``conv1``, ``bn1``, ``layer1`` …
``layer4``, ``downsample.0``/``.1``, ``fc``), so state_dict keys, the BN
buffers ``_mean``/``_variance`` included, match the JAX keys one for one;
conv weights are OIHW in both packages and copy as they are, the ``fc``
weight is transposed by :mod:`paddle_tpu_torch.convert`.

In training with ``FLAGS_fused_conv_bn`` on, NHWC blocks take the
deferred-BN units of :mod:`paddle_tpu_torch.nn.fused_conv_bn` (the JAX
``_forward_fused``), and with ``FLAGS_pallas_conv`` on as well every 1x1 and
3x3 conv of a bottleneck runs on the hand-written kernels K5-K8. The stem
with ``stem_mode="space_to_depth"`` (NHWC) is the exact 4x4/s1 rewrite of
the 7x7/s2 conv over 2x2 space-to-depth input; its 4x4 conv is a library
convolution on both routes, as in JAX. The ResNeXt factories
(``resnext50_32x4d`` ... ``resnext152_64x4d``) build grouped 3x3
bottlenecks, whose grouped convs stay off the kernels (``supports`` refuses
groups, as JAX's does) and run the units' library route while their 1x1
convs take K5/K6; the wide factories (``wide_resnet50_2``,
``wide_resnet101_2``) double the bottleneck width and run every conv on
the kernels.
"""

from __future__ import annotations

import inspect

import torch
import torch.nn.functional as TF
from torch import nn

from ...core.device import resolve_device
from ...nn import fused_conv_bn as FCB
from ...nn import functional as F
from ...nn.layer import Layer
from ...nn.layers import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Linear,
                          MaxPool2D, ReLU, Sequential, _BatchNormBase)

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "resnet18", "resnet34",
           "resnet50", "resnet101", "resnet152", "resnext50_32x4d",
           "resnext50_64x4d", "resnext101_32x4d", "resnext101_64x4d",
           "resnext152_32x4d", "resnext152_64x4d", "wide_resnet50_2",
           "wide_resnet101_2"]


def _fusable(block, x) -> bool:
    """The deferred-BN path applies in training, NHWC, with affine
    BatchNorm everywhere and the flag on."""
    if x.dim() != 4 or getattr(block, "_data_format", None) != "NHWC":
        return False
    if not block.training or not FCB.fused_conv_bn_enabled():
        return False
    bns = [block.bn1, block.bn2] + \
        ([block.bn3] if hasattr(block, "bn3") else [])
    if block.downsample is not None:
        if len(block.downsample) != 2:
            return False
        bns.append(block.downsample[1])
    for bn in bns:
        if not isinstance(bn, _BatchNormBase) or bn.use_global_stats \
                or bn.weight is None or bn.bias is None:
            return False
    return True


def _count(o) -> int:
    return o.numel() // o.shape[-1]


def _fused_identity(block, x):
    """The downsample branch on the fused path: 1x1 strided conv with the
    stats epilogue, BN from its own sums, no activation."""
    if block.downsample is None:
        return x
    dconv, dbn = block.downsample[0], block.downsample[1]
    od, sd, ssd = FCB.conv_stats(x, dconv.weight, F._pair(dconv.stride),
                                 F._pair(dconv.padding),
                                 F._pair(dconv.dilation), dconv.groups)
    FCB.update_bn_buffers(dbn, sd, ssd, _count(od))
    return FCB.bn_act_from_stats(od, dbn.weight, dbn.bias, sd, ssd,
                                 dbn.epsilon, "none")


def _norm(norm_layer, num_features, data_format, factory):
    """A norm layer, given ``data_format`` and the factory arguments only
    where its signature takes them."""
    try:
        params = inspect.signature(norm_layer).parameters
        kwargs = any(p.kind is inspect.Parameter.VAR_KEYWORD
                     for p in params.values())
    except (TypeError, ValueError):
        params, kwargs = {}, False
    extra = {}
    if kwargs or "data_format" in params:
        extra["data_format"] = data_format
    extra.update({k: v for k, v in factory.items() if kwargs or k in params})
    return norm_layer(num_features, **extra)


class BasicBlock(Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW", **factory):
        super().__init__()
        norm_layer = norm_layer or BatchNorm2D
        df = data_format
        self.conv1 = Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                            bias_attr=False, data_format=df, **factory)
        self.bn1 = _norm(norm_layer, planes, df, factory)
        self.relu = ReLU()
        self.conv2 = Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                            data_format=df, **factory)
        self.bn2 = _norm(norm_layer, planes, df, factory)
        self.downsample = downsample
        self.stride = stride
        self._data_format = data_format

    def forward(self, x):
        if _fusable(self, x):
            return self._forward_fused(x)
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)

    def _forward_fused(self, x):
        o1, s1, ss1 = FCB.conv_stats(x, self.conv1.weight,
                                     F._pair(self.conv1.stride), (1, 1))
        FCB.update_bn_buffers(self.bn1, s1, ss1, _count(o1))
        o2, s2, ss2 = FCB.conv_bn_act(
            o1, self.bn1.weight, self.bn1.bias, s1, ss1, self.conv2.weight,
            self.bn1.epsilon, "relu", (1, 1), (1, 1))
        FCB.update_bn_buffers(self.bn2, s2, ss2, _count(o2))
        identity = _fused_identity(self, x)
        return FCB.bn_add_act(o2, self.bn2.weight, self.bn2.bias, s2, ss2,
                              identity, self.bn2.epsilon)


class BottleneckBlock(Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW", **factory):
        super().__init__()
        norm_layer = norm_layer or BatchNorm2D
        width = int(planes * (base_width / 64.0)) * groups
        df = data_format
        self.conv1 = Conv2D(inplanes, width, 1, bias_attr=False,
                            data_format=df, **factory)
        self.bn1 = _norm(norm_layer, width, df, factory)
        self.conv2 = Conv2D(width, width, 3, padding=dilation, stride=stride,
                            groups=groups, dilation=dilation,
                            bias_attr=False, data_format=df, **factory)
        self.bn2 = _norm(norm_layer, width, df, factory)
        self.conv3 = Conv2D(width, planes * self.expansion, 1,
                            bias_attr=False, data_format=df, **factory)
        self.bn3 = _norm(norm_layer, planes * self.expansion, df, factory)
        self.relu = ReLU()
        self.downsample = downsample
        self._data_format = data_format

    def forward(self, x):
        if _fusable(self, x):
            return self._forward_fused(x)
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)

    def _forward_fused(self, x):
        """Deferred-BN bottleneck: each conv takes the previous conv's raw
        output with BN+ReLU as its prologue and returns its channel sums;
        the same function as the plain forward."""
        c2 = self.conv2
        o1, s1, ss1 = FCB.conv_stats(x, self.conv1.weight)
        FCB.update_bn_buffers(self.bn1, s1, ss1, _count(o1))
        o2, s2, ss2 = FCB.conv_bn_act(
            o1, self.bn1.weight, self.bn1.bias, s1, ss1, c2.weight,
            self.bn1.epsilon, "relu", F._pair(c2.stride), F._pair(c2.padding),
            F._pair(c2.dilation), c2.groups)
        FCB.update_bn_buffers(self.bn2, s2, ss2, _count(o2))
        o3, s3, ss3 = FCB.conv_bn_act(
            o2, self.bn2.weight, self.bn2.bias, s2, ss2, self.conv3.weight,
            self.bn2.epsilon, "relu")
        FCB.update_bn_buffers(self.bn3, s3, ss3, _count(o3))
        identity = _fused_identity(self, x)
        return FCB.bn_add_act(o3, self.bn3.weight, self.bn3.bias, s3, ss3,
                              identity, self.bn3.epsilon)


def _space_to_depth(x):
    """``[N, H, W, C] -> [N, H/2, W/2, 4C]``, channel order (hb, wb, C)."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // 2, w // 2, 4 * c)


def _fold_stem_weight(w):
    """conv1 ``[O, C, 7, 7]`` -> the equivalent 4x4 kernel ``[O, 4C, 4, 4]``
    over space-to-depth input (padded to 8x8 at the top left; each spatial
    dim split into (block, phase); the phases become input channels).
    Torch ops throughout, so the gradient flows back to ``conv1.weight``."""
    o, c = w.shape[0], w.shape[1]
    w8 = TF.pad(w, (1, 0, 1, 0))
    w8 = w8.reshape(o, c, 4, 2, 4, 2)              # (o, c, a, hb, b, wb)
    return w8.permute(0, 3, 5, 1, 2, 4).reshape(o, 4 * c, 4, 4)


class ResNet(Layer):
    """ResNet over ``block`` at ``depth`` (18, 34, 50, 101, 152).

    ``stem_mode="space_to_depth"`` (NHWC only) rewrites the 7x7/s2 stem
    conv as the exactly equivalent 4x4/s1 conv over 2x2 space-to-depth
    input, the weight folded on the fly from ``conv1.weight``.

    ``device=None`` builds on ``cuda:0`` and raises without CUDA; pass
    ``device="cpu"`` for the CPU. Weights are drawn from ``seed`` with a
    ``torch.Generator`` on that device, from the JAX model's
    distributions: U(±1/sqrt(fan_in)) for the convs, N(0, 2/(in+out)) for
    ``fc`` with a zero bias, unit BN scales and zero shifts (the draws
    differ; tests carry weights across with
    :func:`~paddle_tpu_torch.convert.from_jax_state_dict`)."""

    def __init__(self, block, depth: int = 50, width: int = 64,
                 num_classes: int = 1000, with_pool: bool = True,
                 groups: int = 1, data_format: str = "NCHW",
                 stem_mode: str = "conv", *, device=None,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        layer_cfg = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                     101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
        layers = layer_cfg[depth]
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.inplanes = 64
        self.dilation = 1
        self.data_format = data_format
        if stem_mode not in ("conv", "space_to_depth"):
            raise ValueError(f"stem_mode {stem_mode!r}")
        if stem_mode == "space_to_depth" and data_format != "NHWC":
            raise ValueError("space_to_depth stem requires NHWC")
        self.stem_mode = stem_mode
        self._factory = dict(device=resolve_device(device), dtype=dtype)

        df, fac = data_format, self._factory
        self.conv1 = Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                            bias_attr=False, data_format=df, **fac)
        self.bn1 = BatchNorm2D(self.inplanes, data_format=df, **fac)
        self.relu = ReLU()
        self.maxpool = MaxPool2D(3, stride=2, padding=1, data_format=df)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((1, 1), data_format=df)
        if num_classes > 0:
            self.fc = Linear(512 * block.expansion, num_classes, **fac)
        self.reset_parameters(seed)

    def _make_layer(self, block, planes, blocks, stride=1):
        df, fac = self.data_format, self._factory
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1,
                       stride=stride, bias_attr=False, data_format=df, **fac),
                BatchNorm2D(planes * block.expansion, data_format=df, **fac),
            )
        layers = [block(self.inplanes, planes, stride, downsample, self.groups,
                        self.base_width, data_format=df, **fac)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width, data_format=df,
                                **fac))
        return Sequential(*layers)

    @property
    def device(self) -> torch.device:
        return self.conv1.weight.device

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        for mod in self.modules():
            if isinstance(mod, Conv2D):
                w = mod.weight
                bound = (w.shape[1] * w.shape[2] * w.shape[3]) ** -0.5
                w.uniform_(-bound, bound, generator=gen)
                if mod.bias is not None:
                    mod.bias.uniform_(-bound, bound, generator=gen)
            elif isinstance(mod, nn.Linear):
                std = (2.0 / (mod.in_features + mod.out_features)) ** 0.5
                mod.weight.normal_(0.0, std, generator=gen)
                mod.bias.zero_()
            elif isinstance(mod, _BatchNormBase):
                if mod.weight is not None:
                    mod.weight.fill_(1.0)
                if mod.bias is not None:
                    mod.bias.zero_()
                mod._mean.zero_()
                mod._variance.fill_(1.0)

    def _stem_fusable(self, x) -> bool:
        return (x.dim() == 4 and self.data_format == "NHWC" and self.training
                and FCB.fused_conv_bn_enabled()
                and isinstance(self.bn1, _BatchNormBase)
                and not self.bn1.use_global_stats
                and self.bn1.weight is not None
                and self.bn1.bias is not None)

    def forward(self, x):
        fused = self._stem_fusable(x)
        if self.stem_mode == "space_to_depth":
            xs = TF.pad(_space_to_depth(x), (0, 0, 2, 1, 2, 1))
            w2 = _fold_stem_weight(self.conv1.weight)
            if fused:
                x, stem_w = xs, w2
                stem_stride, stem_pad = (1, 1), (0, 0)
            else:
                x = F.conv2d(xs, w2.to(xs.dtype), stride=1, padding=0,
                             data_format="NHWC")
        elif fused:
            stem_w = self.conv1.weight
            stem_stride = F._pair(self.conv1.stride)
            stem_pad = F._pair(self.conv1.padding)
        else:
            x = self.conv1(x)
        if fused:
            o0, s0, ss0 = FCB.conv_stats(x, stem_w, stem_stride, stem_pad)
            FCB.update_bn_buffers(self.bn1, s0, ss0, _count(o0))
            x = FCB.bn_act_from_stats(o0, self.bn1.weight, self.bn1.bias,
                                      s0, ss0, self.bn1.epsilon, "relu")
            x = self.maxpool(x)
        else:
            x = self.maxpool(self.relu(self.bn1(x)))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = x.reshape(x.shape[0], -1)
            x = self.fc(x)
        return x


def _resnet(block, depth, **kwargs):
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained: bool = False, **kwargs):
    return _resnet(BasicBlock, 18, **kwargs)


def resnet34(pretrained: bool = False, **kwargs):
    return _resnet(BasicBlock, 34, **kwargs)


def resnet50(pretrained: bool = False, **kwargs):
    return _resnet(BottleneckBlock, 50, **kwargs)


def resnet101(pretrained: bool = False, **kwargs):
    return _resnet(BottleneckBlock, 101, **kwargs)


def resnet152(pretrained: bool = False, **kwargs):
    return _resnet(BottleneckBlock, 152, **kwargs)


# ResNeXt: grouped 3x3 bottlenecks (the reference's resnext* factories)
def resnext50_32x4d(pretrained: bool = False, **kwargs):
    return _resnet(BottleneckBlock, 50, groups=32, width=4, **kwargs)


def resnext50_64x4d(pretrained: bool = False, **kwargs):
    return _resnet(BottleneckBlock, 50, groups=64, width=4, **kwargs)


def resnext101_32x4d(pretrained: bool = False, **kwargs):
    return _resnet(BottleneckBlock, 101, groups=32, width=4, **kwargs)


def resnext101_64x4d(pretrained: bool = False, **kwargs):
    return _resnet(BottleneckBlock, 101, groups=64, width=4, **kwargs)


def resnext152_32x4d(pretrained: bool = False, **kwargs):
    return _resnet(BottleneckBlock, 152, groups=32, width=4, **kwargs)


def resnext152_64x4d(pretrained: bool = False, **kwargs):
    return _resnet(BottleneckBlock, 152, groups=64, width=4, **kwargs)


# Wide ResNet: twice the bottleneck width (wide_resnet*_2)
def wide_resnet50_2(pretrained: bool = False, **kwargs):
    return _resnet(BottleneckBlock, 50, width=128, **kwargs)


def wide_resnet101_2(pretrained: bool = False, **kwargs):
    return _resnet(BottleneckBlock, 101, width=128, **kwargs)
