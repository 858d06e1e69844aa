"""LeNet (``paddle_tpu/vision/models/lenet.py`` counterpart), BASELINE
config 1: two convolutions with ReLU and 2x2 max-pooling, then three
Linear layers, under the JAX attribute names (``features``, ``fc``), so
state_dict keys match the JAX keys; :mod:`paddle_tpu_torch.convert`
transposes the ``fc`` weights.

``device=None`` builds on ``cuda:0`` and raises without CUDA; pass
``device="cpu"`` for the CPU. Weights are drawn from ``seed`` with a
``torch.Generator`` on that device, from the JAX layers' distributions
(the convolutions' KaimingUniform, U(±1/sqrt(fan_in)) for weight and bias;
the Linears' XavierNormal and a zero bias); the values differ from JAX's.
The convolutions are library convolutions (cuDNN on the card), as the JAX
layer's are ``lax.conv_general_dilated``: no TPU kernel is on this path.
"""

from __future__ import annotations

import torch
from torch import nn

from ... import nn as pnn
from ...core.device import resolve_device
from ...nn.layer import Layer

__all__ = ["LeNet"]


class LeNet(Layer):
    def __init__(self, num_classes: int = 10, *, device=None,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        factory = dict(device=resolve_device(device), dtype=dtype)
        self.num_classes = num_classes
        self.features = pnn.Sequential(
            pnn.Conv2D(1, 6, 3, stride=1, padding=1, **factory),
            pnn.ReLU(),
            pnn.MaxPool2D(2, 2),
            pnn.Conv2D(6, 16, 5, stride=1, padding=0, **factory),
            pnn.ReLU(),
            pnn.MaxPool2D(2, 2),
        )
        if num_classes > 0:
            self.fc = pnn.Sequential(
                pnn.Linear(400, 120, **factory),
                pnn.Linear(120, 84, **factory),
                pnn.Linear(84, num_classes, **factory),
            )
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        device = self.features[0].weight.device
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        for mod in self.modules():
            if isinstance(mod, pnn.Conv2D):
                w = mod.weight
                bound = (w.shape[1] * w.shape[2] * w.shape[3]) ** -0.5
                w.uniform_(-bound, bound, generator=gen)
                mod.bias.uniform_(-bound, bound, generator=gen)
            elif isinstance(mod, nn.Linear):
                std = (2.0 / (mod.in_features + mod.out_features)) ** 0.5
                mod.weight.normal_(0.0, std, generator=gen)
                mod.bias.zero_()

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = x.reshape(x.shape[0], -1)
            x = self.fc(x)
        return x
