"""AlexNet (``paddle_tpu/vision/models/alexnet.py`` counterpart).

Every model of the zoo builds its layers on ``device`` (None: ``cuda:0``,
raising without CUDA; ``device="cpu"`` for the CPU) under
:func:`~paddle_tpu_torch.core.device.device_guard`, with the JAX layers'
names, so state_dict keys match JAX's; weights come from the port's key
stream (``paddle_tpu_torch.seed``), and :func:`paddle_tpu_torch.convert.
from_jax_state_dict` with ``module=`` carries JAX's across. Its convolutions
are library convolutions (cuDNN on the card), as JAX's are
``lax.conv_general_dilated``: no TPU kernel is on these paths.
"""

from __future__ import annotations

from ... import nn
from ...core.device import device_guard

__all__ = ["AlexNet", "alexnet"]


class AlexNet(nn.Layer):
    def __init__(self, num_classes: int = 1000, dropout: float = 0.5, *,
                 device=None):
        super().__init__()
        self.num_classes = num_classes
        with device_guard(device):
            self.features = nn.Sequential(
                nn.Conv2D(3, 64, 11, stride=4, padding=2), nn.ReLU(),
                nn.MaxPool2D(3, stride=2),
                nn.Conv2D(64, 192, 5, padding=2), nn.ReLU(),
                nn.MaxPool2D(3, stride=2),
                nn.Conv2D(192, 384, 3, padding=1), nn.ReLU(),
                nn.Conv2D(384, 256, 3, padding=1), nn.ReLU(),
                nn.Conv2D(256, 256, 3, padding=1), nn.ReLU(),
                nn.MaxPool2D(3, stride=2),
            )
            self.avgpool = nn.AdaptiveAvgPool2D((6, 6))
            if num_classes > 0:
                self.classifier = nn.Sequential(
                    nn.Dropout(dropout), nn.Linear(256 * 6 * 6, 4096),
                    nn.ReLU(), nn.Dropout(dropout), nn.Linear(4096, 4096),
                    nn.ReLU(), nn.Linear(4096, num_classes),
                )

    def forward(self, x):
        x = self.avgpool(self.features(x))
        if self.num_classes > 0:
            x = self.classifier(x.reshape(x.shape[0], -1))
        return x


def alexnet(pretrained: bool = False, **kwargs):
    """``pretrained`` is taken and downloads nothing, as in JAX."""
    return AlexNet(**kwargs)
