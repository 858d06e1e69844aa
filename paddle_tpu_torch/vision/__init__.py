"""Vision models and datasets of the port (``paddle_tpu/vision``
counterpart; LeNet, ResNet, MNIST and FashionMNIST so far)."""

from . import datasets, models  # noqa: F401
