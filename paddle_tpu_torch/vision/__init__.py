"""Vision models and datasets of the port (``paddle_tpu/vision``
counterpart): the model zoo of :mod:`.models` (every JAX model file and
factory), MNIST and FashionMNIST."""

from . import datasets, models  # noqa: F401
