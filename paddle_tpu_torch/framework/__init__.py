"""Train step and checkpoint files of the port (``paddle_tpu/framework``
counterpart)."""

from .io import load, save  # noqa: F401
from .sharded import TrainStep, make_sharded_train_step  # noqa: F401

__all__ = ["TrainStep", "make_sharded_train_step", "save", "load"]
