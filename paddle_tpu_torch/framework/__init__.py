"""Train step of the port (``paddle_tpu/framework`` counterpart)."""

from .sharded import TrainStep, make_sharded_train_step  # noqa: F401

__all__ = ["TrainStep", "make_sharded_train_step"]
