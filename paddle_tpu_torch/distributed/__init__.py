"""Distributed training of the port (``paddle_tpu/distributed``
counterpart): so far the pipeline layer and its train step at one stage,
on one device."""

from .pipeline_schedule import make_pipeline_train_step  # noqa: F401

__all__ = ["make_pipeline_train_step"]
