"""paddle_tpu_torch.fault — fault injection (``paddle_tpu/fault``
counterpart). So far only the named fire points of :mod:`.injection` that
the serving engine and the paged KV cache expose."""

from .injection import (clear_fire_points, fire,  # noqa: F401
                        register_fire_point)

__all__ = ["clear_fire_points", "fire", "register_fire_point"]
