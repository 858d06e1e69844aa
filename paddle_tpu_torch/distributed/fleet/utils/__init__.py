"""``paddle_tpu/distributed/fleet/utils`` counterpart: activation
recompute."""

from .recompute import (RecomputePolicy, recompute,  # noqa: F401
                        recompute_sequential)

__all__ = ["RecomputePolicy", "recompute", "recompute_sequential"]
