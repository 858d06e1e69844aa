"""Attention ops of the port (``paddle_tpu/ops`` counterpart)."""

from .flash_attention import (flash_attention,  # noqa: F401
                              reference_attention, single_query_attention)

__all__ = ["flash_attention", "reference_attention",
           "single_query_attention"]
