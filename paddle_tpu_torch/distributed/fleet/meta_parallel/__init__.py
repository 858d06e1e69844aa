"""``paddle_tpu/distributed/fleet/meta_parallel`` counterpart."""

from .pp_layers import LayerDesc, PipelineLayer, SharedLayerDesc  # noqa: F401

__all__ = ["LayerDesc", "PipelineLayer", "SharedLayerDesc"]
