"""PipelineLayer: stage partitioning of a layer sequence
(``paddle_tpu/distributed/fleet/meta_parallel/pp_layers.py`` counterpart).

A list of :class:`LayerDesc` (deferred construction), :class:`SharedLayerDesc`
(one layer whose parameters several positions share, e.g. tied embeddings)
or ready modules, partitioned into stages by layer count or at the
occurrences of a class. Every layer is built and registered under its
position ``str(i)`` (a shared layer once, under its first position), so the
state_dict keys are the JAX keys: ``"0.embeddings.word_embeddings.weight"``,
``"3.block.linear1.weight"``. The stage count is kept and partitions the
list, but one device runs every stage: the train step
(``distributed.pipeline_schedule.make_pipeline_train_step``) takes one
stage only.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Union

from torch import nn

from ....nn.layer import Layer

__all__ = ["LayerDesc", "SharedLayerDesc", "PipelineLayer"]


class LayerDesc:
    """Deferred layer construction: ``layer_cls(*args, **kwargs)``."""

    def __init__(self, layer_cls, *args, **kwargs):
        self.layer_cls = layer_cls
        self.args = args
        self.kwargs = kwargs
        if not callable(layer_cls):
            raise TypeError("LayerDesc needs an nn.Module subclass or "
                            "factory")

    def build_layer(self) -> nn.Module:
        return self.layer_cls(*self.args, **self.kwargs)

    def __repr__(self):
        name = getattr(self.layer_cls, "__name__", self.layer_cls)
        return f"LayerDesc({name})"


class SharedLayerDesc(LayerDesc):
    """A layer whose parameters are shared by every position that names
    its ``key``; ``forward_func(layer, x)``, when given, is how each
    position calls it."""

    def __init__(self, key: str, layer_cls,
                 forward_func: Optional[Callable] = None,
                 shared_weight_attr: str = "weight", *args, **kwargs):
        super().__init__(layer_cls, *args, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class PipelineLayer(Layer):
    """A sequence of LayerDescs partitioned into ``num_stages`` stages.
    ``seg_method``: ``"uniform"`` (by count) or ``"layer:<ClassName>"``
    (split at occurrences of a class). ``recompute_interval`` is kept, as
    the JAX layer keeps it: JAX's pipeline schedules recompute their stages
    when it is above 0, and its one-stage step, the one the port runs, does
    not read it."""

    def __init__(self, layers: Sequence[Union[LayerDesc, nn.Module,
                                              Callable]],
                 num_stages: Optional[int] = None, topology=None,
                 loss_fn=None, seg_method: str = "uniform",
                 recompute_interval: int = 0,
                 num_virtual_pipeline_stages: int = 1):
        super().__init__()
        self._descs = list(layers)
        self._loss_fn = loss_fn
        self._num_stages = num_stages or 1
        self._num_virtual_stages = num_virtual_pipeline_stages
        self.seg_method = seg_method
        self.recompute_interval = recompute_interval

        built: List[Any] = []
        self._shared: Dict[str, nn.Module] = {}
        for d in self._descs:
            if isinstance(d, SharedLayerDesc):
                if d.layer_name not in self._shared:
                    self._shared[d.layer_name] = d.build_layer()
                built.append((self._shared[d.layer_name], d.forward_func))
            elif isinstance(d, LayerDesc):
                built.append((d.build_layer(), None))
            else:
                built.append((d, None))
        self._built = built
        seen = set()
        for i, (layer, _) in enumerate(built):
            # shared layers register once under their first position
            if isinstance(layer, nn.Module) and id(layer) not in seen:
                seen.add(id(layer))
                self.add_module(str(i), layer)

        self._segments = self._partition(len(built), self.total_stages)

    @property
    def total_stages(self) -> int:
        return self._num_stages * self._num_virtual_stages

    def _partition(self, n_layers: int, n_stages: int) -> List[int]:
        """Boundaries [b_0..b_S]; stage i owns [b_i, b_{i+1})."""
        if self.seg_method.startswith("layer:"):
            cls_name = self.seg_method.split(":", 1)[1]
            marks = [i for i, (l, _) in enumerate(self._built)
                     if type(l).__name__ == cls_name]
            if len(marks) < n_stages:
                raise ValueError(f"only {len(marks)} {cls_name} layers for "
                                 f"{n_stages} stages")
            per = len(marks) / n_stages
            bounds = [0] + [marks[int(round(s * per))]
                            for s in range(1, n_stages)]
            return bounds + [n_layers]
        per = n_layers / n_stages
        return [int(round(s * per)) for s in range(n_stages)] + [n_layers]

    def get_stage_layers(self, stage: int) -> List[Any]:
        lo, hi = self._segments[stage], self._segments[stage + 1]
        return self._built[lo:hi]

    def stage_of_layer(self, idx: int) -> int:
        """The stage that owns the ``idx``-th layer."""
        for s in range(self.total_stages):
            if self._segments[s] <= idx < self._segments[s + 1]:
                return s
        raise IndexError(idx)

    def forward_stage(self, x, stage: int):
        for layer, fwd in self.get_stage_layers(stage):
            x = fwd(layer, x) if fwd is not None else layer(x)
        return x

    def forward(self, x):
        """Every stage in order, on this device."""
        for s in range(self.total_stages):
            x = self.forward_stage(x, s)
        return x

    def shared_layers(self) -> Dict[str, nn.Module]:
        return dict(self._shared)

    def loss_fn(self, *args):
        if self._loss_fn is None:
            raise RuntimeError("PipelineLayer built without loss_fn")
        return self._loss_fn(*args)
