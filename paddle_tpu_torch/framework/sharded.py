"""Train step (``paddle_tpu/framework/sharded.py`` counterpart), one GPU.

:class:`TrainStep` runs forward, backward, the optimizer's
``apply_gradients`` and the scheduler step for a model on one device::

    step = make_sharded_train_step(model, AdamW(1e-4), loss_fn)
    loss = step.step(batch)          # loss_fn(model, batch) -> scalar

The parameters are the model's own (``named_parameters``, trainable
ones), updated in place, with the optimizer state beside them in the JAX
layout. Each step runs inside ``rng_scope(fold_in(base_key,
step_count))``, as the JAX step keys its random stream, so the dropout
masks of a step follow from its index: a run resumed from
:meth:`TrainStep.state_dict` draws what an unbroken run draws. The JAX
step's mesh, ZeRO sharding, offload, health sentinel and pass pipeline are
not ported: a ``mesh`` raises.

Each step reports into the process-wide step timeline
(:func:`paddle_tpu_torch.observability.step_monitor.current`), as JAX's
does: the ``h2d`` phase around the batch's copy to the device, the
applied step's ``index``, and the forward, backward and update under
``compile`` the first time the recompile sentinel sees the batch's
signature and ``device`` after; the HBM sample at the step's end. Under
``FLAGS_telemetry=off`` none of it runs.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..core.random import fold_in, make_key, rng_scope
from ..observability import step_monitor

__all__ = ["TrainStep", "make_sharded_train_step"]


def _to_device(batch, device):
    if batch is None:   # an absent input (no mask, no labels) stays absent
        return None
    if isinstance(batch, dict):
        return {k: _to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_to_device(v, device) for v in batch)
    return torch.as_tensor(batch, device=device)


class TrainStep:
    """A single-device train step. ``step(batch) -> loss``."""

    def __init__(self, model: nn.Module, optimizer, loss_fn: Callable,
                 mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "TrainStep runs on one device: meshes, ZeRO sharding, "
                "offload and the step passes are not ported yet")
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.params: Dict[str, torch.Tensor] = {
            n: p for n, p in model.named_parameters() if p.requires_grad}
        if not self.params:
            raise ValueError("the model has no trainable parameters")
        self.device = next(iter(self.params.values())).device
        self.opt_state = optimizer.init(self.params)
        self._step_count = 0
        self._base_key = make_key(0)   # jax.random.key(0), as in JAX

    @property
    def step_count(self) -> int:
        """Steps applied so far (the index the random stream is keyed by)."""
        return self._step_count

    def step(self, batch, index: Optional[int] = None) -> torch.Tensor:
        """One train step on ``batch`` (numpy arrays or tensors, moved to
        the model's device). ``index`` pins this step's index, as the JAX
        step's guarded trainers do; by default the counter increments.
        Returns the loss (a detached scalar tensor on the device)."""
        tm = step_monitor.current()
        with tm.step():
            return self._step_inner(batch, tm, index)

    def _step_inner(self, batch, tm, index: Optional[int]) -> torch.Tensor:
        with tm.phase("h2d"):
            batch = _to_device(batch, self.device)
        if index is None:
            self._step_count += 1
        else:
            self._step_count = int(index)
        # the flight recorder's step commits carry this applied index
        tm.note("index", self._step_count)
        lr = self.optimizer.get_lr()
        # recompile sentinel: the parameters and optimizer state keep their
        # signatures, so only the batch and the learning rate (a float32
        # scalar, as JAX passes it) are fingerprinted; the first dispatch
        # of a signature is timed as "compile", later ones as "device"
        dispatch_phase = "device"
        if tm.enabled:
            dispatch_phase = tm.observe_dispatch(
                ("sharded.TrainStep", id(self)), (batch, np.float32(lr)),
                where="sharded.TrainStep")
        with tm.phase(dispatch_phase):
            for p in self.params.values():
                p.grad = None
            with rng_scope(fold_in(self._base_key, self._step_count)):
                loss = self.loss_fn(self.model, batch)
                loss.backward()
            # a parameter the loss does not reach (BERT's pooler and NSP
            # head without NSP labels) gets a zero gradient, as jax.grad
            # gives it, so the optimizer still decays it and steps its
            # moments
            grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                     for n, p in self.params.items()}
            self.optimizer.apply_gradients(self.params, grads,
                                           self.opt_state, lr)
            for p in self.params.values():
                p.grad = None
        sched = self.optimizer.lr_scheduler
        if sched is not None:
            sched.step()
        return loss.detach()

    def state_dict(self) -> Dict[str, Any]:
        """A copy of everything needed to resume this step exactly:
        params, optimizer state, buffers, the step counter and the
        scheduler's position."""
        sched = self.optimizer.lr_scheduler

        def copy(tree):
            if isinstance(tree, dict):
                return {k: copy(v) for k, v in tree.items()}
            return tree.detach().clone()

        return {
            "params": copy(self.params),
            "opt_state": copy(self.opt_state),
            "buffers": {n: b.detach().clone()
                        for n, b in self.model.named_buffers()},
            "step_count": int(self._step_count),
            "lr_sched": sched.state_dict() if sched is not None else None,
        }

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore a :meth:`state_dict` (tensors or numpy arrays, on any
        device) into this step's parameters and optimizer state."""
        for n, v in state["params"].items():
            self.params[n].copy_(torch.as_tensor(v))
        buffers = dict(self.model.named_buffers())
        for n, v in state.get("buffers", {}).items():
            # replaced in the saved dtype, not copied into the current
            # buffer: BN's running stats come back float32 from a step of a
            # bf16 model, and a copy would round them to bf16
            owner, _, leaf = n.rpartition(".")
            setattr(self.model.get_submodule(owner), leaf, torch.as_tensor(
                v, device=buffers[n].device).clone())
        opt = state["opt_state"]
        self.opt_state = {
            "step": torch.as_tensor(opt["step"], dtype=torch.int32,
                                    device=self.device).clone(),
            "param_states": {
                n: {k: torch.as_tensor(v, dtype=torch.float32,
                                       device=self.device).clone()
                    for k, v in st.items()}
                for n, st in opt["param_states"].items()}}
        self._step_count = int(state["step_count"])
        sched = self.optimizer.lr_scheduler
        if sched is not None and state.get("lr_sched") is not None:
            sched.set_state_dict(state["lr_sched"])


def make_sharded_train_step(model: nn.Module, optimizer, loss_fn: Callable,
                            mesh=None) -> TrainStep:
    """Build a :class:`TrainStep`. ``loss_fn(model, batch) -> scalar loss``
    runs the model on the batch, e.g.::

        def loss_fn(model, batch):
            ids, labels = batch
            return model(ids, labels)
    """
    return TrainStep(model, optimizer, loss_fn, mesh)
