"""Optimizers (``paddle_tpu/optimizer/optimizer.py`` counterpart).

The functional core of the JAX package, on torch tensors:
``state = opt.init(params)`` and
``params, state = opt.apply_gradients(params, grads, state, lr)``, where
``params`` and ``grads`` are dicts ``{name: tensor}`` and the state keeps
the JAX layout ``{"step", "param_states": {name: {"moment1", "moment2",
"master"}}}`` (``"velocity"`` for Momentum, nothing for SGD).

Unlike the JAX version, which returns new arrays, ``apply_gradients``
updates the parameters and the state **in place** (and returns the same
dicts), so a model's parameters hold the new values and no second copy of
the weights or moments is made. The update is written out as plain torch
ops under ``no_grad`` in the reference's order: the JAX package leaves it
to XLA fusion, so it is not a TPU kernel and has no hand-written kernel
here (no ``torch.optim`` either). With ``multi_precision`` a bf16/fp16
parameter has a float32 master copy in its state; the update runs on the
master and is cast back into the parameter. ``grad_clip`` is applied to
the gradients before the update. Scalars (lr, the bias corrections) are
float32 tensors on the parameters' device, as they are in the JAX step.
"""

from __future__ import annotations

from numbers import Real
from typing import Any, Dict, Optional, Union

import torch

from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW"]

Params = Dict[str, torch.Tensor]
State = Dict[str, Any]


class Optimizer:
    def __init__(self, learning_rate: Union[float, LRScheduler] = 0.001,
                 parameters=None, weight_decay: float = 0.0, grad_clip=None,
                 multi_precision: bool = True, name: Optional[str] = None):
        if parameters is not None:
            raise NotImplementedError(
                "the imperative optimizer (parameters=, step()) is not "
                "ported yet; use init/apply_gradients or TrainStep")
        if not isinstance(weight_decay or 0.0, Real):
            raise NotImplementedError(
                "regularizer objects (L1Decay/L2Decay) are not ported yet; "
                "pass weight_decay as a float")
        self._learning_rate = learning_rate
        self.weight_decay = float(weight_decay or 0.0)
        self.grad_clip = grad_clip
        self.multi_precision = multi_precision

    # -- lr -----------------------------------------------------------------

    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate.get_lr())
        return float(self._learning_rate)

    def set_lr(self, lr: float) -> None:
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("set_lr not allowed when using an LRScheduler")
        self._learning_rate = float(lr)

    @property
    def lr_scheduler(self) -> Optional[LRScheduler]:
        return (self._learning_rate
                if isinstance(self._learning_rate, LRScheduler) else None)

    # -- functional core ------------------------------------------------------

    def _needs_master(self, p: torch.Tensor) -> bool:
        return self.multi_precision and p.dtype in (torch.bfloat16,
                                                    torch.float16)

    def _init_param_state(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def _zeros(self, p: torch.Tensor) -> torch.Tensor:
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    @torch.no_grad()
    def init(self, params: Params) -> State:
        pstates = {}
        device = None
        for name, p in params.items():
            st = self._init_param_state(p)
            if self._needs_master(p):
                st["master"] = p.detach().float()
            pstates[name] = st
            device = p.device
        step = torch.zeros((), dtype=torch.int32, device=device)
        return {"step": step, "param_states": pstates}

    @torch.no_grad()
    def apply_gradients(self, params: Params, grads, state: State,
                        lr: Optional[float] = None):
        """One update of every parameter that has a gradient, in place.
        Returns ``(params, state)``, the objects passed in."""
        if lr is None:
            lr = self.get_lr()
        if self.grad_clip is not None:
            grads = self.grad_clip(grads)
        state["step"] += 1
        scalars = None
        for name, g in grads.items():
            if g is None:
                continue
            p = params[name]
            if scalars is None:
                scalars = self._scalars(torch.as_tensor(
                    lr, dtype=torch.float32, device=p.device),
                    state["step"].to(p.device))
            st = state["param_states"][name]
            if "master" in st:
                p32 = st["master"]
            elif p.dtype == torch.float32:
                p32 = p                      # updated where it lies
            else:
                p32 = p.float()
            self._update(name, p32, g.float(), st, scalars)
            if p32 is not p:
                p.copy_(p32)
        return params, state

    def _scalars(self, lr: torch.Tensor, step: torch.Tensor) -> Dict:
        """The update's scalars, once per step: lr (float32) and, for Adam,
        the bias corrections."""
        return {"lr": lr}

    def _update(self, name: str, p32: torch.Tensor, g32: torch.Tensor,
                st: Dict[str, torch.Tensor], scalars: Dict) -> None:
        """Update the float32 parameter ``p32`` and the state ``st`` in
        place."""
        raise NotImplementedError


class SGD(Optimizer):
    def _update(self, name, p32, g32, st, scalars):
        if self.weight_decay:
            g32 = g32 + self.weight_decay * p32
        p32.sub_(scalars["lr"] * g32)


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum: float = 0.9,
                 parameters=None, use_nesterov: bool = False,
                 weight_decay=0.0, grad_clip=None, multi_precision=True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self.momentum = momentum
        self.use_nesterov = use_nesterov

    def _init_param_state(self, p):
        return {"velocity": self._zeros(p)}

    def _update(self, name, p32, g32, st, scalars):
        if self.weight_decay:
            g32 = g32 + self.weight_decay * p32
        v = st["velocity"]
        v.mul_(self.momentum).add_(g32)
        if self.use_nesterov:
            p32.sub_(scalars["lr"] * (g32 + self.momentum * v))
        else:
            p32.sub_(scalars["lr"] * v)


class Adam(Optimizer):
    """weight_decay here is L2 (coupled); use AdamW for decoupled decay."""

    def __init__(self, learning_rate=0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8, parameters=None,
                 weight_decay=0.0, grad_clip=None, lazy_mode: bool = False,
                 multi_precision=True, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _init_param_state(self, p):
        return {"moment1": self._zeros(p), "moment2": self._zeros(p)}

    def _scalars(self, lr, step):
        stepf = step.float()
        b1 = torch.tensor(self.beta1, dtype=torch.float32, device=lr.device)
        b2 = torch.tensor(self.beta2, dtype=torch.float32, device=lr.device)
        return {"lr": lr, "bc1": 1 - b1 ** stepf, "bc2": 1 - b2 ** stepf}

    def _update(self, name, p32, g32, st, scalars):
        if self.weight_decay:
            g32 = g32 + self.weight_decay * p32
        m, v = st["moment1"], st["moment2"]
        m.mul_(self.beta1).add_((1 - self.beta1) * g32)
        v.mul_(self.beta2).add_((1 - self.beta2) * torch.square(g32))
        denom = torch.sqrt(v / scalars["bc2"]).add_(self.epsilon)
        p32.sub_(scalars["lr"] * (m / scalars["bc1"]) / denom)


class AdamW(Adam):
    """Decoupled weight decay: ``p * (1 - lr * weight_decay)`` before the
    Adam update, on every parameter (biases and LayerNorm included) unless
    ``apply_decay_param_fun(name)`` says otherwise."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay: float = 0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 multi_precision=True, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         0.0, grad_clip, multi_precision=multi_precision)
        self.decoupled_weight_decay = float(weight_decay)
        self.apply_decay_param_fun = apply_decay_param_fun

    def _update(self, name, p32, g32, st, scalars):
        apply_decay = (self.apply_decay_param_fun is None or
                       self.apply_decay_param_fun(name))
        if apply_decay and self.decoupled_weight_decay:
            p32.mul_(1.0 - scalars["lr"] * self.decoupled_weight_decay)
        super()._update(name, p32, g32, st, scalars)
