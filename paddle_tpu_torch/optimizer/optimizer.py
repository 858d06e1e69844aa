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
``weight_decay`` may be a float or a regularizer (:mod:`..regularizer`):
``L2Decay`` is the coupled decay, ``L1Decay`` adds ``coeff * sign(p)`` to
the float32 gradient.

The imperative surface (JAX ``:164-226``): built with ``parameters=``
(``model.parameters()``, or ``model.named_parameters()`` for state keys
under the parameters' names; bare parameters are named by their position,
``"0"``, ``"1"``, ...), ``step()`` updates every trainable parameter that
has a ``.grad`` in place, ``clear_grad()`` drops the gradients, and
``state_dict()``/``set_state_dict()`` hold the state under JAX's
``"<name>@<key>"`` keys (plus ``"step"`` and ``"LR_Scheduler"``).

Adamax and Adadelta keep the float32 master of a 16-bit parameter, as the
other optimizers do; the JAX versions return a state without it after the
first update.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from ..regularizer import L1Decay, L2Decay
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad",
           "RMSProp", "Lamb", "Lars", "Adamax", "Adadelta", "LBFGS"]

Params = Dict[str, torch.Tensor]
State = Dict[str, Any]


class Optimizer:
    def __init__(self, learning_rate: Union[float, LRScheduler] = 0.001,
                 parameters=None, weight_decay: float = 0.0, grad_clip=None,
                 multi_precision: bool = True, name: Optional[str] = None):
        self._learning_rate = learning_rate
        self._params: Optional[List[Tuple[str, torch.Tensor]]] = (
            None if parameters is None else _named(parameters))
        self.l1_decay = 0.0
        if isinstance(weight_decay, L1Decay):
            self.l1_decay = weight_decay.coeff
            weight_decay = 0.0
        elif isinstance(weight_decay, L2Decay):
            weight_decay = weight_decay.coeff
        self.weight_decay = float(weight_decay or 0.0)
        self.grad_clip = grad_clip
        self.multi_precision = multi_precision
        self._eager_state: Optional[State] = None

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

    def _init_full_param_state(self, p: torch.Tensor
                               ) -> Dict[str, torch.Tensor]:
        st = self._init_param_state(p)
        if self._needs_master(p):
            st["master"] = p.detach().float()
        return st

    @torch.no_grad()
    def init(self, params: Params) -> State:
        pstates = {name: self._init_full_param_state(p)
                   for name, p in params.items()}
        device = next(iter(params.values())).device if params else None
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
            g32 = g.float()
            if self.l1_decay:
                g32 = g32 + self.l1_decay * torch.sign(p32)
            self._update(name, p32, g32, st, scalars)
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

    # -- imperative surface ---------------------------------------------------

    def _refs(self) -> List[Tuple[str, torch.Tensor]]:
        if self._params is None:
            raise RuntimeError(
                "the optimizer was built without `parameters=`; use the "
                "functional API (init/apply_gradients) instead of step()")
        return self._params

    @torch.no_grad()
    def step(self) -> None:
        """One update of every trainable parameter with a ``.grad``, in
        place; the state is made at the first call (and for a parameter
        that first has a gradient later)."""
        trainable = [(n, p) for n, p in self._refs() if p.requires_grad]
        if self._eager_state is None:
            self._eager_state = self.init(dict(trainable))
        params = {n: p for n, p in trainable if p.grad is not None}
        pstates = self._eager_state["param_states"]
        for n, p in params.items():
            if n not in pstates:
                pstates[n] = self._init_full_param_state(p)
        self.apply_gradients(params, {n: p.grad for n, p in params.items()},
                             self._eager_state)

    def minimize(self, loss=None, startup_program=None, parameters=None,
                 no_grad_set=None) -> None:
        """paddle parity: the loss's ``backward()`` has filled ``.grad``;
        this applies the step."""
        self.step()

    def clear_grad(self) -> None:
        for _, p in self._refs():
            p.grad = None

    clear_gradients = clear_grad

    def state_dict(self) -> Dict[str, Any]:
        """``{"step", "<name>@<key>": tensor, ..., "LR_Scheduler"}``: the
        imperative state under JAX's keys."""
        out: Dict[str, Any] = {}
        if self._eager_state is not None:
            out["step"] = self._eager_state["step"]
            for pname, st in self._eager_state["param_states"].items():
                for k, v in st.items():
                    out[f"{pname}@{k}"] = v
        sched = self.lr_scheduler
        if sched is not None:
            out["LR_Scheduler"] = sched.state_dict()
        return out

    def set_state_dict(self, state: Dict[str, Any]) -> None:
        """Load a :meth:`state_dict` (tensors or numpy arrays), each leaf
        onto its parameter's device."""
        state = dict(state)
        sched_state = state.pop("LR_Scheduler", None)
        if sched_state is not None and self.lr_scheduler is not None:
            self.lr_scheduler.set_state_dict(sched_state)
        step = state.pop("step", 0)
        devices = {n: p.device for n, p in (self._params or [])}
        pstates: Dict[str, Dict[str, torch.Tensor]] = {}
        for key, v in state.items():
            pname, _, k = key.rpartition("@")
            pstates.setdefault(pname, {})[k] = torch.as_tensor(
                v, dtype=torch.float32,
                device=devices.get(pname, "cpu")).clone()
        device = next(iter(devices.values()), "cpu")
        self._eager_state = {
            "step": torch.as_tensor(step, dtype=torch.int32,
                                    device=device).clone(),
            "param_states": pstates}


def _named(parameters) -> List[Tuple[str, torch.Tensor]]:
    """``[(name, parameter)]`` of ``parameters``: pairs as
    ``named_parameters()`` gives them, or bare parameters named by their
    position."""
    out = []
    for i, item in enumerate(parameters):
        if isinstance(item, tuple):
            out.append((str(item[0]), item[1]))
        else:
            out.append((str(i), item))
    return out


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


class Adagrad(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon: float = 1e-6,
                 parameters=None, weight_decay=0.0, grad_clip=None,
                 initial_accumulator_value: float = 0.0,
                 multi_precision=True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self.epsilon = epsilon
        self.initial_accumulator_value = initial_accumulator_value

    def _init_param_state(self, p):
        return {"moment": torch.full(p.shape, self.initial_accumulator_value,
                                     dtype=torch.float32, device=p.device)}

    def _update(self, name, p32, g32, st, scalars):
        if self.weight_decay:
            g32 = g32 + self.weight_decay * p32
        acc = st["moment"]
        acc.add_(torch.square(g32))
        p32.sub_(scalars["lr"] * g32 / (torch.sqrt(acc) + self.epsilon))


class RMSProp(Optimizer):
    def __init__(self, learning_rate=0.01, rho: float = 0.95,
                 epsilon: float = 1e-6, momentum: float = 0.0,
                 centered: bool = False, parameters=None, weight_decay=0.0,
                 grad_clip=None, multi_precision=True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self.rho, self.epsilon = rho, epsilon
        self.momentum, self.centered = momentum, centered

    def _init_param_state(self, p):
        st = {"mean_square": self._zeros(p), "momentum": self._zeros(p)}
        if self.centered:
            st["mean_grad"] = self._zeros(p)
        return st

    def _update(self, name, p32, g32, st, scalars):
        if self.weight_decay:
            g32 = g32 + self.weight_decay * p32
        ms = st["mean_square"]
        ms.copy_(self.rho * ms + (1 - self.rho) * torch.square(g32))
        if self.centered:
            mg = st["mean_grad"]
            mg.copy_(self.rho * mg + (1 - self.rho) * g32)
            denom = torch.sqrt(ms - torch.square(mg) + self.epsilon)
        else:
            denom = torch.sqrt(ms + self.epsilon)
        mom = st["momentum"]
        mom.copy_(self.momentum * mom + scalars["lr"] * g32 / denom)
        p32.sub_(mom)


class Lamb(Optimizer):
    """Layer-wise adaptive rates: the Adam direction plus decay, scaled by
    ``||p|| / ||update||``."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay: float = 0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=True):
        super().__init__(learning_rate, parameters, 0.0, grad_clip,
                         multi_precision)
        self.lamb_weight_decay = lamb_weight_decay
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.exclude_fn = exclude_from_weight_decay_fn

    _init_param_state = Adam._init_param_state
    _scalars = Adam._scalars

    def _update(self, name, p32, g32, st, scalars):
        m, v = st["moment1"], st["moment2"]
        m.copy_(self.beta1 * m + (1 - self.beta1) * g32)
        v.copy_(self.beta2 * v + (1 - self.beta2) * torch.square(g32))
        update = (m / scalars["bc1"]) / (torch.sqrt(v / scalars["bc2"]) +
                                         self.epsilon)
        if self.lamb_weight_decay and not (self.exclude_fn and
                                           self.exclude_fn(name)):
            update = update + self.lamb_weight_decay * p32
        w_norm = torch.linalg.vector_norm(p32)
        u_norm = torch.linalg.vector_norm(update)
        ratio = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                            torch.ones_like(w_norm))
        p32.sub_(scalars["lr"] * ratio * update)


class Lars(Optimizer):
    """LARS momentum: ``local_lr = lr * coeff * ||w|| / (||g|| + wd *
    ||w|| + eps)``."""

    def __init__(self, learning_rate=0.001, momentum: float = 0.9,
                 lars_coeff: float = 0.001, lars_weight_decay: float = 0.0005,
                 parameters=None, grad_clip=None, epsilon: float = 1e-9,
                 exclude_from_weight_decay=(), multi_precision=True):
        super().__init__(learning_rate, parameters, 0.0, grad_clip,
                         multi_precision)
        self.momentum = momentum
        self.lars_coeff = lars_coeff
        self.lars_weight_decay = lars_weight_decay
        self.epsilon = epsilon
        self.exclude_from_weight_decay = tuple(exclude_from_weight_decay)

    def _init_param_state(self, p):
        return {"velocity": self._zeros(p)}

    def _update(self, name, p32, g32, st, scalars):
        wd = self.lars_weight_decay
        if any(tag in name for tag in self.exclude_from_weight_decay):
            wd = 0.0
        lr = scalars["lr"]
        w_norm = torch.linalg.vector_norm(p32)
        g_norm = torch.linalg.vector_norm(g32)
        local_lr = torch.where(
            (w_norm > 0) & (g_norm > 0),
            lr * self.lars_coeff * w_norm
            / (g_norm + wd * w_norm + self.epsilon), lr)
        v = st["velocity"]
        v.copy_(self.momentum * v + local_lr * (g32 + wd * p32))
        p32.sub_(v)


class Adamax(Adam):
    """The infinity-norm Adam: ``u = max(beta2 * u, |g|)``, no bias
    correction on ``u``."""

    def _init_param_state(self, p):
        return {"moment": self._zeros(p), "inf_norm": self._zeros(p)}

    def _update(self, name, p32, g32, st, scalars):
        if self.weight_decay:
            g32 = g32 + self.weight_decay * p32
        m, u = st["moment"], st["inf_norm"]
        m.copy_(self.beta1 * m + (1 - self.beta1) * g32)
        u.copy_(torch.maximum(self.beta2 * u, torch.abs(g32)))
        p32.sub_(scalars["lr"] / scalars["bc1"] * m / (u + self.epsilon))


class Adadelta(Optimizer):
    """The unit-consistent accumulated-delta rule."""

    def __init__(self, learning_rate=0.001, epsilon: float = 1e-6,
                 rho: float = 0.95, parameters=None, weight_decay=0.0,
                 grad_clip=None, multi_precision=True, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self.epsilon, self.rho = epsilon, rho

    def _init_param_state(self, p):
        return {"avg_squared_grad": self._zeros(p),
                "avg_squared_update": self._zeros(p)}

    def _update(self, name, p32, g32, st, scalars):
        if self.weight_decay:
            g32 = g32 + self.weight_decay * p32
        eg, eu = st["avg_squared_grad"], st["avg_squared_update"]
        eg.copy_(self.rho * eg + (1 - self.rho) * torch.square(g32))
        delta = -torch.sqrt((eu + self.epsilon) / (eg + self.epsilon)) * g32
        eu.copy_(self.rho * eu + (1 - self.rho) * torch.square(delta))
        p32.add_(scalars["lr"] * delta)


class LBFGS(Optimizer):
    """Limited-memory BFGS at fixed steps (JAX ``:517-600``): the two-loop
    recursion over a rolling ``(s, y, rho)`` history of ``history_size``
    pairs kept in the state, per parameter, flattened, in float32 (the
    keys ``s_hist``, ``y_hist``, ``rho_hist``, ``prev_flat_p``,
    ``prev_flat_g`` and ``n_hist``). A step adds the pair of the previous
    step from its second step on, where ``s . y > 1e-10``; the first
    direction's scale ``gamma`` comes from the newest pair. Both loops run
    over all ``history_size`` slots, newest to oldest and then oldest to
    newest, as JAX's ``lax.scan``s do: an empty slot has ``rho = 0`` and
    changes nothing, and the sums keep JAX's order. The history is updated
    with ``torch.where`` on the device, so a step reads nothing back to the
    host. ``line_search_fn="strong_wolfe"`` needs the loss evaluated again
    inside the step and raises, as in JAX."""

    def __init__(self, learning_rate=1.0, max_iter: int = 20,
                 history_size: int = 10, epsilon: float = 1e-8,
                 parameters=None, weight_decay=0.0, grad_clip=None,
                 line_search_fn=None, multi_precision=True, name=None,
                 tolerance_grad: float = 1e-7,
                 tolerance_change: float = 1e-9):
        if line_search_fn not in (None, "None"):
            raise NotImplementedError(
                "LBFGS(line_search_fn='strong_wolfe') needs closure "
                "re-evaluation; use the default fixed-step mode")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self.history_size = int(history_size)
        self.epsilon = epsilon

    def _init_param_state(self, p):
        h, flat = self.history_size, p.numel()

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=p.device)

        return {"s_hist": zeros(h, flat), "y_hist": zeros(h, flat),
                "rho_hist": zeros(h), "prev_flat_p": zeros(flat),
                "prev_flat_g": zeros(flat),
                "n_hist": zeros(dtype=torch.int32)}

    def _scalars(self, lr, step):
        return {"lr": lr, "step": step}

    def _update(self, name, p32, g32, st, scalars):
        if self.weight_decay:
            g32 = g32 + self.weight_decay * p32
        h = self.history_size
        flat_p = p32.reshape(-1)
        flat_g = g32.reshape(-1)
        s = flat_p - st["prev_flat_p"]
        y = flat_g - st["prev_flat_g"]
        sy = torch.dot(s, y)
        have_pair = (scalars["step"] > 1) & (sy > 1e-10)

        def roll(key, new):
            hist = st[key]
            hist.copy_(torch.where(
                have_pair, torch.cat([hist[1:], new[None]]), hist))

        roll("s_hist", s)
        roll("y_hist", y)
        roll("rho_hist", 1.0 / torch.clamp(sy, min=1e-10))
        n_hist = st["n_hist"]
        n_hist.copy_(torch.where(have_pair, torch.clamp(n_hist + 1, max=h),
                                 n_hist))
        s_hist, y_hist, rho_hist = st["s_hist"], st["y_hist"], st["rho_hist"]

        q = flat_g
        alphas = [None] * h
        for idx in range(h - 1, -1, -1):
            alphas[idx] = rho_hist[idx] * torch.dot(s_hist[idx], q)
            q = q - alphas[idx] * y_hist[idx]
        yy = torch.dot(y_hist[-1], y_hist[-1])
        gamma = torch.where(
            n_hist > 0,
            (1.0 / torch.clamp(rho_hist[-1], min=1e-10))
            / torch.clamp(yy, min=self.epsilon),
            torch.ones_like(yy))
        r = gamma * q
        for i in range(h):
            beta = rho_hist[i] * torch.dot(y_hist[i], r)
            r = r + s_hist[i] * (alphas[i] - beta)
        st["prev_flat_p"].copy_(flat_p)
        st["prev_flat_g"].copy_(flat_g)
        p32.sub_((scalars["lr"] * r).view_as(p32))
