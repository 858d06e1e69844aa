"""Dynamic loss scaling (``paddle_tpu/amp/grad_scaler.py`` counterpart).

The JAX package's functional core and imperative surface, on torch
tensors. :func:`unscale_and_check` divides gradients by the scale (in
float32, each cast back to its dtype) and reports whether any is not
finite; :meth:`AmpScaler.update_state` moves ``(scale, good, bad)`` by one
step: ×``incr_ratio`` after ``incr_every_n_steps`` good steps in a row,
×``decr_ratio`` (no lower than 1) after ``decr_every_n_nan_or_inf`` bad
ones, with JAX's defaults 2^15, 2, 0.5, 1000 and 2. The imperative
surface (``scale``, ``unscale_``, ``step``, ``update``, ``minimize``) works
on the ``.grad`` of an imperative optimizer's parameters, and skips the
optimizer's step when a gradient is not finite. bf16 needs no scaling;
float16 under O1 does.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

__all__ = ["GradScaler", "AmpScaler", "unscale_and_check"]


def unscale_and_check(grads, scale: torch.Tensor):
    """``grads`` (a dict or a list; None entries pass) divided by
    ``scale``, and a bool tensor: whether any of them is not finite."""
    inv = 1.0 / torch.as_tensor(scale, dtype=torch.float32)

    def unscale(g):
        if g is None:
            return None
        return (g.float() * inv.to(g.device)).to(g.dtype)

    if isinstance(grads, Mapping):
        unscaled = {k: unscale(g) for k, g in grads.items()}
        leaves = [g for g in unscaled.values() if g is not None]
    else:
        unscaled = [unscale(g) for g in grads]
        leaves = [g for g in unscaled if g is not None]
    if not leaves:
        return unscaled, torch.tensor(False)
    finite = torch.stack([torch.isfinite(g).all().to(leaves[0].device)
                          for g in leaves])
    return unscaled, ~finite.all()


class AmpScaler:
    """Dynamic loss scaler: the functional state ``{"scale", "good",
    "bad"}`` and the imperative surface over it."""

    def __init__(self, enable: bool = True,
                 init_loss_scaling: float = 2.0 ** 15,
                 incr_ratio: float = 2.0, decr_ratio: float = 0.5,
                 incr_every_n_steps: int = 1000,
                 decr_every_n_nan_or_inf: int = 2,
                 use_dynamic_loss_scaling: bool = True):
        self._enable = enable
        self._init_loss_scaling = init_loss_scaling
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._use_dynamic = use_dynamic_loss_scaling
        self._scale = torch.tensor(init_loss_scaling, dtype=torch.float32)
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False

    # -- functional core ----------------------------------------------------

    def init_state(self) -> Dict[str, torch.Tensor]:
        return {"scale": torch.tensor(self._init_loss_scaling,
                                      dtype=torch.float32),
                "good": torch.zeros((), dtype=torch.int32),
                "bad": torch.zeros((), dtype=torch.int32)}

    def update_state(self, state: Dict[str, torch.Tensor], found_inf):
        """``(scale, good, bad)`` after a step whose gradients were
        (``found_inf``) or were not finite; a new dict."""
        if not (self._enable and self._use_dynamic):
            return state
        scale, good, bad = state["scale"], state["good"], state["bad"]
        found = torch.as_tensor(found_inf, dtype=torch.bool,
                                device=scale.device)
        zero = torch.zeros_like(good)
        bad = torch.where(found, bad + 1, zero)
        good = torch.where(found, zero, good + 1)
        decr = bad >= self._decr_every_n_nan_or_inf
        incr = good >= self._incr_every_n_steps
        scale = torch.where(decr, torch.clamp(scale * self._decr_ratio,
                                              min=1.0), scale)
        scale = torch.where(incr, scale * self._incr_ratio, scale)
        good = torch.where(incr | decr, zero, good)
        bad = torch.where(decr, zero, bad)
        return {"scale": scale, "good": good, "bad": bad}

    # -- imperative surface ---------------------------------------------------

    def is_enable(self) -> bool:
        return self._enable

    def is_use_dynamic_loss_scaling(self) -> bool:
        return self._use_dynamic

    def get_loss_scaling(self) -> torch.Tensor:
        return self._scale

    def set_init_loss_scaling(self, v: float) -> None:
        self._scale = torch.tensor(v, dtype=torch.float32)

    def scale(self, loss: torch.Tensor) -> torch.Tensor:
        if not self._enable:
            return loss
        return loss * self._scale.to(device=loss.device, dtype=loss.dtype)

    def unscale_(self, optimizer) -> None:
        """Divide the ``.grad`` of ``optimizer``'s parameters by the scale
        and note whether one is not finite."""
        if not self._enable:
            return
        refs = [(n, p) for n, p in optimizer._refs() if p.grad is not None]
        unscaled, found = unscale_and_check({n: p.grad for n, p in refs},
                                            self._scale)
        self._found_inf = bool(found)
        for n, p in refs:
            p.grad = unscaled[n]
        self._unscaled = True

    def step(self, optimizer) -> None:
        """Unscale (unless :meth:`unscale_` did), then the optimizer's step
        unless a gradient was not finite."""
        if not self._enable:
            optimizer.step()
            return
        if not self._unscaled:
            self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._unscaled = False

    def update(self) -> None:
        if not (self._enable and self._use_dynamic):
            return
        new = self.update_state(
            {"scale": self._scale,
             "good": torch.tensor(self._good_steps, dtype=torch.int32),
             "bad": torch.tensor(self._bad_steps, dtype=torch.int32)},
            self._found_inf)
        self._scale = new["scale"]
        self._good_steps = int(new["good"])
        self._bad_steps = int(new["bad"])
        self._found_inf = False

    def minimize(self, optimizer, scaled_loss=None) -> None:
        self.step(optimizer)
        self.update()

    def state_dict(self) -> Dict[str, Any]:
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_every_n_steps": self._incr_every_n_steps,
                "decr_every_n_nan_or_inf": self._decr_every_n_nan_or_inf,
                "good_steps": self._good_steps, "bad_steps": self._bad_steps,
                "use_dynamic_loss_scaling": self._use_dynamic}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self._scale = torch.as_tensor(state["scale"],
                                      dtype=torch.float32).clone()
        self._good_steps = int(state.get("good_steps", 0))
        self._bad_steps = int(state.get("bad_steps", 0))


class GradScaler(AmpScaler):
    """``paddle.amp.GradScaler``: :class:`AmpScaler`'s surface."""
