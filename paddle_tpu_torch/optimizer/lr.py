"""Learning-rate schedulers — a copy of ``paddle_tpu/optimizer/lr.py``.

Pure Python, with no import of the JAX package (the port keeps its own
copy of the modules it needs). Parity with ``python/paddle/optimizer/lr.py``
(LRScheduler and the common decays). Schedulers are host-side stateful
objects: the train step reads the current value each step and steps the
scheduler after the update. Every scheduler also exposes ``value_at(step)``
as a pure function of the step.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

__all__ = [
    "LRScheduler", "NoamDecay", "PiecewiseDecay", "NaturalExpDecay",
    "ExponentialDecay", "InverseTimeDecay", "PolynomialDecay", "LinearWarmup",
    "StepDecay", "MultiStepDecay", "LambdaDecay", "CosineAnnealingDecay",
    "OneCycleLR", "ReduceOnPlateau",
]


class LRScheduler:
    def __init__(self, learning_rate: float = 0.1, last_epoch: int = -1,
                 verbose: bool = False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.verbose = verbose
        self.step()

    def get_lr(self) -> float:
        return self.last_lr

    def value_at(self, step: int) -> float:
        raise NotImplementedError

    def step(self, epoch: Optional[int] = None) -> None:
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self.value_at(self.last_epoch)

    def state_dict(self):
        return {"last_epoch": self.last_epoch, "last_lr": self.last_lr}

    def set_state_dict(self, state) -> None:
        self.last_epoch = state["last_epoch"]
        self.last_lr = state["last_lr"]

    set_dict = set_state_dict
    state_keys = state_dict


class NoamDecay(LRScheduler):
    """lr = base * d_model^-0.5 * min(step^-0.5, step * warmup^-1.5)."""

    def __init__(self, d_model: int, warmup_steps: int, learning_rate: float = 1.0,
                 last_epoch: int = -1, verbose: bool = False):
        self.d_model, self.warmup_steps = d_model, warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def value_at(self, step: int) -> float:
        step = max(step, 1)
        return (self.base_lr * self.d_model ** -0.5 *
                min(step ** -0.5, step * self.warmup_steps ** -1.5))


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries: Sequence[int], values: Sequence[float],
                 last_epoch: int = -1, verbose: bool = False):
        self.boundaries, self.values = list(boundaries), list(values)
        super().__init__(values[0], last_epoch, verbose)

    def value_at(self, step: int) -> float:
        for b, v in zip(self.boundaries, self.values):
            if step < b:
                return v
        return self.values[len(self.boundaries)]


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate: float, gamma: float, last_epoch: int = -1,
                 verbose: bool = False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def value_at(self, step: int) -> float:
        return self.base_lr * math.exp(-self.gamma * step)


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate: float, gamma: float, last_epoch: int = -1,
                 verbose: bool = False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def value_at(self, step: int) -> float:
        return self.base_lr * self.gamma ** step


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate: float, gamma: float, last_epoch: int = -1,
                 verbose: bool = False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def value_at(self, step: int) -> float:
        return self.base_lr / (1 + self.gamma * step)


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate: float, decay_steps: int,
                 end_lr: float = 0.0001, power: float = 1.0, cycle: bool = False,
                 last_epoch: int = -1, verbose: bool = False):
        self.decay_steps, self.end_lr = decay_steps, end_lr
        self.power, self.cycle = power, cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def value_at(self, step: int) -> float:
        if self.cycle:
            div = max(1.0, math.ceil(step / self.decay_steps))
            decay_steps = self.decay_steps * div
        else:
            decay_steps = self.decay_steps
            step = min(step, decay_steps)
        return ((self.base_lr - self.end_lr) *
                (1 - step / decay_steps) ** self.power + self.end_lr)


class LinearWarmup(LRScheduler):
    def __init__(self, learning_rate, warmup_steps: int, start_lr: float,
                 end_lr: float, last_epoch: int = -1, verbose: bool = False):
        self.lr_after = learning_rate  # float or LRScheduler
        self.warmup_steps, self.start_lr, self.end_lr = warmup_steps, start_lr, end_lr
        super().__init__(start_lr, last_epoch, verbose)

    def value_at(self, step: int) -> float:
        if step < self.warmup_steps:
            return (self.end_lr - self.start_lr) * step / self.warmup_steps + self.start_lr
        if isinstance(self.lr_after, LRScheduler):
            return self.lr_after.value_at(step - self.warmup_steps)
        return float(self.lr_after)


class StepDecay(LRScheduler):
    def __init__(self, learning_rate: float, step_size: int, gamma: float = 0.1,
                 last_epoch: int = -1, verbose: bool = False):
        self.step_size, self.gamma = step_size, gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def value_at(self, step: int) -> float:
        return self.base_lr * self.gamma ** (step // self.step_size)


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate: float, milestones: Sequence[int],
                 gamma: float = 0.1, last_epoch: int = -1, verbose: bool = False):
        self.milestones, self.gamma = sorted(milestones), gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def value_at(self, step: int) -> float:
        n = sum(1 for m in self.milestones if step >= m)
        return self.base_lr * self.gamma ** n


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate: float, lr_lambda: Callable[[int], float],
                 last_epoch: int = -1, verbose: bool = False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def value_at(self, step: int) -> float:
        return self.base_lr * self.lr_lambda(step)


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate: float, T_max: int, eta_min: float = 0.0,
                 last_epoch: int = -1, verbose: bool = False):
        self.T_max, self.eta_min = T_max, eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def value_at(self, step: int) -> float:
        return (self.eta_min + (self.base_lr - self.eta_min) *
                (1 + math.cos(math.pi * (step % (2 * self.T_max)) / self.T_max)) / 2)


class OneCycleLR(LRScheduler):
    def __init__(self, max_learning_rate: float, total_steps: int,
                 divide_factor: float = 25.0, end_learning_rate: float = 0.0001,
                 phase_pct: float = 0.3, anneal_strategy: str = "cos",
                 last_epoch: int = -1, verbose: bool = False):
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        self.initial_lr = max_learning_rate / divide_factor
        self.end_lr = end_learning_rate
        self.up_steps = int(phase_pct * total_steps)
        self.anneal = anneal_strategy
        super().__init__(self.initial_lr, last_epoch, verbose)

    def _anneal(self, start, end, pct):
        if self.anneal == "cos":
            return end + (start - end) * (1 + math.cos(math.pi * pct)) / 2
        return start + (end - start) * pct

    def value_at(self, step: int) -> float:
        step = min(step, self.total_steps)
        if step <= self.up_steps:
            pct = step / max(self.up_steps, 1)
            # warmup: initial_lr -> max_lr as pct goes 0 -> 1
            # (_anneal(a, b, p) returns a at p=0 and b at p=1)
            return self._anneal(self.initial_lr, self.max_lr, pct) \
                if self.anneal == "cos" else \
                self.initial_lr + (self.max_lr - self.initial_lr) * pct
        pct = (step - self.up_steps) / max(self.total_steps - self.up_steps, 1)
        return self._anneal(self.max_lr, self.end_lr, pct)


class ReduceOnPlateau(LRScheduler):
    """Metric-driven: call ``step(metric)`` after each eval."""

    def __init__(self, learning_rate: float, mode: str = "min", factor: float = 0.1,
                 patience: int = 10, threshold: float = 1e-4, cooldown: int = 0,
                 min_lr: float = 0.0, verbose: bool = False):
        self.mode, self.factor, self.patience = mode, factor, patience
        self.threshold, self.cooldown, self.min_lr = threshold, cooldown, min_lr
        self.best = None
        self.num_bad = 0
        self.cooldown_counter = 0
        self.base_lr = float(learning_rate)
        self.last_lr = self.base_lr
        self.last_epoch = 0
        self.verbose = verbose

    def value_at(self, step: int) -> float:
        return self.last_lr

    def _better(self, a, b) -> bool:
        if self.mode == "min":
            return a < b - self.threshold
        return a > b + self.threshold

    def step(self, metrics=None, epoch=None) -> None:
        if metrics is None:
            return
        self.last_epoch += 1
        m = float(metrics)
        if self.best is None or self._better(m, self.best):
            self.best = m
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        if self.num_bad > self.patience:
            self.last_lr = max(self.last_lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad = 0
