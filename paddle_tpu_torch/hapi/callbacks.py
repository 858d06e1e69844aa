"""Training callbacks (``paddle_tpu/hapi/callbacks.py`` counterpart):
ProgBarLogger, ModelCheckpoint, LRSchedulerCallback, EarlyStopping,
StatsLoggerCallback and :func:`config_callbacks`, which installs
``StatsLoggerCallback`` whenever ``FLAGS_telemetry`` is not ``off``, as in
JAX."""

from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np
import torch

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint",
           "LRSchedulerCallback", "EarlyStopping", "StatsLoggerCallback",
           "config_callbacks", "CallbackList"]


class Callback:
    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params

    def on_train_begin(self, logs=None): pass
    def on_train_end(self, logs=None): pass
    def on_epoch_begin(self, epoch, logs=None): pass
    def on_epoch_end(self, epoch, logs=None): pass
    def on_train_batch_begin(self, step, logs=None): pass
    def on_train_batch_end(self, step, logs=None): pass
    def on_eval_begin(self, logs=None): pass
    def on_eval_end(self, logs=None): pass
    def on_eval_batch_begin(self, step, logs=None): pass
    def on_eval_batch_end(self, step, logs=None): pass


class CallbackList:
    def __init__(self, callbacks: List[Callback]):
        self.callbacks = callbacks

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def fire(*args, **kwargs):
                for c in self.callbacks:
                    getattr(c, name)(*args, **kwargs)
            return fire
        raise AttributeError(name)


class ProgBarLogger(Callback):
    def __init__(self, log_freq: int = 10, verbose: int = 1):
        self.log_freq = log_freq
        self.verbose = verbose

    def on_train_begin(self, logs=None):
        self._t0 = time.time()

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self._steps = 0
        self._epoch_t0 = time.time()

    def on_train_batch_end(self, step, logs=None):
        self._steps += 1
        if self.verbose and step % self.log_freq == 0:
            items = ", ".join(f"{k}: {_fmt(v)}" for k, v in (logs or {}).items())
            dt = time.time() - self._epoch_t0
            print(f"Epoch {self.epoch} step {step}: {items} "
                  f"({self._steps / max(dt, 1e-9):.1f} steps/s)")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            items = ", ".join(f"{k}: {_fmt(v)}" for k, v in (logs or {}).items())
            print(f"Epoch {epoch} done: {items}")

    def on_eval_end(self, logs=None):
        if self.verbose:
            items = ", ".join(f"{k}: {_fmt(v)}" for k, v in (logs or {}).items())
            print(f"Eval: {items}")


def _fmt(v):
    try:
        arr = np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor)
                         else v)
        if arr.size == 1:
            return f"{float(arr):.6g}"
        return np.array2string(arr, precision=4)
    except Exception:
        return str(v)


class ModelCheckpoint(Callback):
    def __init__(self, save_freq: int = 1, save_dir: Optional[str] = None):
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class LRSchedulerCallback(Callback):
    """Steps the optimizer's LRScheduler (by epoch by default, per-batch if
    by_step)."""

    def __init__(self, by_step: bool = False, by_epoch: bool = True):
        self.by_step = by_step
        self.by_epoch = by_epoch and not by_step
        self._last_step_count = None

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        return opt.lr_scheduler if opt is not None else None

    def on_train_begin(self, logs=None):
        self._last_step_count = getattr(self.model, "_step_count", None)

    def on_train_batch_end(self, step, logs=None):
        sched = self._sched()
        if self.by_step and sched is not None:
            # Step per *optimizer update*, not per micro-batch: under
            # gradient accumulation only batches that applied an update
            # advance the schedule.
            count = getattr(self.model, "_step_count", None)
            if count is None or count != self._last_step_count:
                sched.step()
                self._last_step_count = count

    def on_epoch_end(self, epoch, logs=None):
        sched = self._sched()
        if self.by_epoch and sched is not None:
            sched.step()


class StatsLoggerCallback(Callback):
    """Per-epoch stat snapshots in the training log and a periodic
    ``StatsReporter`` for long epochs; ``fit`` owns the reporter's
    lifecycle (started at train begin, stopped at train end)."""

    def __init__(self, interval: float = 60.0, logger=None):
        from ..profiler.monitor import get_logger
        self.interval = interval
        self.logger = logger or get_logger("paddle_tpu_torch.monitor")
        self._reporter = None

    def on_train_begin(self, logs=None):
        from ..profiler.monitor import StatsReporter
        if self._reporter is None:
            self._reporter = StatsReporter(self.interval, logger=self.logger)
        self._reporter.start()

    def on_epoch_end(self, epoch, logs=None):
        from ..observability import metrics
        snap = metrics.stats_snapshot()
        if snap:
            self.logger.info("epoch %d stats %s", epoch, snap)

    def on_train_end(self, logs=None):
        if self._reporter is not None:
            self._reporter.stop()


class EarlyStopping(Callback):
    def __init__(self, monitor: str = "loss", mode: str = "auto",
                 patience: int = 0, verbose: int = 1, min_delta: float = 0,
                 baseline=None, save_best_model: bool = True):
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.verbose = verbose
        if mode == "auto":
            mode = "min" if "loss" in monitor or "err" in monitor else "max"
        self.mode = mode
        self.best = None
        self.wait = 0
        self.stopped_epoch = 0

    def _better(self, cur, best):
        if self.mode == "min":
            return cur < best - self.min_delta
        return cur > best + self.min_delta

    def on_eval_end(self, logs=None):
        logs = logs or {}
        if self.monitor not in logs:
            return
        cur = float(np.asarray(logs[self.monitor]).reshape(-1)[0])
        if self.best is None or self._better(cur, self.best):
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True


def config_callbacks(callbacks=None, model=None, log_freq: int = 10,
                     verbose: int = 1, save_freq: int = 1, save_dir=None,
                     metrics=None) -> CallbackList:
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks):
        cbks.insert(0, ProgBarLogger(log_freq, verbose))
    if not any(isinstance(c, LRSchedulerCallback) for c in cbks):
        cbks.append(LRSchedulerCallback())
    if save_dir and not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks.append(ModelCheckpoint(save_freq, save_dir))
    from ..observability.trace import telemetry_mode
    if telemetry_mode() != "off" and \
            not any(isinstance(c, StatsLoggerCallback) for c in cbks):
        cbks.append(StatsLoggerCallback())
    cl = CallbackList(cbks)
    if model is not None:
        cl.set_model(model)
    return cl
