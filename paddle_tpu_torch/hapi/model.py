"""High-level Model API (``paddle_tpu/hapi/model.py`` counterpart).

``Model(network)``, ``prepare(optimizer, loss, metrics, amp_configs)``,
then ``fit``, ``evaluate``, ``predict``, ``save``, ``load`` and
``summary``, as the JAX package runs them. A train batch is one eager
forward and backward on the network's device, then the optimizer's
functional ``apply_gradients`` over the trainable parameters, in place, on
the state ``opt.init`` made (``TrainStep``'s step), so the ``.pdopt`` file
holds the JAX ``"<name>@<key>"`` layout, ``step`` and ``LR_Scheduler``.
Each train batch draws one key from :mod:`..core.random`'s global
generator and runs under ``rng_scope(key)``, as the JAX step draws
``default_generator().next_key()``. ``train_batch`` returns the loss as a
numpy array, one host synchronisation a step, as JAX's does.

``amp_configs`` ``"O1"`` runs the forward under ``auto_cast(level="O1")``;
``"O2"`` casts the network with ``amp.decorate`` and runs it under
``auto_cast(level="O2")``; the loss is computed outside ``auto_cast``, as
in JAX. The JAX ``Model`` never sets its loss scaler in ``prepare``, so
neither side scales the loss. JAX's ``FLAGS_check_nan_inf`` scan is not
ported.

Telemetry, as in JAX: each train batch counts ``model.train_batches`` and
runs under the step timeline's ``compile`` phase the first time the
recompile sentinel sees its (inputs, labels) signature and ``device``
after (keyed ``Model.train_batch``, or ``Model.grad_batch`` for an
accumulation micro-batch); ``fit`` wraps each batch in a timeline step
with its callbacks under the ``callbacks`` phase.

The ``.pdparams`` file holds the port's state_dict, whose Linear weights
are ``[out, in]``. A checkpoint the JAX ``Model.save`` wrote reaches the
port through :func:`paddle_tpu_torch.convert.from_jax_checkpoint` (which
applies ``from_jax_state_dict``'s and ``from_jax_optimizer_state``'s
transposes to the files), then :meth:`Model.load`.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from ..amp.auto_cast import auto_cast, decorate
from ..core.random import default_generator, rng_scope
from ..io import DataLoader
from ..metric import Metric
from ..observability import step_monitor
from ..profiler.monitor import stat_add
from .callbacks import config_callbacks

__all__ = ["Model"]


def _as_tuple(x):
    if x is None:
        return ()
    if isinstance(x, (tuple, list)):
        return tuple(x)
    return (x,)


def _numpy(out):
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    if isinstance(out, (tuple, list)):
        return type(out)(_numpy(o) for o in out)
    return np.asarray(out)


@contextlib.contextmanager
def _mode(net: nn.Module, training: bool):
    """``net`` in train or eval mode inside, its own mode after."""
    was = net.training
    net.train(training)
    try:
        yield
    finally:
        net.train(was)


class Model:
    def __init__(self, network: nn.Module, inputs=None, labels=None):
        self.network = network
        self.stop_training = False
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self._amp_level = "O0"
        self._amp_custom_lists: Dict[str, Any] = {}
        self._opt_state = None
        self._step_count = 0
        self._accum_grads: Optional[Dict[str, torch.Tensor]] = None
        self._accum_count = 0

    # -- setup ----------------------------------------------------------------

    def prepare(self, optimizer=None, loss=None,
                metrics: Optional[Sequence[Metric]] = None,
                amp_configs: Union[None, str, Dict] = None) -> None:
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = list(metrics or [])
        if isinstance(amp_configs, str):
            self._amp_level = amp_configs
        elif isinstance(amp_configs, dict):
            self._amp_level = amp_configs.get("level", "O1")
            self._amp_custom_lists = {
                k: amp_configs[k] for k in
                ("custom_white_list", "custom_black_list") if k in amp_configs}
        if self._amp_level == "O2":
            decorate(self.network, level="O2")

    # -- the step -------------------------------------------------------------

    @property
    def _device(self) -> torch.device:
        first = next(iter(self.network.parameters()), None)
        return first.device if first is not None else torch.device("cpu")

    def _tensors(self, xs):
        dev = self._device
        return tuple(torch.as_tensor(x, device=dev) for x in _as_tuple(xs))

    def _trainable(self) -> Dict[str, torch.Tensor]:
        return {n: p for n, p in self.network.named_parameters()
                if p.requires_grad}

    def _amp(self):
        if self._amp_level in ("O1", "O2"):
            return auto_cast(enable=True, level=self._amp_level,
                             **self._amp_custom_lists)
        return contextlib.nullcontext()

    def _loss_value(self, outputs, labels):
        losses = self._loss(*_as_tuple(outputs), *_as_tuple(labels))
        total = sum(l.sum() for l in losses) \
            if isinstance(losses, (tuple, list)) else losses
        return total

    def _grads(self, inputs, labels, key):
        """Forward and backward of one batch in train mode under
        ``rng_scope(key)``; ``(trainable params, their grads, loss)``. A
        parameter the loss does not reach gets a zero gradient, as
        ``jax.grad`` gives it."""
        params = self._trainable()
        for p in params.values():
            p.grad = None
        with _mode(self.network, True), rng_scope(key):
            with self._amp():
                out = self.network(*inputs)
            total = self._loss_value(out, labels)
            total.backward()
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                 for n, p in params.items()}
        for p in params.values():
            p.grad = None
        return params, grads, total.detach()

    def _ensure_state(self):
        if self._opt_state is None:
            self._opt_state = self._optimizer.init(self._trainable())

    # -- batch-level API -------------------------------------------------------

    def train_batch(self, inputs, labels=None, update: bool = True):
        """One optimizer step on a batch (with ``update=False``, one
        micro-batch of gradient accumulation); returns the loss as a numpy
        array."""
        if self._optimizer is None or self._loss is None:
            raise RuntimeError("call prepare(optimizer, loss) first")
        stat_add("model.train_batches")
        inputs, labels = self._tensors(inputs), self._tensors(labels)
        self._ensure_state()
        key = default_generator().next_key()
        tm = step_monitor.current()

        def dispatch_phase(kind):
            # recompile sentinel: churn comes from the (inputs, labels)
            # signature; the first dispatch of a signature is "compile"
            if not tm.enabled:
                return "device"
            return tm.observe_dispatch(
                (f"Model.{kind}", id(self)), (inputs, labels),
                where=f"hapi.Model.{kind}")

        if update and self._accum_grads is None:
            with tm.phase(dispatch_phase("train_batch")):
                params, grads, loss = self._grads(inputs, labels, key)
                self._optimizer.apply_gradients(params, grads,
                                                self._opt_state,
                                                self._optimizer.get_lr())
            self._step_count += 1
            return loss.cpu().numpy()
        with tm.phase(dispatch_phase("grad_batch")):
            params, grads, loss = self._grads(inputs, labels, key)
        if self._accum_grads is None:
            self._accum_grads = {n: g.clone() for n, g in grads.items()}
            self._accum_count = 1
        else:
            for n, g in grads.items():
                self._accum_grads[n].add_(g)
            self._accum_count += 1
        if update:
            self._flush_accumulated()
        return loss.cpu().numpy()

    def _flush_accumulated(self) -> None:
        """Apply the pending accumulated gradients, averaged (the end of
        an accumulation window, or a partial one at an epoch's end)."""
        if self._accum_grads is None:
            return
        denom = float(self._accum_count)
        grads = {n: g / denom for n, g in self._accum_grads.items()}
        self._optimizer.apply_gradients(self._trainable(), grads,
                                        self._opt_state,
                                        self._optimizer.get_lr())
        self._accum_grads = None
        self._accum_count = 0
        self._step_count += 1

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        """``(loss as numpy or None, outputs on the device)`` in eval
        mode."""
        inputs, labels = self._tensors(inputs), self._tensors(labels)
        with _mode(self.network, False):
            out = self.network(*inputs)
        if self._loss is None:
            return None, out
        return self._loss_value(out, labels).cpu().numpy(), out

    @torch.no_grad()
    def predict_batch(self, inputs):
        with _mode(self.network, False):
            return self.network(*self._tensors(inputs))

    # -- loops ----------------------------------------------------------------

    def _to_loader(self, data, batch_size, shuffle, num_workers, drop_last):
        if data is None or isinstance(data, DataLoader):
            return data
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                          num_workers=num_workers, drop_last=drop_last)

    @staticmethod
    def _split_batch(batch, n_labels_hint: int = 1):
        batch = _as_tuple(batch)
        if len(batch) == 1:
            return batch, ()
        return batch[:-n_labels_hint], batch[-n_labels_hint:]

    def fit(self, train_data=None, eval_data=None, batch_size: int = 1,
            epochs: int = 1, eval_freq: int = 1, log_freq: int = 10,
            save_dir: Optional[str] = None, save_freq: int = 1,
            verbose: int = 1, drop_last: bool = False, shuffle: bool = True,
            num_workers: int = 0, callbacks=None, accumulate_grad_batches=1,
            num_iters: Optional[int] = None) -> None:
        loader = self._to_loader(train_data, batch_size, shuffle, num_workers,
                                 drop_last)
        eval_loader = self._to_loader(eval_data, batch_size, False,
                                      num_workers, False)
        cbks = config_callbacks(callbacks, model=self, log_freq=log_freq,
                                verbose=verbose, save_freq=save_freq,
                                save_dir=save_dir, metrics=self._metrics)
        self.stop_training = False
        tm = step_monitor.current()
        cbks.on_train_begin()
        iters_done = 0
        logs: Dict[str, Any] = {}
        for epoch in range(epochs):
            if self.stop_training:
                break
            cbks.on_epoch_begin(epoch)
            logs = {}
            for m in self._metrics:
                m.reset()
            for step, batch in enumerate(loader):
                with tm.step():
                    with tm.phase("callbacks"):
                        cbks.on_train_batch_begin(step)
                    inputs, labels = self._split_batch(batch)
                    update = (step + 1) % max(1, accumulate_grad_batches) \
                        == 0
                    logs["loss"] = self.train_batch(inputs, labels,
                                                    update=update)
                    logs["lr"] = self._optimizer.get_lr()
                    with tm.phase("callbacks"):
                        cbks.on_train_batch_end(step, logs)
                iters_done += 1
                if num_iters is not None and iters_done >= num_iters:
                    self.stop_training = True
                    break
            # a partial accumulation window at an epoch's end is applied,
            # not carried into the next epoch or dropped at the end
            self._flush_accumulated()
            cbks.on_epoch_end(epoch, logs)
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self.evaluate(eval_loader, verbose=0,
                                          _callbacks=cbks)
                logs.update({f"eval_{k}": v for k, v in eval_logs.items()})
        cbks.on_train_end(logs)

    def evaluate(self, eval_data, batch_size: int = 1, log_freq: int = 10,
                 verbose: int = 1, num_workers: int = 0, callbacks=None,
                 num_samples: Optional[int] = None,
                 _callbacks=None) -> Dict[str, Any]:
        loader = self._to_loader(eval_data, batch_size, False, num_workers,
                                 False)
        cbks = _callbacks or config_callbacks(callbacks, model=self,
                                              verbose=verbose)
        cbks.on_eval_begin()
        for m in self._metrics:
            m.reset()
        losses = []
        for step, batch in enumerate(loader):
            cbks.on_eval_batch_begin(step)
            inputs, labels = self._split_batch(batch)
            loss, out = self.eval_batch(inputs, labels)
            if loss is not None:
                losses.append(float(loss))
            for m in self._metrics:
                args = m.compute(*_as_tuple(out), *labels)
                m.update(*_as_tuple(args))
            cbks.on_eval_batch_end(step)
        logs: Dict[str, Any] = {}
        if losses:
            logs["loss"] = float(np.mean(losses))
        for m in self._metrics:
            names = m.name() if isinstance(m.name(), list) else [m.name()]
            vals = m.accumulate()
            vals = vals if isinstance(vals, list) else [vals]
            for n, v in zip(names, vals):
                logs[n] = v
        cbks.on_eval_end(logs)
        return logs

    def predict(self, test_data, batch_size: int = 1, num_workers: int = 0,
                stack_outputs: bool = False, verbose: int = 1,
                callbacks=None):
        loader = self._to_loader(test_data, batch_size, False, num_workers,
                                 False)
        outputs = [_numpy(self.predict_batch(_as_tuple(batch)))
                   for batch in loader]
        if stack_outputs:
            return np.concatenate(outputs, axis=0)
        return outputs

    # -- persistence ----------------------------------------------------------

    def parameters(self):
        return self.network.parameters()

    def state_dict(self):
        return self.network.state_dict()

    def save(self, path: str, training: bool = True) -> None:
        """``path.pdparams`` (the network's state_dict) and, with
        ``training``, ``path.pdopt`` (the optimizer state as
        ``"<name>@<key>"``, ``step`` and ``LR_Scheduler``)."""
        from ..framework.io import save as fsave
        fsave(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            opt_state: Dict[str, Any] = {}
            if self._opt_state:
                opt_state["step"] = self._opt_state["step"]
                for pname, st in self._opt_state["param_states"].items():
                    for k, v in st.items():
                        opt_state[f"{pname}@{k}"] = v
            sched = self._optimizer.lr_scheduler
            if sched is not None:
                opt_state["LR_Scheduler"] = sched.state_dict()
            fsave(opt_state, path + ".pdopt")

    def load(self, path: str, skip_mismatch: bool = False,
             reset_optimizer: bool = False):
        """Load :meth:`save`'s files of the port's layout (a JAX-written
        checkpoint goes through ``convert.from_jax_checkpoint`` first).
        The tensors go to the devices of the network's parameters and
        buffers; ``skip_mismatch`` loads non-strictly."""
        from ..framework.io import load as fload
        self.network.load_state_dict(fload(path + ".pdparams", device="cpu"),
                                     strict=not skip_mismatch)
        opt_path = path + ".pdopt"
        if not reset_optimizer and os.path.exists(opt_path) and \
                self._optimizer:
            raw = fload(opt_path, device="cpu")
            sched_state = raw.pop("LR_Scheduler", None)
            if sched_state and self._optimizer.lr_scheduler:
                self._optimizer.lr_scheduler.set_state_dict(sched_state)
            step = raw.pop("step", 0)
            devices = {n: p.device for n, p in
                       self.network.named_parameters()}
            pstates: Dict[str, Dict[str, torch.Tensor]] = {}
            for key, v in raw.items():
                pname, _, k = key.rpartition("@")
                pstates.setdefault(pname, {})[k] = v.to(devices[pname])
            if pstates:
                self._opt_state = {
                    "step": torch.as_tensor(step, dtype=torch.int32,
                                            device=self._device).clone(),
                    "param_states": pstates}

    def summary(self, input_size=None, dtype=None):
        if input_size is not None:
            from .summary import summary as _summary
            return _summary(self.network, input_size, dtypes=dtype)
        # no input shape: the parameter table only
        n, e = 0, 0
        lines = []
        for name, p in self.network.named_parameters():
            n += 1
            e += p.numel()
            lines.append(f"{name:60s} {str(tuple(p.shape)):20s} "
                         f"{str(p.dtype)}")
        print("\n".join(lines) + f"\nTotal params: {e:,} ({n} tensors)")
        return {"total_params": e, "trainable_params": e}
