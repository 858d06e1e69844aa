"""The pipeline train step (``paddle_tpu/distributed/pipeline_schedule.py``
counterpart), at one stage on one device.

:func:`make_pipeline_train_step` builds ``step(params, opt_state, inputs,
labels, lr) -> (params, opt_state, loss)`` for a
:class:`~paddle_tpu_torch.distributed.fleet.meta_parallel.PipelineLayer`, on
the path the JAX function takes for a one-stage mesh (``loss_fallback``
``:668-682``, then ``make_step`` ``:684-697``): one forward of the whole
batch through every layer, the mean of ``pl.loss_fn``, the gradients of
``params``, and the optimizer's ``apply_gradients``. ``params`` is
``dict(pl.named_parameters())`` (the keys of JAX's ``get_params(pl)``);
the optimizer state is ``opt.init(params)``. As the port's optimizers do,
the step updates parameters and state in place and returns the dicts it
was given. ``n_microbatch`` is taken and, as in JAX at one stage, unused:
the loss is a mean, so one pass over the batch gives the same step.

A pipeline degree above 1 (stages on several devices, the 1F1B and
interleaved schedules) is not ported yet and raises.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.func import functional_call

__all__ = ["make_pipeline_train_step"]


def make_pipeline_train_step(pl, opt, hcg=None, n_microbatch: int = 1,
                             schedule: str = "1F1B") -> Callable:
    """``step(params, opt_state, inputs, labels, lr) -> (params,
    opt_state, loss)`` for ``pl`` at one stage. ``hcg`` (a hybrid
    communicate group) may name a pipeline degree; above 1 it raises."""
    degree = 1 if hcg is None else int(hcg.get_pipe_parallel_world_size())
    if degree > 1:
        raise NotImplementedError(
            f"pipeline degree {degree}: stages on several devices and their "
            f"schedules are not ported yet (ROADMAP Queue 1 item 8); run "
            f"one stage")

    def loss_fallback(params: Dict[str, torch.Tensor], inputs, labels):
        out = functional_call(pl, params, (inputs,))
        return torch.mean(pl.loss_fn(out, labels))

    def step(params, opt_state, inputs, labels, lr):
        pl.train()
        names = list(params)
        loss = loss_fallback(params, inputs, labels)
        grads = torch.autograd.grad(loss, [params[n] for n in names],
                                    allow_unused=True)
        # a parameter the loss does not reach gets a zero gradient, as
        # jax.grad gives it (AdamW still decays it)
        grads = {n: torch.zeros_like(params[n]) if g is None else g
                 for n, g in zip(names, grads)}
        opt.apply_gradients(params, grads, opt_state, lr)
        return params, opt_state, loss.detach()

    return step
