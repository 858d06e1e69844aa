"""Autograd surface (``paddle_tpu/autograd/__init__.py`` counterpart) on
torch's tape and ``torch.func``.

- :func:`backward`: ``paddle.autograd.backward(tensors, grad_tensors)``,
  or JAX's closure form ``backward(model, loss_fn)`` that fills each
  parameter's ``.grad`` and returns the loss;
- :func:`grad`: tensors through ``torch.autograd.grad`` (a list, one entry
  an input), or a callable's gradient through ``torch.func.grad``;
- :func:`value_and_grad`, :func:`jacobian`, :func:`hessian`, :func:`vjp`,
  :func:`jvp`: JAX's functional forms on ``torch.func``;
- :class:`PyLayer`: a custom forward/backward on ``torch.autograd.
  Function``, with Paddle's context (``save_for_backward``,
  ``saved_tensor()``);
- :func:`no_grad`, :func:`enable_grad`, :func:`set_grad_enabled`,
  :func:`is_grad_enabled`: torch's switches of the tape. They act, as in
  Paddle; in the JAX package, which differentiates only what it is asked
  to, they are no-ops and ``is_grad_enabled`` is always True.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.func

__all__ = [
    "PyLayerContext", "saved_tensors_hooks", "backward", "grad",
    "value_and_grad", "PyLayer", "no_grad", "enable_grad",
    "set_grad_enabled", "jacobian", "hessian", "vjp", "jvp"]

no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled
is_grad_enabled = torch.is_grad_enabled
saved_tensors_hooks = torch.autograd.graph.saved_tensors_hooks


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def backward(model=None, loss_fn: Optional[Callable] = None, *,
             loss_closure: Optional[Callable] = None,
             accumulate: bool = True, tensors=None, grad_tensors=None,
             retain_graph: bool = False):
    """Fill ``.grad``. Two forms:

    - ``backward(tensors, grad_tensors)`` (Paddle's, ``grad_tensors`` by
      position or keyword): the first argument a tensor or a list of them,
      run back through the tape;
    - ``backward(model, loss_fn)`` or ``backward(model,
      loss_closure=fn)`` (JAX's closure form): the loss of ``loss_fn()``
      (or ``fn(model)``) run back into ``model``'s parameters, which
      replace their earlier ``.grad`` unless ``accumulate``; returns the
      loss.
    """
    if tensors is None and (isinstance(model, torch.Tensor) or (
            isinstance(model, (list, tuple)) and model and
            isinstance(model[0], torch.Tensor))):
        tensors, model = model, None
    if tensors is not None:
        if grad_tensors is None and loss_fn is not None:
            grad_tensors = loss_fn     # Paddle's backward(tensors, grads)
        ts = _as_list(tensors)
        gs = _as_list(grad_tensors) if isinstance(grad_tensors,
                                                  (list, tuple)) \
            else [grad_tensors] * len(ts)
        torch.autograd.backward(ts, gs, retain_graph=retain_graph)
        return None
    if not accumulate:
        for p in model.parameters():
            p.grad = None
    loss = loss_closure(model) if loss_closure is not None else loss_fn()
    loss.backward(retain_graph=retain_graph)
    return loss


def grad(outputs_fn, inputs, grad_outputs=None, retain_graph=None,
         create_graph: bool = False, only_inputs: bool = True,
         allow_unused: bool = False, no_grad_vars=None):
    """``paddle.grad``. Two forms:

    - tensors: the gradients of ``outputs`` with respect to ``inputs``, a
      list with one entry an input, without touching any ``.grad``
      (``torch.autograd.grad``);
    - a callable: d sum(outputs_fn(inputs)) / d inputs, ``inputs`` a
      tensor or a pytree of them (``torch.func.grad``).
    """
    if callable(outputs_fn) and not isinstance(outputs_fn, torch.Tensor):
        return torch.func.grad(lambda x: outputs_fn(x).sum())(inputs)
    outs = _as_list(outputs_fn)
    gos = None if grad_outputs is None else _as_list(grad_outputs)
    return list(torch.autograd.grad(
        outs, _as_list(inputs), grad_outputs=gos,
        retain_graph=retain_graph, create_graph=create_graph,
        allow_unused=allow_unused))


def value_and_grad(fn: Callable, argnums=0, has_aux: bool = False):
    """``fn`` -> a function returning ``(value, grad)`` (``((value, aux),
    grad)`` with ``has_aux``), as ``jax.value_and_grad``."""
    inner = torch.func.grad_and_value(fn, argnums=argnums, has_aux=has_aux)

    def wrapped(*args, **kwargs):
        g, v = inner(*args, **kwargs)
        return v, g

    return wrapped


def jacobian(fn: Callable, xs, mode: str = "reverse"):
    return (torch.func.jacrev if mode == "reverse" else
            torch.func.jacfwd)(fn)(xs)


def hessian(fn: Callable, xs):
    return torch.func.hessian(fn)(xs)


def vjp(fn: Callable, xs, v=None):
    out, pullback = torch.func.vjp(fn, xs)
    if v is None:
        v = torch.ones_like(out)
    return out, pullback(v)[0]


def jvp(fn: Callable, xs, v=None):
    if v is None:
        v = torch.utils._pytree.tree_map(torch.ones_like, xs)
    return torch.func.jvp(fn, (xs,), (v,))


class PyLayerContext:
    """The context handed to :class:`PyLayer`'s ``forward`` and
    ``backward``: ``save_for_backward`` / ``saved_tensor()``, over torch's
    own context when the layer runs."""

    def __init__(self, ctx=None):
        self._ctx = ctx
        self._saved = ()
        self.materialize_grads = True

    def save_for_backward(self, *tensors):
        if self._ctx is not None:
            self._ctx.save_for_backward(*tensors)
        else:
            self._saved = tuple(tensors)

    def saved_tensor(self):
        return self._ctx.saved_tensors if self._ctx is not None \
            else self._saved

    def mark_not_inplace(self, *args):
        pass

    def mark_non_differentiable(self, *args):
        if self._ctx is not None:
            self._ctx.mark_non_differentiable(*args)

    def set_materialize_grads(self, value: bool):
        self.materialize_grads = bool(value)
        if self._ctx is not None:
            self._ctx.set_materialize_grads(bool(value))


class PyLayer:
    """A custom op with a user forward and backward (Paddle's
    ``PyLayer``)::

        class Scale(PyLayer):
            @staticmethod
            def forward(ctx, x):
                ctx.save_for_backward(x)
                return x * 2

            @staticmethod
            def backward(ctx, dy):
                (x,) = ctx.saved_tensor()
                return dy * 2

        y = Scale.apply(x)

    ``backward`` returns one gradient per tensor input, in order (None for
    none); inputs that are not tensors get none.
    """

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        if "forward" not in cls.__dict__:
            return
        user = cls

        class _Function(torch.autograd.Function):
            @staticmethod
            def forward(tctx, *args):
                ctx = PyLayerContext(tctx)
                tctx.paddle_ctx = ctx
                tctx.is_tensor = [isinstance(a, torch.Tensor) for a in args]
                return user.forward(ctx, *args)

            @staticmethod
            def backward(tctx, *grads):
                got = user.backward(tctx.paddle_ctx, *grads)
                got = list(got) if isinstance(got, (list, tuple)) else [got]
                out = []
                for is_t in tctx.is_tensor:
                    out.append(got.pop(0) if is_t and got else None)
                return tuple(out)

        _Function.__name__ = cls.__name__
        cls._function = _Function

    @classmethod
    def apply(cls, *args):
        return cls._function.apply(*args)
