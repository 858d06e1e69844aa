"""``Layer``, ``Parameter``, ``ParamRef``, ``ParamAttr`` and the parameter
factory of the port (``paddle_tpu/nn/layer.py`` counterpart).

:class:`Layer` is a ``torch.nn.Module`` that also speaks Paddle's ``Layer``
API under the JAX package's names and meanings (``nn/layer.py:193-501``):
``create_parameter``, ``add_parameter``, ``add_sublayer``,
``register_buffer(persistable=)``, ``named_sublayers``/``sublayers`` in
JAX's pre-order, ``parameters()`` as a list, ``named_param_specs``,
``state_dict(include_non_persistable_buffer=)``, ``set_state_dict``/
``load_dict`` returning ``(missing, unexpected)``, ``astype``,
``clear_gradients``, the forward pre- and post-hooks and ``full_name``.
Torch's own calls keep working: torch recurses through children with
``state_dict(destination=, prefix=, keep_vars=)``, ``named_parameters(
prefix=, recurse=, remove_duplicate=)`` and ``train(mode)``, and the
overrides take both sets of keywords. ``to`` keeps torch's meaning (the
JAX ``Layer`` aliases it to ``astype``; every slice of the port calls
``.to(device)``); torch's ``.to(dtype)`` casts the floating parameters and
buffers, which is what ``astype`` does with Paddle's dtype names.

:class:`Parameter` is a ``torch.nn.Parameter`` with Paddle's
``stop_gradient`` (the inverse of ``requires_grad``), ``trainable`` and
``clear_grad``; :func:`create_parameter` makes them. :class:`ParamRef` is
JAX's handle ``(layer, attr_name, name)`` over one of them.

:func:`create_parameter` reads a ``weight_attr``/``bias_attr`` (a
:class:`ParamAttr`, an initializer, a name, or None) and draws the value
with the initializer JAX's precedence picks. ``trainable=False`` gives
``requires_grad=False``, so ``TrainStep`` and the imperative optimizers
leave the parameter out. ``learning_rate``, ``regularizer``, ``need_clip``
and ``partition_spec`` are kept on the attribute (``param.param_attr``) and
not acted on, as the JAX optimizers read none of them.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core import dtype as dtypes
from ..core.device import resolve_device
from . import initializer as I

__all__ = ["Layer", "Parameter", "ParamRef", "ParamAttr", "HookRemoveHelper",
           "create_parameter"]


class ParamAttr:
    """Parity with ``paddle.ParamAttr``: per-parameter config."""

    def __init__(self, name: Optional[str] = None, initializer=None,
                 learning_rate: float = 1.0, trainable: bool = True,
                 regularizer=None, need_clip: bool = True,
                 partition_spec=None):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.trainable = trainable
        self.regularizer = regularizer
        self.need_clip = need_clip
        self.partition_spec = partition_spec

    @staticmethod
    def _to_attr(attr) -> "ParamAttr":
        if attr is None or attr is True:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, I.Initializer):
            return ParamAttr(initializer=attr)
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        raise TypeError(f"Cannot interpret {attr!r} as ParamAttr")


def _as_tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value
    return torch.as_tensor(np.asarray(value))


class Parameter(nn.Parameter):
    """A ``torch.nn.Parameter`` with Paddle's flags: ``Parameter(value,
    trainable=True, attr=None)``; ``stop_gradient`` is ``not
    requires_grad`` and ``trainable`` is ``requires_grad``, both settable;
    ``clear_grad()`` drops the gradient; ``param_attr`` holds the
    :class:`ParamAttr` it was made from."""

    def __new__(cls, value=None, trainable: bool = True,
                attr: Optional[ParamAttr] = None):
        value = torch.empty(0) if value is None else _as_tensor(value)
        param = super().__new__(cls, value.detach(),
                                requires_grad=bool(trainable))
        param.param_attr = attr if attr is not None else \
            ParamAttr(trainable=bool(trainable))
        return param

    def __deepcopy__(self, memo):
        if id(self) not in memo:
            new = type(self)(
                self.data.clone(memory_format=torch.preserve_format),
                self.requires_grad)
            new.__dict__.update(self.__dict__)
            memo[id(self)] = new
        return memo[id(self)]

    @property
    def stop_gradient(self) -> bool:
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value: bool) -> None:
        self.trainable = not value

    @property
    def trainable(self) -> bool:
        return self.requires_grad

    @trainable.setter
    def trainable(self, value: bool) -> None:
        self.requires_grad_(bool(value))
        attr = getattr(self, "param_attr", None)
        if attr is not None:
            attr.trainable = bool(value)

    def clear_grad(self) -> None:
        self.grad = None



class _ParamHookRemoveHelper:
    """``remove()`` of a gradient hook: True the first time, then False,
    as JAX's helper answers."""

    def __init__(self, handle):
        self._handle = handle
        self._live = True

    def remove(self) -> bool:
        if not self._live:
            return False
        self._handle.remove()
        self._live = False
        return True


class ParamRef:
    """Stable handle to one parameter of a Layer: ``value`` (the
    ``torch.nn.Parameter``; setting it copies into it), ``grad``,
    ``trainable``/``stop_gradient``, ``shape``, ``dtype``,
    ``clear_grad()`` and ``register_hook(hook)`` (``hook(grad) ->
    new_grad | None``, fired by ``backward()``)."""

    __slots__ = ("layer", "attr_name", "name")

    def __init__(self, layer: nn.Module, attr_name: str, name: str):
        self.layer = layer
        self.attr_name = attr_name
        self.name = name

    @property
    def value(self) -> nn.Parameter:
        return self.layer._parameters[self.attr_name]

    @value.setter
    def value(self, v) -> None:
        p = self.value
        with torch.no_grad():
            p.copy_(_as_tensor(v).to(device=p.device, dtype=p.dtype))

    @property
    def grad(self):
        return self.value.grad

    @grad.setter
    def grad(self, g) -> None:
        self.value.grad = g

    @property
    def trainable(self) -> bool:
        return self.value.requires_grad

    @trainable.setter
    def trainable(self, t: bool) -> None:
        self.value.requires_grad_(bool(t))

    @property
    def stop_gradient(self) -> bool:
        return not self.trainable

    @property
    def shape(self):
        return tuple(self.value.shape)

    @property
    def dtype(self):
        return self.value.dtype

    def clear_grad(self) -> None:
        self.value.grad = None

    def register_hook(self, hook):
        return _ParamHookRemoveHelper(self.value.register_hook(hook))

    def __repr__(self):
        return (f"ParamRef(name={self.name!r}, shape={self.shape}, "
                f"dtype={self.dtype}, trainable={self.trainable})")


class HookRemoveHelper:
    """The handle of a forward hook: ``remove()`` takes it off; ``id``
    numbers it."""

    def __init__(self, handle):
        self._handle = handle
        self.id = handle.id

    def remove(self) -> None:
        self._handle.remove()


def create_parameter(shape, attr=None, dtype=None, is_bias: bool = False,
                     default_initializer: Optional[I.Initializer] = None,
                     device=None) -> Parameter:
    """A parameter of ``shape`` (Paddle's layout) on ``device`` (resolved
    as the entry points resolve it: None is ``cuda:0``, and raises
    without CUDA). The initializer is, in order: the attribute's, the
    global one (:func:`~.initializer.set_global_initializer`), the
    layer's ``default_initializer``, then ``Constant(0)`` for a bias and
    ``XavierNormal`` otherwise."""
    attr = ParamAttr._to_attr(attr)
    init = attr.initializer \
        or I.get_global_initializer("bias" if is_bias else "weight") \
        or default_initializer
    if init is None:
        init = I.Constant(0.0) if is_bias else I.XavierNormal()
    value = init(shape, dtype=dtype, device=resolve_device(device))
    return Parameter(value, trainable=bool(attr.trainable), attr=attr)


class Layer(nn.Module):
    """The base of every layer and model of the port: a ``torch.nn.Module``
    with the JAX ``Layer``'s API (see the module docstring). ``dtype`` is
    the dtype :meth:`create_parameter` gives by default (``FLAGS_
    default_dtype`` when None); ``name_scope`` is :meth:`full_name` (the
    class name lowercased when None)."""

    def __init__(self, name_scope: Optional[str] = None, dtype=None):
        # nn.Module's __init__ by name: a layer that also derives from a
        # torch layer (Linear, LayerNorm, Sequential, ...) runs it once
        nn.Module.__init__(self)
        self._dtype = dtypes.to_dtype(dtype) if dtype is not None \
            else dtypes.get_default_dtype()
        self._name_scope = name_scope or type(self).__name__.lower()

    # -- construction helpers ----------------------------------------------

    def create_parameter(self, shape, attr=None, dtype=None,
                         is_bias: bool = False,
                         default_initializer: Optional[I.Initializer] = None,
                         device=None) -> Parameter:
        """:func:`create_parameter` in the layer's dtype unless ``dtype``
        is given; assign it to an attribute to register it."""
        return create_parameter(shape, attr, dtype or self._dtype, is_bias,
                                default_initializer, device)

    def add_parameter(self, name: str, parameter):
        if parameter is None:
            self._parameters.pop(name, None)
            return None
        if not isinstance(parameter, nn.Parameter):
            parameter = Parameter(parameter)
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name: str, sublayer: nn.Module) -> nn.Module:
        self.add_module(name, sublayer)
        return sublayer

    def register_buffer(self, name: str, tensor, persistable: bool = True,
                        persistent: Optional[bool] = None) -> None:
        """Paddle's ``persistable`` or torch's ``persistent``; a
        non-tensor value becomes a tensor."""
        if tensor is not None:
            tensor = _as_tensor(tensor)
        super().register_buffer(
            name, tensor, persistable if persistent is None else persistent)

    # -- traversal ----------------------------------------------------------

    def named_sublayers(self, prefix: str = "", include_self: bool = False
                        ) -> Iterator[Tuple[str, nn.Module]]:
        """Every sublayer once, parents before children, in the order they
        were added (JAX's order)."""
        for name, layer in self.named_modules(prefix=prefix):
            if include_self or layer is not self:
                yield name, layer

    def sublayers(self, include_self: bool = False) -> List[nn.Module]:
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def named_parameters(self, prefix: str = "", recurse: bool = True,
                         remove_duplicate: bool = True,
                         include_sublayers: Optional[bool] = None):
        if include_sublayers is not None:
            recurse = include_sublayers
        return super().named_parameters(prefix=prefix, recurse=recurse,
                                        remove_duplicate=remove_duplicate)

    def parameters(self, include_sublayers: bool = True,
                   recurse: Optional[bool] = None) -> List[nn.Parameter]:
        """The parameters as a list (JAX's return), not a generator."""
        rec = include_sublayers if recurse is None else recurse
        return [p for _, p in self.named_parameters(recurse=rec)]

    def named_buffers(self, prefix: str = "", recurse: bool = True,
                      remove_duplicate: bool = True,
                      include_non_persistable: bool = True):
        out = super().named_buffers(prefix=prefix, recurse=recurse,
                                    remove_duplicate=remove_duplicate)
        if include_non_persistable:
            return out
        skip = {f"{p}.{b}" if p else b
                for p, m in self.named_modules(prefix=prefix)
                for b in m._non_persistent_buffers_set}
        return ((n, b) for n, b in out if n not in skip)

    def buffers(self, recurse: bool = True) -> List[torch.Tensor]:
        return [b for _, b in self.named_buffers(recurse=recurse)]

    def named_param_specs(self) -> Dict[str, Any]:
        """``{dot-path: partition spec or None}`` for every parameter: the
        spec its :class:`ParamAttr` carries (the port shards nothing)."""
        return {name: getattr(getattr(p, "param_attr", None),
                              "partition_spec", None)
                for name, p in self.named_parameters()}

    # -- state dict ----------------------------------------------------------

    def state_dict(self, *args, destination=None, prefix: str = "",
                   keep_vars: bool = False,
                   include_non_persistable_buffer: bool = False):
        """Torch's ``state_dict`` (the same keys), plus the non-persistable
        buffers with ``include_non_persistable_buffer`` (which may also be
        the one positional argument)."""
        if len(args) == 1 and isinstance(args[0], bool):
            include_non_persistable_buffer, args = args[0], ()
        out = super().state_dict(*args, destination=destination,
                                 prefix=prefix, keep_vars=keep_vars)
        if include_non_persistable_buffer:
            for name, buf in self.named_buffers(prefix=prefix.rstrip(".")):
                if name not in out:
                    out[name] = buf if keep_vars else buf.detach()
        return out

    def set_state_dict(self, state_dict, use_structured_name: bool = True):
        """Load ``state_dict`` (tensors or arrays) by name, as JAX's does:
        each parameter's value cast to its dtype, a shape mismatch a
        ``ValueError``, a buffer taking the value as given. Returns
        ``(missing, unexpected)``: the parameters the dict lacks and the
        keys that name nothing here."""
        own_params = dict(self.named_parameters())
        own_buffers = {}
        for lpref, layer in self.named_sublayers(include_self=True):
            for bname in layer._buffers:
                own_buffers[f"{lpref}.{bname}" if lpref else bname] = \
                    (layer, bname)
        missing = [k for k in own_params if k not in state_dict]
        unexpected = []
        for key, value in state_dict.items():
            if key in own_params:
                p = own_params[key]
                v = _as_tensor(value)
                if tuple(v.shape) != tuple(p.shape):
                    raise ValueError(
                        f"Shape mismatch for {key}: checkpoint "
                        f"{tuple(v.shape)} vs model {tuple(p.shape)}")
                with torch.no_grad():
                    p.copy_(v.to(device=p.device, dtype=p.dtype))
            elif key in own_buffers:
                layer, bname = own_buffers[key]
                old = layer._buffers[bname]
                v = _as_tensor(value)
                layer._buffers[bname] = v.detach().clone().to(
                    old.device if old is not None else v.device)
            else:
                unexpected.append(key)
        return missing, unexpected

    load_dict = set_state_dict

    # -- modes / transforms ---------------------------------------------------

    def astype(self, dtype) -> "Layer":
        """Cast every floating-point parameter and buffer to ``dtype`` (a
        Paddle name or a torch dtype), as JAX's ``astype`` does; torch's
        ``.to(dtype)`` underneath."""
        dtype = dtypes.to_dtype(dtype)
        self.to(dtype)
        for layer in self.sublayers(include_self=True):
            if isinstance(layer, Layer):
                layer._dtype = dtype
        return self

    def clear_gradients(self) -> None:
        """Drop every parameter's gradient (``grad`` becomes None), as JAX
        clears its ``_grads``."""
        for p in self.parameters():
            p.grad = None

    # -- hooks ----------------------------------------------------------------

    def register_forward_pre_hook(self, hook, *, prepend: bool = False,
                                  with_kwargs: bool = False
                                  ) -> HookRemoveHelper:
        """``hook(layer, args)`` before the forward; a non-None result
        replaces the arguments (a non-tuple is the one argument)."""
        return HookRemoveHelper(super().register_forward_pre_hook(
            hook, prepend=prepend, with_kwargs=with_kwargs))

    def register_forward_post_hook(self, hook) -> HookRemoveHelper:
        """``hook(layer, args, out)`` after the forward; a non-None result
        replaces the output."""
        return HookRemoveHelper(self.register_forward_hook(hook))

    def full_name(self) -> str:
        return self._name_scope
