"""``paddle.nn.utils`` of the port (``paddle_tpu/nn/utils.py`` counterpart):
weight and spectral norm, parameter/vector flattening, gradient clipping.

Weight and spectral norm reparameterise a layer's weight as JAX's do: the
weight's parameter is replaced by ``weight_g``/``weight_v`` (or
``weight_orig`` and a ``_spectral_norm`` sublayer holding the power
iteration's vectors), and a forward pre-hook recomputes ``weight`` before
each forward. ``dim`` means the axis JAX means: JAX keeps a Linear weight
as ``[in, out]`` and the port as ``[out, in]``, so on the port's
:class:`~.layers.Linear` the axis is mirrored, and ``weight_g``,
``weight_v`` and ``weight_orig`` are kept in the port's layout (the
transpose of JAX's, which :mod:`paddle_tpu_torch.convert` carries across
with ``module=``).

:func:`parameters_to_vector` gives JAX's vector: a parameter in the port's
transposed Linear layout (marked ``paddle_transposed``) is flattened as
its ``[in, out]`` transpose, and :func:`vector_to_parameters` reads it
back the same way. The clipping helpers have JAX's functional form: they
take gradients and return the clipped list (and the total norm).
"""

from __future__ import annotations

import torch

from .layer import Layer, Parameter

__all__ = ["weight_norm", "remove_weight_norm", "spectral_norm",
           "parameters_to_vector", "vector_to_parameters",
           "clip_grad_norm_", "clip_grad_value_"]


def _norm_except(v, dim: int):
    axes = tuple(i for i in range(v.dim()) if i != dim)
    return torch.sqrt(torch.sum(v * v, dim=axes, keepdim=True))


def _port_dim(layer, dim: int) -> int:
    """JAX's axis ``dim`` of the weight, in the port's layout."""
    from .layers import Linear
    return 1 - dim if isinstance(layer, Linear) else dim


def _transposed_param(value, layer) -> Parameter:
    from .layers import Linear
    p = Parameter(value)
    if isinstance(layer, Linear) and p.dim() == 2:
        p.paddle_transposed = True
    return p


def _wn_weight(g, v, dim):
    return g * v / torch.clamp_min(_norm_except(v, dim), 1e-12)


def weight_norm(layer: Layer, name: str = "weight", dim: int = 0) -> Layer:
    """``w = g · v / ||v||`` with ``g = ||w||`` over every axis but ``dim``
    (JAX's axis): registers ``<name>_g`` and ``<name>_v`` in place of the
    weight, and recomputes ``<name>`` before each forward."""
    w = getattr(layer, name).detach()
    pdim = _port_dim(layer, 0 if dim is None else dim)
    del layer._parameters[name]
    layer.register_parameter(name + "_g",
                             _transposed_param(_norm_except(w, pdim), layer))
    layer.register_parameter(name + "_v", _transposed_param(w, layer))
    layer._weight_norm_cfg = (name, pdim)

    def recompute(mod, args):
        setattr(mod, name, _wn_weight(getattr(mod, name + "_g"),
                                      getattr(mod, name + "_v"), pdim))

    layer._weight_norm_hook = layer.register_forward_pre_hook(recompute)
    recompute(layer, ())
    return layer


def remove_weight_norm(layer: Layer, name: str = "weight") -> Layer:
    """Fold ``g · v / ||v||`` back into one parameter."""
    if name + "_v" not in layer._parameters:
        raise ValueError(f"layer has no weight norm on {name!r}")
    _, pdim = layer._weight_norm_cfg
    with torch.no_grad():
        w = _wn_weight(layer._parameters[name + "_g"],
                       layer._parameters[name + "_v"], pdim)
    layer._weight_norm_hook.remove()
    del layer._parameters[name + "_g"], layer._parameters[name + "_v"]
    layer.__dict__.pop(name, None)
    layer.register_parameter(name, _transposed_param(w, layer))
    return layer


def spectral_norm(layer: Layer, name: str = "weight",
                  n_power_iterations: int = 1, eps: float = 1e-12,
                  dim: int = 0) -> Layer:
    """The weight divided by its largest singular value, estimated by
    :class:`~.layers.SpectralNorm` (a sublayer ``_spectral_norm``) before
    each forward from ``<name>_orig``."""
    from .layers import SpectralNorm
    w = getattr(layer, name).detach()
    sn = SpectralNorm(tuple(w.shape), dim=_port_dim(layer, dim),
                      power_iters=n_power_iterations, epsilon=eps,
                      device=w.device)
    layer.add_module("_spectral_norm", sn)
    del layer._parameters[name]
    layer.register_parameter(name + "_orig", _transposed_param(w, layer))

    def recompute(mod, args):
        setattr(mod, name, mod._spectral_norm(getattr(mod, name + "_orig")))

    layer._spectral_norm_hook = layer.register_forward_pre_hook(recompute)
    setattr(layer, name, w)
    return layer


def _jax_view(p):
    return p.T if getattr(p, "paddle_transposed", False) else p


def parameters_to_vector(parameters, name=None):
    """Every parameter flattened into one vector, in order (a Linear weight
    in JAX's ``[in, out]`` order)."""
    return torch.cat([_jax_view(p).reshape(-1) for p in parameters])


def vector_to_parameters(vec, parameters, name=None):
    """The inverse of :func:`parameters_to_vector`: new tensors shaped and
    typed like ``parameters`` (the caller rebinds them, as in JAX)."""
    out, off = [], 0
    for p in parameters:
        view = _jax_view(p)
        n = view.numel()
        t = vec[off:off + n].reshape(view.shape).to(p.dtype)
        out.append(t.T if view is not p else t)
        off += n
    return out


def clip_grad_norm_(parameters, max_norm: float, norm_type: float = 2.0,
                    error_if_nonfinite: bool = False):
    """``(clipped gradients, total norm)``: each gradient times
    ``min(1, max_norm / total)`` (JAX's functional form; the gradients are
    the ``parameters`` here)."""
    gs = list(parameters)
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max() for g in gs]).max()
    else:
        total = torch.stack([torch.sum(torch.abs(g) ** norm_type)
                             for g in gs]).sum() ** (1.0 / norm_type)
    if error_if_nonfinite and not bool(torch.isfinite(total)):
        raise RuntimeError("non-finite gradient norm")
    scale = torch.clamp_max(max_norm / torch.clamp_min(total, 1e-12), 1.0)
    return [g * scale for g in gs], total


def clip_grad_value_(parameters, clip_value: float):
    """Each gradient clamped to ``±clip_value``."""
    return [torch.clamp(g, -clip_value, clip_value) for g in parameters]
