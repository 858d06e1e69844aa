"""Fused conv + BatchNorm training units (``paddle_tpu/nn/fused_conv_bn.py``
counterpart).

Each unit takes the PREVIOUS conv's raw (pre-BN) output ``u`` with its
per-channel ``sum``/``sumsq`` (from the producing unit's epilogue), applies
BN (+ReLU) as a prologue, runs the conv and returns its own output's sums.
Each is a ``torch.autograd.Function`` that saves what the JAX ``custom_vjp``
saves, ``u`` and never the normalised activation: the backward recomputes
the prologue, and the BN gradients take the closed form (dx from dy, u, mean
and r), with the stats treated as non-differentiable.

- :func:`conv_stats`: conv + output stats (no prologue);
- :func:`conv_bn_act`: BN+act prologue -> conv -> output stats;
- :func:`bn_act_from_stats`: BN+act from given stats;
- :func:`bn_add_act`: ``relu(bn(u) + residual)``, the block's join.

``FLAGS_fused_conv_bn`` (:mod:`paddle_tpu_torch.core.flags`, off by
default) makes ResNet blocks take these units in training.
``FLAGS_pallas_conv`` (off by default) routes a conv that the kernels take
(:func:`paddle_tpu_torch.ops._hopper.conv.supports`) through K5-K8: the BN
prologue and the stat epilogue then run inside the kernel, and the backward
goes through the dgrad/wgrad pair with the prologue recomputed in the
kernel. Any other conv is a library convolution
(:func:`paddle_tpu_torch.nn.functional.conv2d`, cuDNN on the GPU) inside the
same units, so what a unit computes does not depend on the route. On the
kernel route the stats come from the kernel's f32 accumulator; on the
library route from the rounded output (in float32 the two agree).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core import flags as _flags
from ..ops._hopper import conv as _kconv
from . import functional as F
from .functional import (_bn_closed_form_dx, _running_stats, _scale_shift,
                         stats_to_moments)

__all__ = [
    "conv_stats", "conv_bn_act", "bn_act_from_stats", "bn_add_act",
    "channel_stats", "stats_to_moments", "fused_conv_bn_enabled",
    "update_bn_buffers",
]


def fused_conv_bn_enabled() -> bool:
    """``FLAGS_fused_conv_bn`` (default off, as in the JAX package)."""
    return bool(_flags.flag("fused_conv_bn"))


def channel_stats(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (sum, sumsq) in f32 over all but the last axis, with no
    gradient (the consuming unit's closed-form backward stands for it)."""
    xf = x.detach().float()
    axes = tuple(range(x.dim() - 1))
    return xf.sum(axes), (xf * xf).sum(axes)


@torch.no_grad()
def update_bn_buffers(bn, s, ss, m: int) -> None:
    """The running-stat update from epilogue sums, as ``_BatchNormBase``
    does it (momentum EMA, unbiased variance). The buffers are *replaced*:
    bf16 buffers (after a cast of the model) come back float32 under the
    promotion of ``momentum · bf16 + (1 − momentum) · f32``, as in JAX."""
    mean, var, _ = stats_to_moments(s, ss, m, bn.epsilon)
    bn._mean, bn._variance = _running_stats(bn._mean, bn._variance, mean,
                                            var, m, bn.momentum)


def _apply_bn_act(u, gamma, beta, s, ss, epsilon, act):
    """``act(bn(u))`` as a per-channel FMA in u's dtype, scale and shift
    rounded to it first. Returns ``(a, mean, r)``."""
    m = u.numel() // u.shape[-1]
    mean, _, r = stats_to_moments(s, ss, m, epsilon)
    scale, shift = _scale_shift(gamma, beta, mean, r)
    a = u * scale.to(u.dtype) + shift.to(u.dtype)
    if act == "relu":
        a = torch.clamp_min(a, 0)
    return a, mean, r


# ---------------------------------------------------------------------------
# The conv of a unit: the kernels (FLAGS_pallas_conv and a supported shape)
# or the library convolution, F.conv2d in NHWC (1x1 as a matmul)
# ---------------------------------------------------------------------------

def _kernel_route(x, w, stride, padding, dilation, groups) -> bool:
    return _kconv.pallas_conv_enabled() and _kconv.supports(
        x.shape, w.shape, stride, padding, dilation, groups, x.dtype)


def _kernel_grads(do, a_or_u, w, stride, padding, scale=None, shift=None,
                  act="none", need_da=True, need_dw=True):
    """dgrad (K5/K7) and wgrad (K6/K8). With ``(scale, shift)`` the wgrad
    kernel recomputes the BN(+act) prologue from the raw input."""
    da = dw = None
    if need_da:
        da = _kconv.conv2d_dgrad(do, w, a_or_u.shape, stride,
                                 padding).to(a_or_u.dtype)
    if need_dw:
        dw = _kconv.conv2d_wgrad(a_or_u, do, w.shape, scale, shift, act,
                                 stride, padding).to(w.dtype)
    return da, dw


def _conv_grads(do, a, w, stride, padding, dilation, groups, need_da=True,
                need_dw=True):
    """(da, dw) of the library conv without re-running it: the matmul's
    transposes for the 1x1 form, the library's conv backward otherwise."""
    da = dw = None
    if (w.shape[2] == w.shape[3] == 1 and groups == 1
            and padding == (0, 0) and dilation == (1, 1)):
        k, c = w.shape[0], w.shape[1]
        do2 = do.reshape(-1, k)
        if need_da:
            da = (do2 @ w.reshape(k, c).to(do.dtype)).reshape(
                do.shape[:3] + (c,))
            if stride != (1, 1):
                full = torch.zeros(a.shape, dtype=da.dtype, device=da.device)
                full[:, ::stride[0], ::stride[1]] = da
                da = full
        if need_dw:
            a2 = a[:, ::stride[0], ::stride[1]].reshape(-1, c)
            dw = (do2.T @ a2.to(do.dtype)).reshape(w.shape)
    else:
        a_t, do_t = a.permute(0, 3, 1, 2), do.permute(0, 3, 1, 2)
        wa = w.to(a.dtype)
        if need_da:
            da = torch.nn.grad.conv2d_input(
                a_t.shape, wa, do_t, stride, padding, dilation,
                groups).permute(0, 2, 3, 1)
        if need_dw:
            dw = torch.nn.grad.conv2d_weight(a_t, w.shape, do_t, stride,
                                             padding, dilation, groups)
    return (None if da is None else da.to(a.dtype),
            None if dw is None else dw.to(w.dtype))


# ---------------------------------------------------------------------------
# Unit 1: conv + stats epilogue (no prologue)
# ---------------------------------------------------------------------------

class _ConvStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation, groups):
        route = _kernel_route(x, w, stride, padding, dilation, groups)
        if route:
            o, s, ss = _kconv.conv2d_fwd(x, w, stride=stride,
                                         padding=padding)
        else:
            o = F.conv2d(x, w, None, stride, padding, dilation, groups,
                         "NHWC")
            s, ss = channel_stats(o)
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, dilation, groups, route)
        ctx.mark_non_differentiable(s, ss)
        return o, s, ss

    @staticmethod
    def backward(ctx, do, _ds, _dss):
        x, w = ctx.saved_tensors
        stride, padding, dilation, groups, route = ctx.conf
        need = ctx.needs_input_grad[:2]
        if route:
            dx, dw = _kernel_grads(do, x, w, stride, padding,
                                   need_da=need[0], need_dw=need[1])
        else:
            dx, dw = _conv_grads(do, x, w, stride, padding, dilation, groups,
                                 *need)
        return dx, dw, None, None, None, None


def conv_stats(x, w, stride=(1, 1), padding=(0, 0), dilation=(1, 1),
               groups: int = 1):
    """conv(x, w) plus the per-channel (sum, sumsq) of the output: ``(o [N,
    H', W', Cout], s [Cout] f32, ss [Cout] f32)``; s and ss have no
    gradient."""
    return _ConvStats.apply(x, w, F._pair(stride), F._pair(padding),
                            F._pair(dilation), int(groups))


# ---------------------------------------------------------------------------
# Unit 2: BN+act prologue -> conv -> stats epilogue
# ---------------------------------------------------------------------------

class _ConvBnAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, gamma, beta, s, ss, w, epsilon, act, stride, padding,
                dilation, groups):
        route = _kernel_route(u, w, stride, padding, dilation, groups)
        if route:
            # BN(+act) as the kernel's prologue: (gamma, beta, stats) folded
            # to a per-channel FMA that the kernel applies tile by tile
            m = u.numel() // u.shape[-1]
            mean, _, r = stats_to_moments(s, ss, m, epsilon)
            scale, shift = _scale_shift(gamma, beta, mean, r)
            o, s_o, ss_o = _kconv.conv2d_fwd(u, w, scale, shift, act=act,
                                             stride=stride, padding=padding)
        else:
            a, _, _ = _apply_bn_act(u, gamma, beta, s, ss, epsilon, act)
            o = F.conv2d(a, w, None, stride, padding, dilation, groups,
                         "NHWC")
            s_o, ss_o = channel_stats(o)
        ctx.save_for_backward(u, gamma, beta, s, ss, w)
        ctx.conf = (epsilon, act, stride, padding, dilation, groups, route)
        ctx.mark_non_differentiable(s_o, ss_o)
        return o, s_o, ss_o

    @staticmethod
    def backward(ctx, do, _ds, _dss):
        u, gamma, beta, s, ss, w = ctx.saved_tensors
        epsilon, act, stride, padding, dilation, groups, route = ctx.conf
        # the prologue recomputed from u (the ReLU mask; the library route's
        # conv operand)
        a, mean, r = _apply_bn_act(u, gamma, beta, s, ss, epsilon, act)
        if route:
            scale, shift = _scale_shift(gamma, beta, mean, r)
            da, dw = _kernel_grads(do, u, w, stride, padding, scale, shift,
                                   act)
        else:
            da, dw = _conv_grads(do, a, w, stride, padding, dilation, groups)
        if act == "relu":
            da = da * (a > 0)
        du, dgamma, dbeta = _bn_closed_form_dx(da, u, mean, r, gamma)
        return (du, dgamma, dbeta.to(beta.dtype), None, None, dw, None, None,
                None, None, None, None)


def conv_bn_act(u, gamma, beta, s, ss, w, epsilon: float = 1e-5,
                act: str = "relu", stride=(1, 1), padding=(0, 0),
                dilation=(1, 1), groups: int = 1):
    """conv(act(bn(u)), w) plus output stats, saving only ``u`` for the
    backward. ``u`` is the previous conv's raw output ``[N, H, W, Cin]``,
    ``s``/``ss`` its channel sums (no gradient), ``gamma``/``beta`` the BN
    parameters. Returns ``(o, s_o, ss_o)``."""
    if act not in ("none", "relu"):
        raise ValueError(f"act must be 'none' or 'relu'; got {act!r}")
    return _ConvBnAct.apply(u, gamma, beta, s, ss, w, float(epsilon), act,
                            F._pair(stride), F._pair(padding),
                            F._pair(dilation), int(groups))


# ---------------------------------------------------------------------------
# Unit 3: BN(+act) from given stats
# ---------------------------------------------------------------------------

class _BnActFromStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, gamma, beta, s, ss, epsilon, act):
        a, mean, r = _apply_bn_act(u, gamma, beta, s, ss, epsilon, act)
        ctx.save_for_backward(u, gamma, beta, mean, r)
        ctx.act = act
        return a

    @staticmethod
    def backward(ctx, da):
        u, gamma, beta, mean, r = ctx.saved_tensors
        if ctx.act == "relu":
            scale, shift = _scale_shift(gamma, beta, mean, r)
            b = u * scale.to(u.dtype) + shift.to(u.dtype)
            da = da * (b > 0)
        du, dgamma, dbeta = _bn_closed_form_dx(da, u, mean, r, gamma)
        return du, dgamma, dbeta.to(beta.dtype), None, None, None, None


def bn_act_from_stats(u, gamma, beta, s, ss, epsilon: float = 1e-5,
                      act: str = "relu"):
    """``act(bn(u))`` with the stats given (closed-form backward from u,
    mean and r)."""
    return _BnActFromStats.apply(u, gamma, beta, s, ss, float(epsilon), act)


# ---------------------------------------------------------------------------
# Unit 4: the residual join, relu(bn(u) + residual)
# ---------------------------------------------------------------------------

class _BnAddAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, gamma, beta, s, ss, residual, epsilon):
        a, mean, r = _apply_bn_act(u, gamma, beta, s, ss, epsilon, "none")
        ctx.save_for_backward(u, gamma, beta, mean, r, residual)
        return torch.clamp_min(a + residual, 0)

    @staticmethod
    def backward(ctx, dout):
        u, gamma, beta, mean, r, residual = ctx.saved_tensors
        scale, shift = _scale_shift(gamma, beta, mean, r)
        b = (u * scale.to(u.dtype) + shift.to(u.dtype)) + residual
        d = dout * (b > 0)
        du, dgamma, dbeta = _bn_closed_form_dx(d, u, mean, r, gamma)
        return du, dgamma, dbeta.to(beta.dtype), None, None, d, None


def bn_add_act(u, gamma, beta, s, ss, residual, epsilon: float = 1e-5):
    """``relu(bn(u) + residual)``: the block's exit, one elementwise pass
    over (u, residual), closed-form BN backward."""
    return _BnAddAct.apply(u, gamma, beta, s, ss, residual, float(epsilon))
