"""Functional ops of the port (``paddle_tpu/nn/functional.py`` counterpart).

So far what the GPT, BERT, ERNIE, ResNet and LeNet training paths need:
:func:`cross_entropy` (hard and soft labels, class weights, smoothing),
:func:`scaled_dot_product_attention` with its routing to the attention
kernels (attention-prob dropout in the kernels), :func:`dropout` (both of
Paddle's modes, the mask drawn from the key stream of
:mod:`paddle_tpu_torch.core.random`), and for ResNet
:func:`relu`, :func:`conv2d` (NCHW or NHWC, a library convolution, 1x1 NHWC
as a matmul), :func:`max_pool2d`, :func:`adaptive_avg_pool2d` and
:func:`batch_norm` with the closed-form backward.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as TF

from ..core.random import next_key, torch_generator
from ..ops._hopper.flash_attention import flash_attention_hopper

__all__ = ["adaptive_avg_pool2d", "batch_norm", "conv2d", "cross_entropy",
           "dropout", "max_pool2d", "relu", "scaled_dot_product_attention"]


def cross_entropy(input: torch.Tensor, label: torch.Tensor, weight=None,
                  ignore_index: int = -100, reduction: str = "mean",
                  soft_label: bool = False, axis: int = -1,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Softmax cross-entropy over ``axis``, as
    ``paddle_tpu.nn.functional.cross_entropy`` computes it: log-softmax in
    float32, then ``-sum(target * logp)`` over the classes. ``target`` is
    the float32 ``label`` with ``soft_label``, else the one-hot of the
    integer label, and ``label_smoothing`` mixes it with the uniform
    distribution, ``target * (1 - ls) + ls / C``. Hard labels without
    smoothing pick the label's log-probability by a gather, which is the
    same sum. A hard label equal to ``ignore_index`` gives 0; ``weight``
    (``[C]``, hard labels only) scales each sample's loss by its label's
    weight. ``reduction`` is ``"none"``, ``"sum"`` or ``"mean"``: with hard
    labels the mean divides by the number of labels not ignored (at least
    1), or with ``weight`` by the sum of their weights; with soft labels
    it is the plain mean."""
    if reduction not in ("none", "sum", "mean"):
        raise ValueError(f"reduction must be 'none', 'sum' or 'mean'; got "
                         f"{reduction!r}")
    logp = torch.log_softmax(input.float(), dim=axis).movedim(axis, -1)
    num_classes = logp.shape[-1]
    if soft_label:
        if weight is not None:
            raise ValueError("weight with soft_label not supported")
        target = label.float().movedim(axis, -1)
    else:
        if label.dim() == input.dim() and label.shape[-1] == 1:
            label = label.squeeze(-1)
        label = label.long()
        valid = label != ignore_index
        safe = torch.where(valid, label, 0)
        if label_smoothing > 0.0:
            target = TF.one_hot(safe, num_classes).float()
    if soft_label or label_smoothing > 0.0:
        if label_smoothing > 0.0:
            target = target * (1.0 - label_smoothing) + \
                label_smoothing / num_classes
        loss = -(target * logp).sum(dim=-1)
    else:
        loss = -torch.gather(logp, -1, safe[..., None])[..., 0]
    if weight is not None:
        sample_w = torch.as_tensor(weight, dtype=torch.float32,
                                   device=logp.device)[safe]
        loss = loss * sample_w
    if not soft_label:
        loss = torch.where(valid, loss, 0.0)
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if soft_label:
        return loss.mean()
    if weight is not None:
        denom = torch.clamp(torch.where(valid, sample_w, 0.0).sum(),
                            min=1e-12)
    else:
        denom = torch.clamp(valid.sum(), min=1)
    return loss.sum() / denom


def _keep_mask(key: int, shape, keep: float, device) -> torch.Tensor:
    """A bool mask of ``shape``, True with probability ``keep``, drawn
    through a ``torch.Generator`` on ``device`` seeded from ``key``
    (``jax.random.bernoulli(key, keep, shape)``; the bits differ)."""
    gen = torch_generator(key, device)
    return torch.rand(shape, generator=gen, device=device) < keep


def dropout(x: torch.Tensor, p: float = 0.5, training: bool = True,
            mode: str = "upscale_in_train", key: Optional[int] = None
            ) -> torch.Tensor:
    """``paddle.nn.functional.dropout``, as the JAX function computes it.
    In training a kept element is ``x / (1 - p)`` (``upscale_in_train``)
    or ``x`` (``downscale_in_infer``), a dropped one 0, all of them at
    ``p = 1``; in eval mode ``downscale_in_infer`` gives ``x * (1 - p)``
    and ``upscale_in_train`` ``x``. The mask comes from ``key``, by default
    the next key of the active ``rng_scope`` (the train step's) or of the
    global generator."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"mode must be 'upscale_in_train' or "
                         f"'downscale_in_infer'; got {mode!r}")

    def scalar(v):   # a Python float meets x in x's dtype, as in JAX
        return torch.tensor(v, dtype=x.dtype, device=x.device)

    if not training:
        if mode == "downscale_in_infer" and p > 0.0:
            return x * scalar(1.0 - p)
        return x
    if p == 0.0:
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    if key is None:
        key = next_key()
    keep = 1.0 - p
    mask = _keep_mask(key, x.shape, keep, x.device)
    kept = x / scalar(keep) if mode == "upscale_in_train" else x
    return torch.where(mask, kept, scalar(0.0))


def _as_key_mask(attn_mask: torch.Tensor, b: int, sq: int, sk: int
                 ) -> Optional[torch.Tensor]:
    """``[B, Sk]`` view of a KEY-ONLY mask (broadcast over heads and
    queries): shapes ``[B?,1,1,Sk]``, ``[B?,1,Sk]``, ``[B,Sk]``. None for a
    mask that varies per query or head (the dense path takes it), and for
    ``(b, sk)`` when ``b == sq``, which a per-query ``[Sq, Sk]`` mask would
    also fit."""
    m = attn_mask
    shp = tuple(m.shape)
    if shp == (b, sk) and b == sq:
        return None
    if shp == (b, sk) or shp == (1, sk):
        pass
    elif len(shp) == 3 and shp[1] == 1 and shp[2] == sk and shp[0] in (1, b):
        m = m[:, 0]
    elif len(shp) == 4 and shp[1] == 1 and shp[2] == 1 and shp[3] == sk \
            and shp[0] in (1, b):
        m = m[:, 0, 0]
    else:
        return None
    return m.expand(b, sk)


def _kernel_shapes(query: torch.Tensor, key: torch.Tensor) -> bool:
    """``supported_shapes``: the attention kernels take the input (both
    sequence lengths multiples of 128, head dim 64, 128 or 256). The JAX
    package asks this only on a TPU; the port asks it on every device, so
    the CPU runs the kernels' plain versions on the kernels' route."""
    return query.shape[1] % 128 == 0 and key.shape[1] % 128 == 0 and \
        query.shape[3] in (64, 128, 256)


def _dense_attention(query, key, value, attn_mask, is_causal: bool,
                     scale: float, dropout_p: float = 0.0) -> torch.Tensor:
    """The JAX function's dense path: f32 scores, ``-inf`` where a bool
    mask is False or causal masks, a float mask added, softmax rounded to
    the input dtype before the value product, and :func:`dropout` on the
    probabilities at ``dropout_p``."""
    sq, sk = query.shape[1], key.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", query.float(),
                          key.float()) * scale
    if is_causal:
        keep = torch.tril(torch.ones(sq, sk, dtype=torch.bool,
                                     device=query.device), sk - sq)
        scores = scores.masked_fill(~keep, float("-inf"))
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            scores = scores.masked_fill(~attn_mask, float("-inf"))
        else:
            scores = scores + attn_mask.float()
    probs = torch.softmax(scores, dim=-1).to(query.dtype)
    if dropout_p > 0.0:
        probs = dropout(probs, dropout_p, training=True)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), value.float())
    return out.to(query.dtype)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True,
                                 scale: Optional[float] = None,
                                 segment_ids=None) -> torch.Tensor:
    """Attention in the ``[B, S, H, D]`` layout, routed as the JAX function
    routes it (``nn/functional.py:766-842``): where the attention kernels
    take the shapes and the heads match, a key-only mask rides the kernel
    (a bool mask as segment ids, a float mask as an additive key bias) and
    ``segment_ids`` mean packed attention; a mask that varies per query,
    or shapes the kernels do not take, go to the dense path. A d=64 input
    thus reaches K4, and any other kernel input K1, which raises on masks.
    ``dropout_p`` in training is attention-prob dropout: in the kernel on
    the kernel route (its seed drawn from the next key), :func:`dropout`
    of the probabilities on the dense path."""
    b, sq, h, d = query.shape
    sk = key.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    dropout_p = dropout_p if training else 0.0
    kernel_route = _kernel_shapes(query, key) and key.shape[2] == h
    if segment_ids is not None:
        if attn_mask is not None:
            raise ValueError("segment_ids and attn_mask are exclusive")
        if sq != sk:
            raise ValueError(
                f"segment_ids (packed attention) requires self-attention "
                f"with equal q/k lengths; got sq={sq}, sk={sk}")
        seg = torch.as_tensor(segment_ids, device=query.device).to(
            torch.int32)
        if kernel_route:
            return flash_attention_hopper(query, key, value,
                                          causal=is_causal, scale=scale,
                                          segment_ids=seg, dropout=dropout_p)
        attn_mask = seg[:, None, :, None] == seg[:, None, None, :]
    key_mask = _as_key_mask(attn_mask, b, sq, sk) \
        if attn_mask is not None else None
    if kernel_route and (attn_mask is None or key_mask is not None):
        seg_k = bias = None
        if key_mask is not None and key_mask.dtype == torch.bool:
            seg_k = key_mask.to(torch.int32)     # valid = 1, pad = 0
        elif key_mask is not None:
            bias = key_mask
        return flash_attention_hopper(
            query, key, value, causal=is_causal, scale=scale,
            segment_ids=None if seg_k is None else torch.ones(
                (b, sq), dtype=torch.int32, device=query.device),
            segment_ids_k=seg_k, key_bias=bias, dropout=dropout_p)
    return _dense_attention(query, key, value, attn_mask, is_causal, scale,
                            dropout_p)


# ---------------------------------------------------------------------------
# Convolution, pooling and BatchNorm (the ResNet path)
# ---------------------------------------------------------------------------

def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0)


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (list, tuple)):
        if len(v) != 2:
            raise ValueError(f"expected 2 values, got {v!r}")
        return int(v[0]), int(v[1])
    return int(v), int(v)


def _nchw(x: torch.Tensor, data_format: str) -> torch.Tensor:
    """An NCHW view of ``x`` (NHWC data becomes a channels-last view, no
    copy)."""
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"data_format must be 'NCHW' or 'NHWC'; got "
                         f"{data_format!r}")
    return x if data_format == "NCHW" else x.permute(0, 3, 1, 2)


def _back(y: torch.Tensor, data_format: str) -> torch.Tensor:
    return y if data_format == "NCHW" else y.permute(0, 2, 3, 1)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1,
           groups: int = 1, data_format: str = "NCHW"):
    """2-D convolution, weight ``[out, in/groups, kh, kw]`` (OIHW) in both
    layouts; ``padding`` an int, a pair or ``"SAME"``/``"VALID"``. A library
    convolution (cuDNN on the GPU, channels-last for NHWC), as the JAX
    function is ``lax.conv_general_dilated``; an NHWC 1x1 conv with no
    padding, groups or dilation is a matmul over ``[N·H·W, C]`` (strided
    inputs sliced first), as in JAX. The output is in x's dtype."""
    stride, dilation = _pair(stride), _pair(dilation)
    if isinstance(padding, str):
        pad = padding.lower()
        if pad not in ("same", "valid"):
            raise ValueError(f"padding must be 'SAME' or 'VALID'; got "
                             f"{padding!r}")
    else:
        pad = _pair(padding)
    w = weight.to(x.dtype)
    if (data_format == "NHWC" and weight.shape[2] == weight.shape[3] == 1
            and groups == 1 and pad in ((0, 0), "valid")
            and dilation == (1, 1)):
        if stride != (1, 1):
            x = x[:, ::stride[0], ::stride[1], :]
        n, h, w_, c = x.shape
        out = (x.reshape(n * h * w_, c) @ w.reshape(w.shape[0], c).T
               ).reshape(n, h, w_, w.shape[0])
    else:
        if pad == "same" and stride != (1, 1):
            raise NotImplementedError("padding='SAME' with a stride is not "
                                      "ported yet")
        out = _back(TF.conv2d(_nchw(x, data_format), w, None, stride, pad,
                              dilation, groups), data_format)
    if bias is not None:
        shape = (1, -1, 1, 1) if data_format == "NCHW" else (-1,)
        out = out + bias.to(out.dtype).reshape(shape)
    return out


def max_pool2d(x, kernel_size, stride=None, padding=0,
               return_mask: bool = False, data_format: str = "NCHW"):
    """Max pooling; the padding never wins (``-inf``), as ``reduce_window``
    with a ``-inf`` init. ``return_mask`` is not ported yet and raises."""
    if isinstance(return_mask, str):
        # the JAX function's compat: data_format passed 5th, positionally
        data_format, return_mask = return_mask, False
    if return_mask:
        raise NotImplementedError("max_pool2d(return_mask=True) is not "
                                  "ported yet")
    k = _pair(kernel_size)
    s = _pair(stride if stride is not None else kernel_size)
    return _back(TF.max_pool2d(_nchw(x, data_format), k, s, _pair(padding)),
                 data_format)


def adaptive_avg_pool2d(x, output_size, data_format: str = "NCHW"):
    """Adaptive average pooling with torch/paddle windows (row i averages
    input ``[floor(i·in/out), ceil((i+1)·in/out))``)."""
    return _back(TF.adaptive_avg_pool2d(_nchw(x, data_format),
                                        _pair(output_size)), data_format)


def stats_to_moments(s, ss, m: int, epsilon: float):
    """(sum, sumsq, count) -> (mean, biased var, rsqrt(var + eps)) in f32."""
    mean = s / m
    var = torch.clamp_min(ss / m - mean * mean, 0.0)
    return mean, var, torch.rsqrt(var + epsilon)


def _scale_shift(gamma, beta, mean, r):
    """The folded BN affine: ``bn(x) = x·scale + shift``, in f32."""
    scale = r * gamma.float()
    return scale, beta.float() - mean * scale


def _channel_shape(x, axis: int):
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    return shape


def _bn_closed_form_dx(dy, x, mean, r, gamma, axis: int = -1):
    """The closed-form BN input gradient from the post-BN cotangent ``dy``
    (phi's ``batch_norm_grad``), channels on ``axis``::

        dbeta = sum(dy);  dgamma = sum(dy * xhat)
        dx = gamma * r * (dy - (xhat * dgamma + dbeta) / M)

    Returns ``(dx`` in x's dtype, ``dgamma`` in gamma's, ``dbeta`` f32)."""
    axis %= x.dim()
    ax = tuple(i for i in range(x.dim()) if i != axis)
    shape = _channel_shape(x, axis)
    m = x.numel() // x.shape[axis]
    dyf = dy.float()
    xhat = (x.float() - mean.reshape(shape)) * r.reshape(shape)
    dgamma = (dyf * xhat).sum(ax)
    dbeta = dyf.sum(ax)
    g_r = (gamma.float() * r).reshape(shape)
    dx = (g_r * (dyf - (xhat * dgamma.reshape(shape) + dbeta.reshape(shape))
                 / m)).to(x.dtype)
    return dx, dgamma.to(gamma.dtype), dbeta


def _running_stats(running_mean, running_var, mean, var, m: int,
                   momentum: float):
    """Paddle's running-stat update, ``momentum · running + (1 − momentum)
    · batch`` with the unbiased variance, in the type the promotion of the
    two gives (float32 for bf16 buffers, as in JAX)."""
    unbiased = var * m / max(m - 1, 1)
    return (momentum * running_mean + (1 - momentum) * mean,
            momentum * running_var + (1 - momentum) * unbiased)


class _BatchNormTrain(torch.autograd.Function):
    """Training BatchNorm with the closed-form backward (``_bn_train_core``,
    ``nn/functional.py:332-397`` of the JAX package): single-pass f32
    (sum, sumsq) stats, the apply as a per-channel FMA in x's dtype with
    scale and shift rounded to it, and :func:`_bn_closed_form_dx` reading
    only (dy, x). Returns ``(y, mean, var)``; mean and var (f32, biased)
    feed the running-stat update and have no gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, axis: int, epsilon: float):
        reduce_axes = tuple(i for i in range(x.dim()) if i != axis)
        shape = _channel_shape(x, axis)
        xf = x.float()
        mean, var, r = stats_to_moments(
            xf.sum(reduce_axes), (xf * xf).sum(reduce_axes),
            x.numel() // x.shape[axis], epsilon)
        scale, shift = _scale_shift(weight, bias, mean, r)
        y = x * scale.reshape(shape).to(x.dtype) + \
            shift.reshape(shape).to(x.dtype)
        ctx.save_for_backward(x, mean, r, weight)
        ctx.axis, ctx.bias_dtype = axis, bias.dtype
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, r, weight = ctx.saved_tensors
        dx, dgamma, dbeta = _bn_closed_form_dx(dy, x, mean, r, weight,
                                               ctx.axis)
        return dx, dgamma, dbeta.to(ctx.bias_dtype), None, None


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training: bool = False, momentum: float = 0.9,
               epsilon: float = 1e-5, data_format: str = "NCHW"):
    """Returns ``(out, new_mean, new_var)`` (ref: phi batch_norm kernel).

    In training the stats are the batch's, in f32, and the backward is
    the closed form of :class:`_BatchNormTrain` (the port has no switch for
    the autodiff form; a missing weight or bias counts as 1 or 0 and gets
    no gradient). The running stats move as Paddle's do, ``momentum ·
    running + (1 − momentum) · batch`` with the unbiased variance, in the
    type the promotion of the two gives (float32 for bf16 buffers). In
    eval mode the running stats normalise and are returned unchanged."""
    axis = 1 if data_format == "NCHW" else x.dim() - 1
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    if training:
        c = x.shape[axis]
        w = weight if weight is not None else torch.ones(
            c, dtype=torch.float32, device=x.device)
        b = bias if bias is not None else torch.zeros(
            c, dtype=torch.float32, device=x.device)
        out, mean, var = _BatchNormTrain.apply(x, w, b, axis, epsilon)
        return (out, *_running_stats(running_mean, running_var, mean, var,
                                     x.numel() // c, momentum))
    inv = torch.rsqrt(running_var.float() + epsilon)
    scale = inv if weight is None else inv * weight.float()
    shift = -running_mean.float() * scale
    if bias is not None:
        shift = shift + bias.float()
    out = x * scale.reshape(shape).to(x.dtype) + \
        shift.reshape(shape).to(x.dtype)
    return out, running_mean, running_var
