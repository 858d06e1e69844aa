"""Functional ops of the port (``paddle_tpu/nn/functional.py`` counterpart):
every public name of the JAX module, computed as the JAX functions compute
them.

The model paths' core: :func:`linear` (Paddle's ``[in, out]`` weight),
:func:`embedding`, :func:`layer_norm`, :func:`cross_entropy` (hard and soft
labels, class weights, smoothing),
:func:`scaled_dot_product_attention` with its routing to the attention
kernels (attention-prob dropout in the kernels), :func:`dropout` (both of
Paddle's modes, the mask drawn from the key stream of
:mod:`paddle_tpu_torch.core.random`), and for ResNet
:func:`relu`, :func:`conv2d` (NCHW or NHWC, a library convolution, 1x1 NHWC
as a matmul, ``padding="SAME"`` at any stride), :func:`max_pool2d` (with
the argmax mask, :func:`max_pool2d_with_index`), :func:`avg_pool2d`,
:func:`adaptive_avg_pool2d`, :func:`pad` (JAX's four modes) and
:func:`batch_norm` with the closed-form backward.

Then the rest of the JAX module: the activations (JAX's formulas, not
torch's defaults where they differ: ``hardsigmoid``'s slope 1/6,
``softplus``'s threshold on beta·x), the losses (``smooth_l1_loss``'s
``0.5·d²/delta``, ``kl_div``'s clipped log, ``ctc_loss`` taking logits and
applying ``log_softmax`` first), the other norms, the 1-D and 3-D and
transposed convolutions (library convolutions, as JAX's are
``lax.conv_general_dilated``), the 1-D and 3-D pools, the geometry ops
(:func:`interpolate` is ``jax.image.resize``: half-pixel ``nearest``,
antialiased ``linear`` and Keys ``cubic`` when downsampling, which torch
computes as ``nearest-exact`` and ``antialias=True``), the extension ops,
the two flash-attention re-exports, :mod:`.functional_wave4`'s names and
the in-place aliases (which return the result, as JAX's do). Random draws
(``rrelu`` in training, ``gumbel_softmax``, ``class_center_sample`` without
a seed) come from the port's key stream through a ``torch.Generator``: the
bits differ from JAX's.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as TF

from ..core.dtype import get_default_dtype, to_dtype
from ..core.random import next_key, torch_generator
from ..ops._hopper.flash_attention import flash_attention_hopper
from ..ops.flash_attention import use_kernels

__all__ = [
    "relu", "relu6", "gelu", "silu", "swish", "sigmoid", "tanh", "softmax",
    "log_softmax", "leaky_relu", "elu", "selu", "hardswish", "hardsigmoid",
    "mish", "softplus", "glu", "dropout", "linear", "embedding",
    "conv2d", "max_pool2d", "avg_pool2d", "adaptive_avg_pool2d",
    "batch_norm", "layer_norm", "rms_norm", "group_norm",
    "cross_entropy", "binary_cross_entropy_with_logits", "mse_loss",
    "l1_loss", "nll_loss", "smooth_l1_loss", "softmax_with_cross_entropy",
    "one_hot", "pad", "interpolate", "scaled_dot_product_attention",
    "label_smooth", "cosine_similarity", "normalize", "kl_div",
    "celu", "hardshrink", "hardtanh", "softshrink", "softsign", "tanhshrink",
    "thresholded_relu", "log_sigmoid", "maxout", "prelu", "rrelu",
    "gumbel_softmax",
    "binary_cross_entropy", "log_loss", "margin_ranking_loss",
    "soft_margin_loss", "triplet_margin_loss", "cosine_embedding_loss",
    "hinge_embedding_loss", "poisson_nll_loss",
    "multi_label_soft_margin_loss", "square_error_cost", "ctc_loss",
    "conv3d", "conv2d_transpose", "conv3d_transpose", "max_pool3d",
    "avg_pool3d", "max_pool2d_with_index", "max_unpool2d",
    "instance_norm", "local_response_norm",
    "grid_sample", "affine_grid", "pixel_shuffle", "channel_shuffle",
    "unfold", "fold",
    "conv1d", "conv1d_transpose", "max_pool1d", "avg_pool1d",
    "adaptive_avg_pool1d",
    "sequence_mask", "temporal_shift", "pixel_unshuffle", "upsample",
    "dice_loss", "npair_loss", "margin_cross_entropy", "class_center_sample",
]


def linear(x: torch.Tensor, weight: torch.Tensor, bias=None
           ) -> torch.Tensor:
    """``x @ weight + bias`` with the weight in Paddle's layout, ``[in,
    out]``, as the JAX function takes it. (The port's :class:`~.layers.
    Linear` keeps its weight as ``[out, in]`` and calls torch's
    ``linear``.)"""
    out = torch.matmul(x, weight)
    if bias is not None:
        out = out + bias
    return out


def embedding(ids: torch.Tensor, weight: torch.Tensor,
              padding_idx: Optional[int] = None, sparse: bool = False
              ) -> torch.Tensor:
    """The rows of ``weight`` at ``ids``; with ``padding_idx``, the rows
    looked up at that id are zeros (and pass no gradient), as the JAX
    function masks them. ``sparse`` is taken and unused, as in JAX."""
    out = TF.embedding(ids.long(), weight)
    if padding_idx is not None:
        out = torch.where((ids == padding_idx)[..., None], 0.0, out)
    return out


def layer_norm(x: torch.Tensor, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last ``len(normalized_shape)`` axes, as JAX
    computes it: statistics and the affine in float32, the result in x's
    dtype. Torch's ``layer_norm`` (``native_layer_norm``, whose outputs the
    recompute policy keeps) runs it: in x's dtype when the weight and bias
    share it (the kernel sums in float32), else on float32 copies."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    shape = tuple(normalized_shape)
    if all(t is None or t.dtype == x.dtype for t in (weight, bias)):
        return TF.layer_norm(x, shape, weight, bias, epsilon)
    return TF.layer_norm(
        x.float(), shape, None if weight is None else weight.float(),
        None if bias is None else bias.float(), epsilon).to(x.dtype)


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
    shapes the kernels do not take, or ``FLAGS_use_pallas_kernels`` off, go
    to the dense path (counted in
    ``scaled_dot_product_attention.dense_routes``). A d=64 input thus
    reaches K4, and any other kernel input K1, each with the key mask or
    the segment ids in the kernel. ``dropout_p`` in training is attention-prob dropout: in the kernel on
    the kernel route (its seed drawn from the next key), :func:`dropout`
    of the probabilities on the dense path."""
    b, sq, h, d = query.shape
    sk = key.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    dropout_p = dropout_p if training else 0.0
    kernel_route = use_kernels() and _kernel_shapes(query, key) and \
        key.shape[2] == h
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
    scaled_dot_product_attention.dense_routes += 1
    return _dense_attention(query, key, value, attn_mask, is_causal, scale,
                            dropout_p)


#: calls that took the dense path since the count was last set to 0
scaled_dot_product_attention.dense_routes = 0


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
        xt = _nchw(x, data_format)
        if pad == "same" and stride != (1, 1):
            # lax's SAME: out = ceil(in / s), the total padding split
            # total // 2 before and the rest after, then no padding
            (pt, pb), (pl, pr) = (_same_pads(xt.shape[2 + i], w.shape[2 + i],
                                             stride[i], dilation[i])
                                  for i in (0, 1))
            xt, pad = TF.pad(xt, (pl, pr, pt, pb)), (0, 0)
        out = _back(TF.conv2d(xt, w, None, stride, pad, dilation, groups),
                    data_format)
    if bias is not None:
        shape = (1, -1, 1, 1) if data_format == "NCHW" else (-1,)
        out = out + bias.to(out.dtype).reshape(shape)
    return out


def _same_pads(size: int, k: int, s: int, d: int) -> Tuple[int, int]:
    """lax's SAME padding of one axis: ``(before, after)``."""
    out = -(-size // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def _pool_args(kernel_size, stride, padding):
    k = _pair(kernel_size)
    return k, _pair(stride if stride is not None else kernel_size), \
        _pair(padding)


def _neg_fill(x: torch.Tensor) -> float:
    """The value padding takes in a max pool: ``-inf``, or an integer
    dtype's least value (``reduce_window``'s init in JAX)."""
    if x.is_floating_point():
        return float("-inf")
    return torch.iinfo(x.dtype).min


def max_pool2d(x, kernel_size, stride=None, padding=0,
               return_mask: bool = False, data_format: str = "NCHW"):
    """Max pooling; the padding never wins (``-inf``), as ``reduce_window``
    with a ``-inf`` init. Padding past half the kernel, which torch's pool
    refuses, is applied first as ``-inf`` (JAX computes it).
    ``return_mask=True`` (NCHW only, as JAX asserts) returns
    :func:`max_pool2d_with_index`'s ``(pooled, mask)``."""
    if isinstance(return_mask, str):
        # the JAX function's compat: data_format passed 5th, positionally
        data_format, return_mask = return_mask, False
    if return_mask:
        if data_format != "NCHW":
            raise ValueError("max_pool2d(return_mask=True) takes NCHW input")
        return max_pool2d_with_index(x, kernel_size, stride, padding)
    k, s, (ph, pw) = _pool_args(kernel_size, stride, padding)
    xt = _nchw(x, data_format)
    if 2 * ph > k[0] or 2 * pw > k[1]:
        xt = TF.pad(xt, (pw, pw, ph, ph), value=_neg_fill(xt))
        ph = pw = 0
    return _back(TF.max_pool2d(xt, k, s, (ph, pw)), data_format)


def max_pool2d_with_index(x, kernel_size, stride=None, padding=0):
    """``(pooled, mask)`` of an NCHW max pool: ``mask`` holds each output's
    argmax as a flat ``h·w`` index of the unpadded input (int64; the JAX
    function's is int32). Padding never wins: it is ``-inf``. Ties go to
    the first position of the window in row-major order, as ``jnp.argmax``
    breaks them (a window of ReLU's zeros takes its top-left zero); a
    window of padding only gives ``-inf`` and the index of its top-left
    corner (negative or past the row, as in JAX)."""
    n, c, h, w = x.shape
    (kh, kw), (sh, sw), (ph, pw) = _pool_args(kernel_size, stride, padding)
    xp = TF.pad(x, (pw, pw, ph, ph), value=_neg_fill(x))
    oh = (h + 2 * ph - kh) // sh + 1
    ow = (w + 2 * pw - kw) // sw + 1
    # [N, C, oh, ow, kh, kw] windows, flattened row-major
    win = xp.unfold(2, kh, sh).unfold(3, kw, sw)[:, :, :oh, :ow]
    win = win.reshape(n, c, oh, ow, kh * kw)
    pooled, arg = win.max(dim=-1)
    # torch.max's index on ties is not documented as the first: take the
    # first position equal to the max
    pos = torch.arange(kh * kw, device=x.device)
    arg = torch.where(win == pooled[..., None], pos, kh * kw).amin(-1)
    arg = torch.where(arg == kh * kw, 0, arg)   # NaN windows
    rows = (torch.arange(oh, device=x.device) * sh - ph)[:, None] + \
        torch.div(arg, kw, rounding_mode="floor")
    cols = (torch.arange(ow, device=x.device) * sw - pw)[None, :] + arg % kw
    return pooled, rows * w + cols


def avg_pool2d(x, kernel_size, stride=None, padding=0,
               data_format: str = "NCHW", exclusive: bool = True):
    """Average pooling over zero padding: with ``exclusive`` and padding
    each window divides by its count of real elements, otherwise by the
    window's size (JAX ``nn/functional.py:282-291``). Any padding, as in
    JAX (torch's pool refuses more than half the kernel)."""
    k, s, (ph, pw) = _pool_args(kernel_size, stride, padding)
    xt = _nchw(x, data_format)
    if (ph, pw) != (0, 0):
        xt = TF.pad(xt, (pw, pw, ph, ph))
    summed = TF.avg_pool2d(xt, k, s, divisor_override=1)
    if exclusive and (ph, pw) != (0, 0):
        ones = TF.pad(torch.ones_like(_nchw(x, data_format)[:1, :1]),
                      (pw, pw, ph, ph))
        counts = TF.avg_pool2d(ones, k, s, divisor_override=1)
        out = summed / counts
    else:
        out = summed / (k[0] * k[1])
    return _back(out, data_format)


def _pad_index(n: int, lo: int, hi: int, mode: str, device) -> torch.Tensor:
    """The source index of each of the ``lo + n + hi`` positions of one
    padded axis, as numpy's ``reflect`` (no edge repeat), ``edge`` and
    ``wrap`` modes give them at any width."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "replicate":
        return i.clamp(0, n - 1)
    if mode == "circular":
        return i % n
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = i % period
    return torch.where(i >= n, period - i, i)


def pad(x, pad_width, mode: str = "constant", value: float = 0.0,
        data_format: str = "NCHW"):
    """Paddle's pad (JAX ``nn/functional.py:702-725``): ``pad_width`` a
    flat ``[lo_last, hi_last, lo_prev, ...]`` over the trailing spatial
    axes (between batch and channels for a channels-last
    ``data_format``), or one ``(lo, hi)`` pair per axis. ``mode`` is
    ``constant`` (``value``), ``reflect``, ``replicate`` or ``circular``
    (numpy's ``reflect``, ``edge`` and ``wrap``)."""
    if isinstance(pad_width[0], (tuple, list)):
        widths = [tuple(int(v) for v in p) for p in pad_width]
    else:
        if len(pad_width) % 2:
            raise ValueError(f"pad_width needs pairs; got {pad_width!r}")
        n_spatial = len(pad_width) // 2
        channels_last = data_format.endswith("C") and x.dim() > 2
        last = x.dim() - (2 if channels_last else 1)
        widths = [(0, 0)] * x.dim()
        for i in range(n_spatial):
            widths[last - i] = (int(pad_width[2 * i]),
                                int(pad_width[2 * i + 1]))
    if mode not in ("constant", "reflect", "replicate", "circular"):
        raise ValueError(f"pad mode {mode!r}")
    if mode == "constant":
        flat = [v for lo, hi in reversed(widths) for v in (lo, hi)]
        return TF.pad(x, flat, value=value)
    for dim, (lo, hi) in enumerate(widths):
        if lo or hi:
            x = x.index_select(dim, _pad_index(x.shape[dim], lo, hi, mode,
                                               x.device))
    return x


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


# ---------------------------------------------------------------------------
# Activations (JAX nn/functional.py:67-134 and :849-928)
# ---------------------------------------------------------------------------

def relu6(x):
    return torch.clamp(x, 0, 6)


def gelu(x, approximate: bool = False):
    """The exact erf GELU, or the tanh form with ``approximate``."""
    return TF.gelu(x, approximate="tanh" if approximate else "none")


def silu(x):
    return TF.silu(x)


swish = silu


def sigmoid(x):
    return torch.sigmoid(x)


def tanh(x):
    return torch.tanh(x)


def leaky_relu(x, negative_slope: float = 0.01):
    return torch.where(x >= 0, x, negative_slope * x)


def elu(x, alpha: float = 1.0):
    return torch.where(x > 0, x, alpha * torch.expm1(
        torch.where(x > 0, torch.zeros_like(x), x)))


def selu(x, scale: float = 1.0507009873554805,
         alpha: float = 1.6732632423543772):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def hardswish(x):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def hardsigmoid(x, slope: float = 1 / 6, offset: float = 0.5):
    """``clip(slope·x + offset, 0, 1)`` at JAX's slope 1/6 (torch's
    ``hardsigmoid`` has the same slope; Paddle's default is 0.1667)."""
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def mish(x):
    return x * torch.tanh(_softplus(x))


def softplus(x, beta: float = 1.0, threshold: float = 20.0):
    """``x`` where ``beta·x > threshold``, else ``softplus(beta·x) /
    beta`` (the threshold on beta·x, as JAX and Paddle put it)."""
    scaled = beta * x
    return torch.where(scaled > threshold, x, _softplus(scaled) / beta)


def glu(x, axis: int = -1):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


def softmax(x, axis: int = -1, dtype=None):
    out = torch.softmax(x, dim=axis)
    return out.to(to_dtype(dtype)) if dtype is not None else out


def log_softmax(x, axis: int = -1):
    return torch.log_softmax(x, dim=axis)


def one_hot(x, num_classes: int, dtype=None):
    """``jax.nn.one_hot``: an id outside ``[0, num_classes)`` gives a row
    of zeros (torch's ``one_hot`` raises there)."""
    classes = torch.arange(num_classes, device=x.device)
    return (x[..., None] == classes).to(
        to_dtype(dtype) if dtype else get_default_dtype())


def celu(x, alpha: float = 1.0):
    return torch.clamp_min(x, 0) + torch.clamp_max(
        alpha * (torch.exp(x / alpha) - 1), 0)


def hardshrink(x, threshold: float = 0.5):
    return torch.where(torch.abs(x) > threshold, x, torch.zeros_like(x))


def hardtanh(x, min: float = -1.0, max: float = 1.0):
    return torch.clamp(x, min, max)


def softshrink(x, threshold: float = 0.5):
    zero = torch.zeros_like(x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


def softsign(x):
    return x / (1 + torch.abs(x))


def tanhshrink(x):
    return x - torch.tanh(x)


def thresholded_relu(x, threshold: float = 1.0):
    return torch.where(x > threshold, x, torch.zeros_like(x))


def log_sigmoid(x):
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -_softplus(-x)


def maxout(x, groups: int, axis: int = 1):
    """The max over ``groups``-way splits of the channel axis."""
    c = x.shape[axis]
    if c % groups:
        raise ValueError(f"channels {c} must divide into groups {groups}")
    axis %= x.dim()
    shape = list(x.shape)
    shape[axis:axis + 1] = [c // groups, groups]
    return torch.amax(x.reshape(shape), dim=axis + 1)


def prelu(x, weight, data_format: str = "NCHW"):
    """``weight`` a scalar or one slope a channel, the channel axis from
    ``data_format``."""
    w = torch.as_tensor(weight, device=x.device)
    if w.dim() == 1 and w.shape[0] > 1 and x.dim() > 2:
        if data_format.endswith("C"):
            w = w.reshape((1,) * (x.dim() - 1) + (-1,))
        else:
            w = w.reshape((1, -1) + (1,) * (x.dim() - 2))
    return torch.where(x >= 0, x, w * x)


def _uniform(shape, low, high, dtype, device, key=None):
    """U[low, high) of ``shape`` from ``key`` (default: the next key)."""
    gen = torch_generator(next_key() if key is None else key, device)
    u = torch.rand(shape, generator=gen, device=device, dtype=dtype)
    return low + (high - low) * u


def rrelu(x, lower: float = 1. / 8., upper: float = 1. / 3.,
          training: bool = True):
    """Randomized leaky ReLU: in training each slope U[lower, upper) from
    the key stream; in eval the mean slope."""
    if training:
        slope = _uniform(x.shape, lower, upper, x.dtype, x.device)
    else:
        slope = (lower + upper) / 2.0
    return torch.where(x >= 0, x, slope * x)


def gumbel_softmax(x, temperature: float = 1.0, hard: bool = False,
                   axis: int = -1):
    """Gumbel noise ``-log(-log(U))`` (U from the key stream, on
    ``[tiny, 1)`` as ``jax.random.gumbel`` draws it) plus softmax;
    straight-through with ``hard``."""
    tiny = torch.finfo(x.dtype).tiny
    u = _uniform(x.shape, tiny, 1.0, x.dtype, x.device).clamp_min(tiny)
    y = torch.softmax((x - torch.log(-torch.log(u))) / temperature, dim=axis)
    if hard:
        idx = torch.argmax(y, dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        y = (y_hard - y).detach() + y
    return y


def label_smooth(label, prior_dist=None, epsilon: float = 0.1):
    num_classes = label.shape[-1]
    if prior_dist is None:
        return (1.0 - epsilon) * label + epsilon / num_classes
    return (1.0 - epsilon) * label + epsilon * prior_dist


# ---------------------------------------------------------------------------
# Norms (JAX :535-569, :1290-1323)
# ---------------------------------------------------------------------------

def rms_norm(x, weight=None, epsilon: float = 1e-6, axis: int = -1):
    xf = x.float()
    out = xf * torch.rsqrt(torch.mean(xf * xf, dim=axis, keepdim=True)
                           + epsilon)
    if weight is not None:
        out = out * weight.float()
    return out.to(x.dtype)


def group_norm(x, num_groups: int, weight=None, bias=None,
               epsilon: float = 1e-5, data_format: str = "NCHW"):
    """GroupNorm of ``[N, C, H, W]`` (NCHW only, as in JAX): statistics
    in float32, the result in x's dtype."""
    if data_format != "NCHW":
        raise NotImplementedError("group_norm: NCHW only")
    n, c, h, w = x.shape
    xf = x.float().reshape(n, num_groups, c // num_groups, h, w)
    mean = xf.mean(dim=(2, 3, 4), keepdim=True)
    var = xf.var(dim=(2, 3, 4), keepdim=True, unbiased=False)
    out = ((xf - mean) * torch.rsqrt(var + epsilon)).reshape(n, c, h, w)
    if weight is not None:
        out = out * weight.reshape(1, c, 1, 1)
    if bias is not None:
        out = out + bias.reshape(1, c, 1, 1)
    return out.to(x.dtype)


def normalize(x, p: float = 2, axis: int = 1, epsilon: float = 1e-12):
    norm = torch.linalg.vector_norm(x, ord=p, dim=axis, keepdim=True)
    return x / torch.clamp_min(norm, epsilon)


def cosine_similarity(x1, x2, axis: int = 1, eps: float = 1e-8):
    dot = (x1 * x2).sum(dim=axis)
    n1 = torch.linalg.vector_norm(x1, dim=axis)
    n2 = torch.linalg.vector_norm(x2, dim=axis)
    return dot / torch.clamp_min(n1 * n2, eps)


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats: bool = True,
                  momentum: float = 0.9, eps: float = 1e-5,
                  data_format: str = "NCHW"):
    """Each ``(n, c)`` slice normalised over its spatial axes with its own
    statistics (in x's dtype, as JAX computes them); the running
    statistics are taken and not used, as in JAX."""
    if data_format not in ("NCHW", "NCL", "NCDHW"):
        raise ValueError(f"instance_norm takes channels-first data; got "
                         f"{data_format!r}")
    axes = tuple(range(2, x.dim()))
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, keepdim=True, unbiased=False)
    out = (x - mean) * torch.rsqrt(var + eps)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out.to(x.dtype)


def local_response_norm(x, size: int = 5, alpha: float = 1e-4,
                        beta: float = 0.75, k: float = 1.0,
                        data_format: str = "NCHW"):
    """Cross-channel LRN: ``x / (k + alpha·sum/size)^beta`` with the sum
    of squares over ``size`` channels (zero-padded ``(size-1)//2`` before,
    the rest after)."""
    if data_format != "NCHW":
        raise ValueError("local_response_norm takes NCHW input")
    lo = (size - 1) // 2
    sq = TF.pad(x * x, (0, 0, 0, 0, lo, size - 1 - lo))
    summed = sq.unfold(1, size, 1).sum(-1)
    return (x / torch.pow(k + alpha * summed / size, beta)).to(x.dtype)


# ---------------------------------------------------------------------------
# Losses (JAX :613-695, :935-1086)
# ---------------------------------------------------------------------------

def _reduce(loss, reduction: str):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"unknown reduction {reduction!r}")


def softmax_with_cross_entropy(logits, label, soft_label: bool = False,
                               ignore_index: int = -100, axis: int = -1,
                               return_softmax: bool = False):
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis).unsqueeze(axis)
    if return_softmax:
        return loss, softmax(logits, axis=axis)
    return loss


def nll_loss(log_probs, label, weight=None, ignore_index: int = -100,
             reduction: str = "mean"):
    """``-log_probs[label]`` over the last axis; an ignored label gives 0,
    the mean divides by the labels not ignored (``weight`` scales but does
    not enter the mean's divisor, as in JAX)."""
    label = label.long()
    valid = label != ignore_index
    safe = torch.where(valid, label, 0)
    loss = -torch.gather(log_probs, -1, safe[..., None])[..., 0]
    if weight is not None:
        loss = loss * torch.as_tensor(weight, device=loss.device)[safe]
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    return loss.sum() / torch.clamp_min(valid.sum(), 1)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction: str = "mean",
                                     pos_weight=None):
    logit, label = logit.float(), label.float()
    max_val = torch.clamp_min(-logit, 0)
    tail = torch.log1p(torch.exp(-torch.abs(logit))) + max_val
    if pos_weight is not None:
        loss = (1.0 - label) * logit + ((pos_weight - 1.0) * label + 1.0) \
            * tail
    else:
        loss = (1.0 - label) * logit + tail
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def mse_loss(input, label, reduction: str = "mean"):
    return _reduce(torch.square(input - label), reduction)


def l1_loss(input, label, reduction: str = "mean"):
    return _reduce(torch.abs(input - label), reduction)


def smooth_l1_loss(input, label, reduction: str = "mean",
                   delta: float = 1.0):
    """``0.5·d²/delta`` below ``delta`` and ``d − 0.5·delta`` above it (JAX
    ``:671-673``; torch's ``smooth_l1_loss`` at ``beta=delta``)."""
    diff = torch.abs(input - label)
    return _reduce(torch.where(diff < delta, 0.5 * diff * diff / delta,
                               diff - 0.5 * delta), reduction)


def kl_div(input, label, reduction: str = "mean"):
    """``label·(log(max(label, 1e-12)) − input)`` (JAX's clipped log), and
    ``batchmean`` dividing the sum by the batch."""
    loss = label * (torch.log(torch.clamp_min(label, 1e-12)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


def binary_cross_entropy(input, label, weight=None, reduction: str = "mean"):
    eps = 1e-12
    loss = -(label * torch.log(input + eps)
             + (1 - label) * torch.log(1 - input + eps))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def log_loss(input, label, epsilon: float = 1e-4):
    return -label * torch.log(input + epsilon) \
        - (1 - label) * torch.log(1 - input + epsilon)


def margin_ranking_loss(input, other, label, margin: float = 0.0,
                        reduction: str = "mean"):
    return _reduce(torch.clamp_min(-label * (input - other) + margin, 0),
                   reduction)


def soft_margin_loss(input, label, reduction: str = "mean"):
    return _reduce(torch.log1p(torch.exp(-label * input)), reduction)


def triplet_margin_loss(input, positive, negative, margin: float = 1.0,
                        p: float = 2.0, epsilon: float = 1e-6,
                        swap: bool = False, reduction: str = "mean"):
    def dist(a, b):
        return torch.pow(torch.sum(torch.pow(torch.abs(a - b) + epsilon, p),
                                   dim=-1), 1.0 / p)
    d_pos, d_neg = dist(input, positive), dist(input, negative)
    if swap:
        d_neg = torch.minimum(d_neg, dist(positive, negative))
    return _reduce(torch.clamp_min(d_pos - d_neg + margin, 0), reduction)


def cosine_embedding_loss(input1, input2, label, margin: float = 0.0,
                          reduction: str = "mean"):
    cos = cosine_similarity(input1, input2, axis=-1)
    return _reduce(torch.where(label == 1, 1 - cos,
                               torch.clamp_min(cos - margin, 0)), reduction)


def hinge_embedding_loss(input, label, margin: float = 1.0,
                         reduction: str = "mean"):
    return _reduce(torch.where(label == 1, input,
                               torch.clamp_min(margin - input, 0)),
                   reduction)


def poisson_nll_loss(input, label, log_input: bool = True,
                     full: bool = False, epsilon: float = 1e-8,
                     reduction: str = "mean"):
    if log_input:
        loss = torch.exp(input) - label * input
    else:
        loss = input - label * torch.log(input + epsilon)
    if full:
        stirling = label * torch.log(label + epsilon) - label \
            + 0.5 * torch.log(2 * math.pi * (label + epsilon))
        loss = loss + torch.where(label > 1, stirling,
                                  torch.zeros_like(stirling))
    return _reduce(loss, reduction)


def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction: str = "mean"):
    loss = -(label * log_sigmoid(input) + (1 - label) * log_sigmoid(-input))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss.mean(dim=-1), reduction)


def square_error_cost(input, label):
    return torch.square(input - label)


def _lse(a, b):
    m = torch.maximum(a, b)
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m))


def ctc_loss(log_probs, labels, input_lengths, label_lengths,
             blank: int = 0, reduction: str = "mean",
             norm_by_times: bool = False):
    """CTC loss as the JAX function computes it (``:1025-1086``):
    ``log_probs`` ``[T, B, C]`` are *unnormalised* logits (Paddle's
    warpctc contract), so ``log_softmax`` is applied first; ``labels``
    ``[B, L]``. The forward recursion over the extended label sequence in
    the log semiring, one step a frame, with JAX's ``-1e30`` for an
    impossible state; the loss is read at each sequence's last frame.
    ``reduction="mean"`` averages over the batch (``norm_by_times``
    divides each loss by its length first)."""
    log_probs = torch.log_softmax(log_probs, dim=-1)
    t_len, b, _ = log_probs.shape
    labels = labels.long()
    input_lengths = torch.as_tensor(input_lengths,
                                    device=log_probs.device).long()
    label_lengths = torch.as_tensor(label_lengths,
                                    device=log_probs.device).long()
    n_lab = labels.shape[1]
    s = 2 * n_lab + 1
    ext = torch.full((b, s), blank, dtype=torch.long, device=labels.device)
    ext[:, 1::2] = labels
    neg = -1e30
    can_skip = torch.zeros((b, s), dtype=torch.bool, device=labels.device)
    can_skip[:, 2:] = (ext[:, 2:] != blank) & (ext[:, 2:] != ext[:, :-2])
    rows = torch.arange(b, device=labels.device)
    first = torch.full((b, s), neg, dtype=log_probs.dtype,
                       device=log_probs.device)
    first[:, 0] = log_probs[0, rows, ext[:, 0]]
    if n_lab > 0:
        first[:, 1] = log_probs[0, rows, ext[:, 1]]
    alpha, alphas = first, [first]
    pad1 = torch.full((b, 1), neg, dtype=log_probs.dtype,
                      device=log_probs.device)
    pad2 = torch.full((b, 2), neg, dtype=log_probs.dtype,
                      device=log_probs.device)
    for t in range(1, t_len):
        emit = torch.gather(log_probs[t], 1, ext)
        prev1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        prev2 = torch.cat([pad2, alpha[:, :-2]], dim=1)
        prev2 = torch.where(can_skip, prev2, neg)
        alpha = _lse(_lse(alpha, prev1), prev2) + emit
        alphas.append(alpha)
    alphas = torch.stack(alphas)                        # [T, B, S]
    last = alphas[torch.clamp(input_lengths - 1, 0, t_len - 1), rows]
    s_last = 2 * label_lengths
    a_blank = torch.gather(last, 1, s_last[:, None])[:, 0]
    a_label = torch.gather(last, 1, torch.clamp(s_last - 1, 0, s - 1)
                           [:, None])[:, 0]
    a_label = torch.where(label_lengths > 0, a_label, neg)
    nll = -_lse(a_blank, a_label)
    if norm_by_times:
        nll = nll / torch.clamp_min(input_lengths, 1)
    return _reduce(nll, reduction)


# ---------------------------------------------------------------------------
# Convolution and pooling: 1-D, 3-D, transposed (JAX :1093-1283, :1465-1535)
# ---------------------------------------------------------------------------

def _ntuple(v, n: int) -> Tuple[int, ...]:
    if isinstance(v, (list, tuple)):
        if len(v) != n:
            raise ValueError(f"expected {n} values, got {v!r}")
        return tuple(int(x) for x in v)
    return (int(v),) * n


def _conv_nd(x, weight, bias, stride, padding, dilation, groups, nd, conv):
    """A channels-first ``nd``-D library convolution with lax's padding
    rules: ints, or ``"SAME"``/``"VALID"`` at any stride."""
    stride, dilation = _ntuple(stride, nd), _ntuple(dilation, nd)
    w = weight.to(x.dtype)
    if isinstance(padding, str):
        if padding.lower() not in ("same", "valid"):
            raise ValueError(f"padding must be 'SAME' or 'VALID'; got "
                             f"{padding!r}")
        pad = (0,) * nd
        if padding.lower() == "same":
            flat = []
            for i in reversed(range(nd)):
                flat += _same_pads(x.shape[2 + i], w.shape[2 + i],
                                   stride[i], dilation[i])
            x = TF.pad(x, flat)
    else:
        pad = _ntuple(padding, nd)
    out = conv(x, w, None, stride, pad, dilation, groups)
    if bias is not None:
        out = out + bias.to(out.dtype).reshape((1, -1) + (1,) * nd)
    return out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1,
           groups: int = 1, data_format: str = "NCL"):
    """``x [N, C, L]``, ``weight [out, in/groups, k]``."""
    if data_format != "NCL":
        raise ValueError("conv1d takes NCL input")
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 1,
                    TF.conv1d)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1,
           groups: int = 1, data_format: str = "NCDHW"):
    """``weight [out, in/groups, kd, kh, kw]``; NCDHW or NDHWC."""
    if data_format == "NDHWC":
        return _conv_nd(x.permute(0, 4, 1, 2, 3), weight, bias, stride,
                        padding, dilation, groups, 3,
                        TF.conv3d).permute(0, 2, 3, 4, 1)
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 3,
                    TF.conv3d)


def _output_padding_from_size(x, weight, stride, padding, dilation,
                              output_size, spatial):
    """The ``output_padding`` that makes the output ``output_size``."""
    stride, pads = _ntuple(stride, spatial), _ntuple(padding, spatial)
    dilation = _ntuple(dilation, spatial)
    sizes = tuple(int(s) for s in output_size[-spatial:])
    ops = []
    for i in range(spatial):
        base = (x.shape[2 + i] - 1) * stride[i] - 2 * pads[i] \
            + dilation[i] * (weight.shape[2 + i] - 1) + 1
        op = sizes[i] - base
        if not 0 <= op < stride[i] + dilation[i]:
            raise ValueError(f"output_size {sizes[i]} unreachable on dim "
                             f"{i}: base size {base}, stride {stride[i]}")
        ops.append(op)
    return tuple(ops)


def _conv_transpose(x, weight, bias, stride, padding, output_padding,
                    dilation, groups, spatial, fmt):
    """The transposed convolution, weight ``[in, out/groups, *k]`` (Paddle's
    layout, torch's too): ``out = (in − 1)·s − 2p + d·(k − 1) +
    output_padding + 1``; a library ``conv_transpose``."""
    if fmt not in ("NCL", "NCHW", "NCDHW"):
        raise ValueError(f"transposed convs take channels-first data; got "
                         f"{fmt!r}")
    fn = {1: TF.conv_transpose1d, 2: TF.conv_transpose2d,
          3: TF.conv_transpose3d}[spatial]
    out = fn(x, weight.to(x.dtype), None, _ntuple(stride, spatial),
             _ntuple(padding, spatial), _ntuple(output_padding, spatial),
             groups, _ntuple(dilation, spatial))
    if bias is not None:
        out = out + bias.to(out.dtype).reshape((1, -1) + (1,) * spatial)
    return out


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups: int = 1,
                     output_size=None, data_format: str = "NCL"):
    if output_size is not None:
        (output_padding,) = _output_padding_from_size(
            x, weight, stride, padding, dilation,
            [output_size] if isinstance(output_size, int) else output_size,
            1)
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 1, data_format)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups: int = 1,
                     output_size=None, data_format: str = "NCHW"):
    if output_size is not None:
        output_padding = _output_padding_from_size(
            x, weight, stride, padding, dilation, output_size, 2)
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 2, data_format)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups: int = 1,
                     output_size=None, data_format: str = "NCDHW"):
    if output_size is not None:
        output_padding = _output_padding_from_size(
            x, weight, stride, padding, dilation, output_size, 3)
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 3, data_format)


def _pool3d_args(kernel_size, stride, padding):
    k = _ntuple(kernel_size, 3)
    return k, _ntuple(stride if stride is not None else kernel_size, 3), \
        _ntuple(padding, 3)


def max_pool3d(x, kernel_size, stride=None, padding=0,
               data_format: str = "NCDHW"):
    """Max pooling of NCDHW data; padding never wins, at any width."""
    if data_format != "NCDHW":
        raise ValueError("max_pool3d takes NCDHW input")
    k, s, p = _pool3d_args(kernel_size, stride, padding)
    if any(2 * p[i] > k[i] for i in range(3)):
        x = TF.pad(x, (p[2], p[2], p[1], p[1], p[0], p[0]),
                   value=_neg_fill(x))
        p = (0, 0, 0)
    return TF.max_pool3d(x, k, s, p)


def avg_pool3d(x, kernel_size, stride=None, padding=0,
               data_format: str = "NCDHW", exclusive: bool = True):
    """Average pooling of NCDHW data over zero padding (``exclusive``:
    each window divides by its count of real elements)."""
    if data_format != "NCDHW":
        raise ValueError("avg_pool3d takes NCDHW input")
    k, s, p = _pool3d_args(kernel_size, stride, padding)
    flat = (p[2], p[2], p[1], p[1], p[0], p[0])
    summed = TF.avg_pool3d(TF.pad(x, flat), k, s, divisor_override=1)
    if exclusive and p != (0, 0, 0):
        ones = TF.pad(torch.ones_like(x[:1, :1]), flat)
        return summed / TF.avg_pool3d(ones, k, s, divisor_override=1)
    return summed / (k[0] * k[1] * k[2])


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format: str = "NCHW"):
    """Each pooled value scattered back to its flat ``h·w`` position."""
    if data_format != "NCHW":
        raise ValueError("max_unpool2d takes NCHW input")
    n, c, oh, ow = x.shape
    k = _pair(kernel_size)
    s = _pair(stride if stride is not None else kernel_size)
    ph, pw = _pair(padding)
    if output_size is None:
        out_h = (oh - 1) * s[0] - 2 * ph + k[0]
        out_w = (ow - 1) * s[1] - 2 * pw + k[1]
    else:
        out_h, out_w = output_size[-2], output_size[-1]
    out = x.new_zeros((n, c, out_h * out_w))
    out = out.scatter(2, indices.reshape(n, c, -1).long(),
                      x.reshape(n, c, -1))
    return out.reshape(n, c, out_h, out_w)


def max_pool1d(x, kernel_size, stride=None, padding=0,
               data_format: str = "NCL"):
    if data_format != "NCL":
        raise ValueError("max_pool1d takes NCL input")
    out = max_pool2d(x[:, :, None, :], (1, _ntuple(kernel_size, 1)[0]),
                     (1, _ntuple(stride if stride is not None
                                 else kernel_size, 1)[0]),
                     (0, _ntuple(padding, 1)[0]))
    return out[:, :, 0, :]


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               data_format: str = "NCL"):
    if data_format != "NCL":
        raise ValueError("avg_pool1d takes NCL input")
    out = avg_pool2d(x[:, :, None, :], (1, _ntuple(kernel_size, 1)[0]),
                     (1, _ntuple(stride if stride is not None
                                 else kernel_size, 1)[0]),
                     (0, _ntuple(padding, 1)[0]), exclusive=exclusive)
    return out[:, :, 0, :]


def adaptive_avg_pool1d(x, output_size: int, data_format: str = "NCL"):
    if data_format != "NCL":
        raise ValueError("adaptive_avg_pool1d takes NCL input")
    return adaptive_avg_pool2d(x[:, :, None, :], (1, output_size))[:, :, 0]


# ---------------------------------------------------------------------------
# Geometry (JAX :728-738, :1330-1458, :1543-1598)
# ---------------------------------------------------------------------------

_RESIZE = {"nearest": dict(mode="nearest-exact"),
           "bilinear": dict(mode="bilinear", align_corners=False,
                            antialias=True),
           "bicubic": dict(mode="bicubic", align_corners=False,
                           antialias=True)}


def interpolate(x, size=None, scale_factor=None, mode: str = "nearest",
                data_format: str = "NCHW"):
    """``jax.image.resize`` of NCHW data to ``size`` (or ``int(h·sf),
    int(w·sf)``): half-pixel ``nearest`` (torch's ``nearest-exact``),
    ``bilinear`` and ``bicubic`` (Keys' a = −0.5) antialiased when
    downsampling (torch's ``antialias=True``, which scales the kernel only
    when the size shrinks)."""
    if data_format != "NCHW":
        raise NotImplementedError("interpolate takes NCHW input")
    if mode not in _RESIZE:
        raise ValueError(f"mode must be one of {sorted(_RESIZE)}; got "
                         f"{mode!r}")
    h, w = x.shape[2], x.shape[3]
    if size is None:
        sf = tuple(float(v) for v in scale_factor) \
            if isinstance(scale_factor, (list, tuple)) else \
            (float(scale_factor),) * 2
        size = (int(h * sf[0]), int(w * sf[1]))
    out = TF.interpolate(x if x.is_floating_point() else x.float(),
                         size=_pair(size), **_RESIZE[mode])
    return out.to(x.dtype)


def upsample(x, size=None, scale_factor=None, mode: str = "nearest",
             align_corners: bool = False, data_format: str = "NCHW"):
    """:func:`interpolate`; ``align_corners`` is taken and ignored, as the
    JAX function ignores it (half-pixel centres, Paddle's
    ``align_corners=False``; a kept fault of the reference)."""
    return interpolate(x, size=size, scale_factor=scale_factor, mode=mode,
                       data_format=data_format)


def grid_sample(x, grid, mode: str = "bilinear",
                padding_mode: str = "zeros", align_corners: bool = True):
    """JAX's sampler (``:1330-1385``): ``x [N, C, H, W]``, ``grid [N, Hg,
    Wg, 2]`` holding (x, y) in [-1, 1]; ``bilinear`` or ``nearest``
    (round half to even), ``zeros``/``border``/``reflection`` padding.
    Torch's ``grid_sample`` defaults to ``align_corners=False`` where JAX's
    is True; this computes JAX's formulas as they are."""
    n, c, h, w = x.shape
    gx, gy = grid[..., 0], grid[..., 1]

    def unnormalize(coord, size):
        if align_corners:
            return (coord + 1) / 2 * (size - 1)
        return ((coord + 1) * size - 1) / 2

    ix, iy = unnormalize(gx, w), unnormalize(gy, h)
    if padding_mode == "border":
        ix, iy = torch.clamp(ix, 0, w - 1), torch.clamp(iy, 0, h - 1)
    elif padding_mode == "reflection":
        def reflect(coord, size):
            if align_corners:
                span = size - 1
                if span <= 0:
                    return coord * 0
                t = torch.remainder(torch.abs(coord), 2 * span)
                return span - torch.abs(t - span)
            t = torch.remainder(torch.abs(coord + 0.5), 2 * size)
            return torch.clamp(size - torch.abs(t - size) - 0.5, 0, size - 1)
        ix, iy = reflect(ix, w), reflect(iy, h)
    flat = x.reshape(n, c, h * w)

    def gather(py, px):
        valid = (py >= 0) & (py < h) & (px >= 0) & (px < w)
        idx = (py.clamp(0, h - 1) * w + px.clamp(0, w - 1)).reshape(n, 1, -1)
        vals = torch.gather(flat, 2, idx.expand(n, c, idx.shape[-1]).long())
        vals = vals.reshape(n, c, *py.shape[1:])
        if padding_mode == "zeros":
            vals = torch.where(valid.reshape(n, 1, *py.shape[1:]), vals,
                               torch.zeros_like(vals))
        return vals

    if mode == "nearest":
        return gather(torch.round(iy).long(),
                      torch.round(ix).long()).to(x.dtype)
    x0, y0 = torch.floor(ix).long(), torch.floor(iy).long()
    wx = (ix - x0).reshape(n, 1, *ix.shape[1:])
    wy = (iy - y0).reshape(n, 1, *iy.shape[1:])
    top = gather(y0, x0) * (1 - wx) + gather(y0, x0 + 1) * wx
    bot = gather(y0 + 1, x0) * (1 - wx) + gather(y0 + 1, x0 + 1) * wx
    return (top * (1 - wy) + bot * wy).to(x.dtype)


def affine_grid(theta, out_shape, align_corners: bool = True):
    """``theta [N, 2, 3]``, ``out_shape [N, C, H, W]`` -> ``grid [N, H, W,
    2]`` (JAX ``:1388-1404``)."""
    _, _, h, w = (int(v) for v in out_shape)

    def linspace(size):
        if align_corners:
            return torch.linspace(-1.0, 1.0, size, device=theta.device)
        step = 2.0 / size
        return torch.linspace(-1.0 + step / 2, 1.0 - step / 2, size,
                              device=theta.device)

    gy, gx = torch.meshgrid(linspace(h), linspace(w), indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    return torch.einsum("nij,hwj->nhwi", theta, base.to(theta.dtype))


def pixel_shuffle(x, upscale_factor: int, data_format: str = "NCHW"):
    if data_format != "NCHW":
        raise ValueError("pixel_shuffle takes NCHW input")
    n, c, h, w = x.shape
    r = upscale_factor
    oc = c // (r * r)
    return x.reshape(n, oc, r, r, h, w).permute(0, 1, 4, 2, 5, 3).reshape(
        n, oc, h * r, w * r)


def pixel_unshuffle(x, downscale_factor: int, data_format: str = "NCHW"):
    r = downscale_factor
    if data_format == "NHWC":
        x = x.permute(0, 3, 1, 2)
    n, c, h, w = x.shape
    out = x.reshape(n, c, h // r, r, w // r, r).permute(
        0, 1, 3, 5, 2, 4).reshape(n, c * r * r, h // r, w // r)
    return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out


def channel_shuffle(x, groups: int, data_format: str = "NCHW"):
    if data_format != "NCHW":
        raise ValueError("channel_shuffle takes NCHW input")
    n, c, h, w = x.shape
    return x.reshape(n, groups, c // groups, h, w).transpose(1, 2).reshape(
        n, c, h, w)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1):
    """im2col: ``[N, C, H, W]`` -> ``[N, C·kh·kw, L]``, channel-major."""
    return TF.unfold(x, _pair(kernel_sizes), _pair(dilations),
                     _pair(paddings), _pair(strides))


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1):
    """col2im, the overlaps summed: the inverse layout of :func:`unfold`."""
    k, s = _pair(kernel_sizes), _pair(strides)
    p, d = _pair(paddings), _pair(dilations)
    oh, ow = _pair(output_sizes)
    lh = (oh + 2 * p[0] - d[0] * (k[0] - 1) - 1) // s[0] + 1
    lw = (ow + 2 * p[1] - d[1] * (k[1] - 1) - 1) // s[1] + 1
    if lh * lw != x.shape[2]:
        raise ValueError("output_sizes inconsistent with columns")
    return TF.fold(x, (oh, ow), k, d, p, s)


def sequence_mask(x, maxlen=None, dtype="int64"):
    """``mask[..., j] = j < x[...]``; ``maxlen`` defaults to ``max(x)``.
    An ``int64`` mask is 64 bits here (JAX's is int32, 64-bit types off)."""
    x = torch.as_tensor(x)
    if maxlen is None:
        maxlen = int(x.max())
    steps = torch.arange(int(maxlen), device=x.device)
    return (steps < x[..., None]).to(to_dtype(dtype))


def temporal_shift(x, seg_num: int, shift_ratio: float = 0.25,
                   data_format: str = "NCHW"):
    """TSM's shift over the segment axis: the first ``shift_ratio`` of the
    channels read from t − 1, the next block from t + 1, the rest stay."""
    if data_format == "NHWC":
        x = x.permute(0, 3, 1, 2)
    nt, c, h, w = x.shape
    x5 = x.reshape(nt // seg_num, seg_num, c, h, w)
    c1, c2 = int(c * shift_ratio), int(c * 2 * shift_ratio)
    prev = TF.pad(x5[:, :-1, :c1], (0, 0, 0, 0, 0, 0, 1, 0))
    nxt = TF.pad(x5[:, 1:, c1:c2], (0, 0, 0, 0, 0, 0, 0, 1))
    out = torch.cat([prev, nxt, x5[:, :, c2:]], dim=2).reshape(nt, c, h, w)
    return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out


def dice_loss(input, label, epsilon: float = 1e-5):
    """``1 − (2|X∩Y| + eps) / (|X| + |Y| + eps)`` a sample, averaged:
    ``input [..., C]`` probabilities, ``label [..., 1]`` ids."""
    if label.dim() == input.dim() and label.shape[-1] == 1:
        label = label[..., 0]
    onehot = one_hot(label, input.shape[-1], dtype=input.dtype)
    dims = tuple(range(1, input.dim()))
    inter = torch.sum(input * onehot, dim=dims)
    union = torch.sum(input, dim=dims) + torch.sum(onehot, dim=dims)
    return torch.mean(1.0 - (2.0 * inter + epsilon) / (union + epsilon))


def npair_loss(anchor, positive, labels, l2_reg: float = 0.002):
    """Soft-label cross-entropy over ``anchor·positiveᵀ`` with same-label
    targets, plus ``l2_reg/4`` of the embeddings' mean squared norm."""
    anchor, positive = anchor.float(), positive.float()
    reg = (torch.sum(anchor ** 2) + torch.sum(positive ** 2)) \
        / anchor.shape[0] * (l2_reg * 0.25)
    same = (labels[:, None] == labels[None, :]).float()
    target = same / torch.clamp_min(same.sum(-1, keepdim=True), 1.0)
    return cross_entropy(anchor @ positive.T, target, soft_label=True,
                         reduction="mean") + reg


def margin_cross_entropy(logits, label, margin1: float = 1.0,
                         margin2: float = 0.5, margin3: float = 0.0,
                         scale: float = 64.0, group=None,
                         return_softmax: bool = False,
                         reduction: str = "mean"):
    """ArcFace-family margin softmax: the target logit (a cosine) becomes
    ``cos(m1·θ + m2) − m3``, all logits times ``scale``, then
    :func:`cross_entropy`. ``group`` is taken and unused (one device)."""
    logits = logits.float()
    if label.dim() == logits.dim() and label.shape[-1] == 1:
        label = label[..., 0]
    theta = torch.arccos(torch.clamp(logits, -1.0 + 1e-7, 1.0 - 1e-7))
    modified = torch.cos(margin1 * theta + margin2) - margin3
    hit = one_hot(label, logits.shape[-1], dtype=torch.bool)
    out = torch.where(hit, modified, logits) * scale
    loss = cross_entropy(out, label, reduction=reduction)
    if return_softmax:
        return loss, torch.softmax(out, dim=-1)
    return loss


def class_center_sample(label, num_classes: int, num_samples: int,
                        group=None, seed: Optional[int] = None):
    """PartialFC's sampling: every positive class plus negatives drawn
    without replacement, up to ``num_samples``; returns ``(remapped
    label, sampled class ids)``. On the host with numpy, as JAX's is:
    with ``seed`` the draw is JAX's (``default_rng(seed)``), without one
    the seed comes from the port's key stream."""
    import numpy as np
    dev = label.device if isinstance(label, torch.Tensor) else None
    label_np = np.asarray(label.cpu() if dev is not None else label)
    flat = label_np.ravel()
    pos = np.unique(flat)
    rng = np.random.default_rng(
        seed if seed is not None else next_key() % (2 ** 63))
    if len(pos) >= num_samples:
        sampled = pos
    else:
        neg_pool = np.setdiff1d(np.arange(num_classes), pos)
        extra = rng.choice(neg_pool, size=num_samples - len(pos),
                           replace=False)
        sampled = np.sort(np.concatenate([pos, extra]))
    remap = -np.ones(num_classes, np.int64)
    remap[sampled] = np.arange(len(sampled))
    return (torch.as_tensor(remap[flat].reshape(label_np.shape), device=dev),
            torch.as_tensor(sampled, device=dev))


# paddle.nn.functional.flash_attention lives under nn.functional in Paddle;
# the implementation is ops/flash_attention.py (the kernels' routes)
from ..ops.flash_attention import (flash_attention,  # noqa: E402,F401
                                   flash_attn_unpadded)

__all__ += ["flash_attention", "flash_attn_unpadded"]

# functional_wave4's names, and the in-place aliases (which return the
# result, as the JAX ones do)
from .functional_wave4 import *  # noqa: F401,F403,E402
from .functional_wave4 import __all__ as _w4_all  # noqa: E402

elu_ = elu
hardtanh_ = hardtanh
leaky_relu_ = leaky_relu
relu_ = relu
softmax_ = softmax
tanh_ = tanh
thresholded_relu_ = thresholded_relu

__all__ += _w4_all + ["elu_", "hardtanh_", "leaky_relu_", "relu_",
                      "softmax_", "tanh_", "thresholded_relu_"]
