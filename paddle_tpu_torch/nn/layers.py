"""Layers of the port (``paddle_tpu/nn/layers.py`` counterpart): the
transformer encoder layers, the convolution, BatchNorm, pooling and
container layers of the ResNet path, and :class:`CrossEntropyLoss`.

:class:`MultiHeadAttention`, :class:`TransformerEncoderLayer` and
:class:`TransformerEncoder` under the JAX attribute names (``q_proj``,
``k_proj``, ``v_proj``, ``out_proj``, ``linear1``, ``linear2``, ``norm1``,
``norm2``, ``layers``), so state_dict keys match the JAX keys one for one.
Linear weights are in PyTorch's ``[out, in]`` layout;
:mod:`paddle_tpu_torch.convert` transposes the JAX ``[in, out]`` matrices.
Attention goes through :func:`~paddle_tpu_torch.nn.functional.
scaled_dot_product_attention`, which routes it to the kernels as the JAX
function does, attention-prob dropout included; hidden dropout
(:class:`Dropout`) draws its masks from the key stream of
:mod:`paddle_tpu_torch.core.random`. Decoder caches (``cache``,
``gen_cache``) are not ported yet and raise.

:class:`Conv2D` keeps its weight in OIHW ``[out, in/groups, kh, kw]`` as the
JAX layer does (the weights copy across as they are); :class:`BatchNorm2D`
keeps its running statistics in the buffers ``_mean`` and ``_variance``, the
JAX names, so state_dict keys match.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Callable, Optional

import torch
import torch.nn.functional as TF
from torch import nn

from ..amp.auto_cast import maybe_cast_input
from . import functional as F

__all__ = ["Linear", "Dropout", "MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "Conv2D", "BatchNorm2D", "MaxPool2D",
           "AdaptiveAvgPool2D", "ReLU", "Sequential", "CrossEntropyLoss"]


class Linear(nn.Linear):
    """``paddle.nn.Linear`` of the port: torch's ``nn.Linear`` (weight
    ``[out, in]``, parameters ``weight`` and ``bias``, so state_dict keys
    stay as they were), whose forward first asks AMP whether to cast, as the
    JAX ``Linear`` (``nn/layers.py:66-70``) and ``Column/RowParallelLinear``
    (``mp_layers.py:169, :205``) do: under ``auto_cast`` O1 a float32
    input, weight and bias are cast to the AMP dtype
    (``maybe_cast_input("linear", ...)``); otherwise it is torch's
    ``Linear``."""

    def forward(self, x):
        x, w, b = maybe_cast_input("linear", x, self.weight, self.bias)
        return TF.linear(x, w, b)


class Dropout(nn.Module):
    """``paddle.nn.Dropout`` (:func:`~.functional.dropout`): the mask from
    the next key in training; in eval mode the identity, or ``x * (1 - p)``
    in ``downscale_in_infer`` mode."""

    def __init__(self, p: float = 0.5, mode: str = "upscale_in_train"):
        super().__init__()
        self.p, self.mode = float(p), mode

    def forward(self, x):
        return F.dropout(x, self.p, training=self.training, mode=self.mode)


class MultiHeadAttention(nn.Module):
    """Self- or cross-attention with separate q/k/v projections (ref:
    ``python/paddle/nn/layer/transformer.py``). q, k and v are views of
    their projections reshaped to ``[B, S, H, D]``, not copies."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 kdim: Optional[int] = None, vdim: Optional[int] = None,
                 need_weights: bool = False, **factory):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        self.q_proj = Linear(embed_dim, embed_dim, **factory)
        self.k_proj = Linear(kdim or embed_dim, embed_dim, **factory)
        self.v_proj = Linear(vdim or embed_dim, embed_dim, **factory)
        self.out_proj = Linear(embed_dim, embed_dim, **factory)

    _NO_CACHE = ("MultiHeadAttention decoder caches are not ported yet "
                 "(ROADMAP Queue 1)")

    def gen_cache(self, key, value=None, type=None):
        raise NotImplementedError(self._NO_CACHE)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None, segment_ids=None):
        if cache is not None:
            raise NotImplementedError(self._NO_CACHE)
        key = query if key is None else key
        value = query if value is None else value
        b, sq, _ = query.shape
        shape = (self.num_heads, self.head_dim)
        q = self.q_proj(query).view(b, sq, *shape)
        k = self.k_proj(key).view(b, key.shape[1], *shape)
        v = self.v_proj(value).view(b, value.shape[1], *shape)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training, segment_ids=segment_ids)
        return self.out_proj(out.reshape(b, sq, self.embed_dim))


class TransformerEncoderLayer(nn.Module):
    """Post-LN (``normalize_before=False``) or pre-LN encoder block (ref:
    ``python/paddle/nn/layer/transformer.py``). ``norm1``/``norm2`` keep
    LayerNorm's default eps of 1e-5, as the JAX layer does."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1, activation: str = "relu",
                 attn_dropout: Optional[float] = None,
                 act_dropout: Optional[float] = None,
                 normalize_before: bool = False, **factory):
        super().__init__()
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead,
            attn_dropout if attn_dropout is not None else dropout, **factory)
        self.linear1 = Linear(d_model, dim_feedforward, **factory)
        self.linear2 = Linear(dim_feedforward, d_model, **factory)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5, **factory)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5, **factory)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout_act = Dropout(act_dropout if act_dropout is not None
                                   else dropout)
        # the exact erf GELU, as the JAX package's F.gelu defaults
        self.activation = {"relu": TF.relu, "gelu": TF.gelu}[activation]

    def forward(self, src, src_mask=None, segment_ids=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = self.self_attn(src, attn_mask=src_mask,
                             segment_ids=segment_ids)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout_act(self.activation(
            self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src


class TransformerEncoder(nn.Module):
    """``num_layers`` layers, each made by ``encoder_layer_fn()``, then an
    optional final norm."""

    def __init__(self, encoder_layer_fn: Callable[[], nn.Module],
                 num_layers: int, norm: Optional[nn.Module] = None):
        super().__init__()
        if not callable(encoder_layer_fn):
            raise TypeError("pass a factory: TransformerEncoder(lambda: "
                            "layer, N)")
        self.layers = nn.ModuleList([encoder_layer_fn()
                                     for _ in range(num_layers)])
        self.norm = norm

    def forward(self, src, src_mask=None, segment_ids=None):
        out = src
        for layer in self.layers:
            out = layer(out, src_mask=src_mask, segment_ids=segment_ids)
        if self.norm is not None:
            out = self.norm(out)
        return out


# -- convolution, BatchNorm, pooling, containers (the ResNet path) -----------

def _no_attr(what: str, attr) -> None:
    if attr not in (None, False):
        raise NotImplementedError(f"{what}: ParamAttr objects are not "
                                  f"ported yet (None or False only)")


class Conv2D(nn.Module):
    """ref: ``python/paddle/nn/layer/conv.py`` Conv2D. Weight OIHW ``[out,
    in/groups, kh, kw]``, drawn from U(±1/sqrt(fan_in)) (the JAX layer's
    KaimingUniform with negative slope sqrt(5)); the bias, unless
    ``bias_attr=False``, from the same bound."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, dilation=1, groups: int = 1,
                 padding_mode: str = "zeros", weight_attr=None,
                 bias_attr=None, data_format: str = "NCHW", **factory):
        super().__init__()
        if padding_mode != "zeros":
            raise NotImplementedError(f"padding_mode={padding_mode!r} is "
                                      f"not ported yet ('zeros' only)")
        _no_attr("Conv2D weight_attr", weight_attr)
        _no_attr("Conv2D bias_attr", bias_attr)
        kh, kw = F._pair(kernel_size)
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.groups, self.data_format = groups, data_format
        fan_in = in_channels // groups * kh * kw
        bound = 1 / math.sqrt(fan_in) if fan_in > 0 else 0.0
        self.weight = nn.Parameter(torch.empty(
            (out_channels, in_channels // groups, kh, kw), **factory))
        nn.init.uniform_(self.weight, -bound, bound)
        if bias_attr is not False:
            self.bias = nn.Parameter(torch.empty(out_channels, **factory))
            nn.init.uniform_(self.bias, -bound, bound)
        else:
            self.bias = None

    def forward(self, x):
        # AMP O1 casts a float32 input, weight and bias (JAX
        # nn/layers.py:102-104)
        x, w, b = maybe_cast_input("conv2d", x, self.weight, self.bias)
        return F.conv2d(x, w, b, stride=self.stride,
                        padding=self.padding, dilation=self.dilation,
                        groups=self.groups, data_format=self.data_format)


class _BatchNormBase(nn.Module):
    """BatchNorm over the channel axis of ``data_format``. Weight 1, bias 0;
    the running statistics ``_mean`` (0) and ``_variance`` (1) are float32
    buffers, moved in training as ``0.9 · running + 0.1 · batch`` (Paddle's
    momentum) with the unbiased variance. A training forward *replaces*
    them: after a cast to bf16 they come back float32, as the JAX layer's
    do."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, weight_attr=None, bias_attr=None,
                 data_format: str = "NCHW",
                 use_global_stats: Optional[bool] = None, **factory):
        super().__init__()
        _no_attr("BatchNorm weight_attr", weight_attr)
        _no_attr("BatchNorm bias_attr", bias_attr)
        self.num_features = num_features
        self.momentum, self.epsilon = momentum, epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        self.weight = None if weight_attr is False else nn.Parameter(
            torch.ones(num_features, **factory))
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.zeros(num_features, **factory))
        device = factory.get("device")
        self.register_buffer("_mean", torch.zeros(
            num_features, dtype=torch.float32, device=device))
        self.register_buffer("_variance", torch.ones(
            num_features, dtype=torch.float32, device=device))

    def forward(self, x):
        training = self.training and not (self.use_global_stats or False)
        out, new_mean, new_var = F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=training, momentum=self.momentum,
            epsilon=self.epsilon, data_format=self.data_format)
        if training:
            self._mean = new_mean
            self._variance = new_var
        return out


class BatchNorm2D(_BatchNormBase):
    pass


class MaxPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format: str = "NCHW"):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.padding, self.data_format = padding, data_format

    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                            data_format=self.data_format)


class AdaptiveAvgPool2D(nn.Module):
    def __init__(self, output_size, data_format: str = "NCHW"):
        super().__init__()
        self.output_size, self.data_format = output_size, data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, self.data_format)


class ReLU(nn.Module):
    def forward(self, x):
        return F.relu(x)


class Sequential(nn.Sequential):
    """Sublayers named ``"0"``, ``"1"``, … in order, or by the names of
    ``(name, layer)`` pairs; one list or tuple of them also works, as in
    JAX."""

    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)):
            layers = tuple(layers[0])
        if layers and isinstance(layers[0], tuple):
            super().__init__(OrderedDict(layers))
        else:
            super().__init__(*layers)


class CrossEntropyLoss(nn.Module):
    """``paddle.nn.CrossEntropyLoss``: :func:`~.functional.cross_entropy`
    with the arguments given here (``weight`` a ``[C]`` array or tensor)."""

    def __init__(self, weight=None, ignore_index: int = -100,
                 reduction: str = "mean", soft_label: bool = False,
                 label_smoothing: float = 0.0, axis: int = -1):
        super().__init__()
        self.weight, self.ignore_index = weight, ignore_index
        self.reduction, self.soft_label = reduction, soft_label
        self.label_smoothing, self.axis = label_smoothing, axis

    def forward(self, input, label):
        return F.cross_entropy(input, label, self.weight, self.ignore_index,
                               self.reduction, self.soft_label, self.axis,
                               self.label_smoothing)
