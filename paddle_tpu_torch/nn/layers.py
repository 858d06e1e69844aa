"""Transformer encoder layers (``paddle_tpu/nn/layers.py`` counterpart).

:class:`MultiHeadAttention`, :class:`TransformerEncoderLayer` and
:class:`TransformerEncoder` under the JAX attribute names (``q_proj``,
``k_proj``, ``v_proj``, ``out_proj``, ``linear1``, ``linear2``, ``norm1``,
``norm2``, ``layers``), so state_dict keys match the JAX keys one for one.
Linear weights are in PyTorch's ``[out, in]`` layout;
:mod:`paddle_tpu_torch.convert` transposes the JAX ``[in, out]`` matrices.
Attention goes through :func:`~paddle_tpu_torch.nn.functional.
scaled_dot_product_attention`, which routes it to the kernels as the JAX
function does. Decoder caches (``cache``, ``gen_cache``) and dropout in
training are not ported yet and raise.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch.nn.functional as TF
from torch import nn

from . import functional as F

__all__ = ["Dropout", "MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder"]


class Dropout(nn.Module):
    """``paddle.nn.Dropout``: the identity at rate 0 or in eval mode; a
    rate above 0 in training raises (:func:`~.functional.dropout`)."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = float(p)

    def forward(self, x):
        return F.dropout(x, self.p, self.training)


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
        self.q_proj = nn.Linear(embed_dim, embed_dim, **factory)
        self.k_proj = nn.Linear(kdim or embed_dim, embed_dim, **factory)
        self.v_proj = nn.Linear(vdim or embed_dim, embed_dim, **factory)
        self.out_proj = nn.Linear(embed_dim, embed_dim, **factory)

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
        self.linear1 = nn.Linear(d_model, dim_feedforward, **factory)
        self.linear2 = nn.Linear(dim_feedforward, d_model, **factory)
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
