"""Layers of the port (``paddle_tpu/nn/layers.py`` counterpart): Linear,
LayerNorm, Embedding, the transformer encoder and decoder layers with
``MultiHeadAttention``'s decoding caches, beam search
(:class:`BeamSearchDecoder`, :func:`dynamic_decode`), the convolution,
BatchNorm (1-D, 2-D, 3-D and the legacy :class:`BatchNorm`), pooling,
padding and container layers of the ResNet path, and
:class:`CrossEntropyLoss`.

Every layer that holds parameters or buffers builds them on ``device``,
resolved as the models resolve it: None is ``cuda:0`` and raises without
CUDA; ``device="cpu"`` builds on the CPU, where the kernels' plain versions
run. Parameters come from :func:`~.layer.create_parameter`, so
``weight_attr``/``bias_attr`` (a :class:`~.layer.ParamAttr`, an
initializer, or ``False`` for none) and the global initializer mean what
they mean in JAX; the defaults are JAX's (Linear ``XavierNormal``, a zero
bias, LayerNorm ones and zeros, Embedding ``Normal(0, 1)``, Conv2D
``KaimingUniform``), drawn from the port's key stream.

The transformer layers keep the JAX attribute names (``q_proj``,
``k_proj``, ``v_proj``, ``out_proj``, ``self_attn``, ``cross_attn``,
``linear1``, ``linear2``, ``norm1``-``norm3``, ``layers``, ``encoder``,
``decoder``), so state_dict keys match the JAX keys one for one. Linear
weights are in PyTorch's ``[out, in]`` layout; :mod:`paddle_tpu_torch.
convert` transposes the JAX ``[in, out]`` matrices. Attention goes through
:func:`~paddle_tpu_torch.nn.functional.scaled_dot_product_attention`, which
routes it to the kernels as the JAX function does, attention-prob dropout
included; hidden dropout (:class:`Dropout`) draws its masks from the key
stream of :mod:`paddle_tpu_torch.core.random`.

:class:`Conv2D` keeps its weight in OIHW ``[out, in/groups, kh, kw]`` as the
JAX layer does (the weights copy across as they are); :class:`BatchNorm2D`
keeps its running statistics in the buffers ``_mean`` and ``_variance``, the
JAX names, so state_dict keys match.
"""

from __future__ import annotations

import collections
import math
from collections import OrderedDict
from typing import Callable, Optional

import torch
import torch.nn.functional as TF
from torch import nn

from ..amp.auto_cast import maybe_cast_input
from ..core.device import resolve_device
from . import functional as F
from . import initializer as I
from .layer import create_parameter

__all__ = ["Linear", "LayerNorm", "Embedding", "Dropout", "Identity",
           "LayerList", "MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer", "BeamSearchDecoder",
           "dynamic_decode", "Conv2D", "BatchNorm", "BatchNorm1D",
           "BatchNorm2D", "BatchNorm3D", "MaxPool2D", "AvgPool2D",
           "AdaptiveAvgPool2D", "Flatten", "Pad2D", "ReLU", "Sequential",
           "CrossEntropyLoss"]


class Linear(nn.Linear):
    """``paddle.nn.Linear``, with the JAX layer's signature and defaults
    (``nn/layers.py:50-67``): the weight drawn in Paddle's ``[in, out]``
    layout (so fans, ``Assign`` values and the key's draw are JAX's) and
    kept transposed, ``[out, in]``, as torch's ``nn.Linear`` keeps it
    (parameters ``weight`` and ``bias``, state_dict keys as before);
    ``bias_attr=False`` means no bias. Its forward first asks AMP whether
    to cast, as the JAX ``Linear`` (``:66-70``) and ``Column/
    RowParallelLinear`` (``mp_layers.py:169, :205``) do: under ``auto_cast``
    O1 a float32 input, weight and bias are cast to the AMP dtype
    (``maybe_cast_input("linear", ...)``); otherwise it is torch's
    ``linear``."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, bias_attr=None, name=None, dtype=None, *,
                 device=None):
        nn.Module.__init__(self)
        device = resolve_device(device)
        self.in_features, self.out_features = in_features, out_features
        w = create_parameter((in_features, out_features), weight_attr,
                             dtype, default_initializer=I.XavierNormal(),
                             device=device)
        self.weight = nn.Parameter(w.detach().t().contiguous(),
                                   requires_grad=w.requires_grad)
        self.weight.param_attr = w.param_attr
        self.bias = None if bias_attr is False else create_parameter(
            (out_features,), bias_attr, dtype, is_bias=True, device=device)

    def forward(self, x):
        x, w, b = maybe_cast_input("linear", x, self.weight, self.bias)
        return TF.linear(x, w, b)


class LayerNorm(nn.LayerNorm):
    """``paddle.nn.LayerNorm`` (``:164-187``): ``epsilon``, ``weight_attr``
    and ``bias_attr`` (``False``: none); weight 1 and bias 0 by default;
    :func:`~.functional.layer_norm` in the forward. A torch ``LayerNorm``
    underneath (parameters ``weight`` and ``bias``), so state_dict keys and
    the models' ``LayerNorm`` resets hold for it."""

    def __init__(self, normalized_shape, epsilon: float = 1e-5,
                 weight_attr=None, bias_attr=None, dtype=None, *,
                 device=None):
        nn.Module.__init__(self)
        device = resolve_device(device)
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = self.eps = epsilon
        self.elementwise_affine = weight_attr is not False
        self.weight = None if weight_attr is False else create_parameter(
            self.normalized_shape, weight_attr, dtype,
            default_initializer=I.Constant(1.0), device=device)
        self.bias = None if bias_attr is False else create_parameter(
            self.normalized_shape, bias_attr, dtype, is_bias=True,
            device=device)

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight,
                            self.bias, self.epsilon)


class Embedding(nn.Module):
    """``paddle.nn.Embedding`` (``:225-242``): weight ``[num, dim]`` from
    ``Normal(0, 1)`` by default, the ``padding_idx`` row zeroed, and
    :func:`~.functional.embedding` in the forward."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx: Optional[int] = None, sparse: bool = False,
                 weight_attr=None, name=None, dtype=None, *, device=None):
        super().__init__()
        self.num_embeddings, self.embedding_dim = num_embeddings, \
            embedding_dim
        self.padding_idx = padding_idx
        self.weight = create_parameter(
            (num_embeddings, embedding_dim), weight_attr, dtype,
            default_initializer=I.Normal(0.0, 1.0), device=device)
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, self.padding_idx)


class Dropout(nn.Module):
    """``paddle.nn.Dropout`` (:func:`~.functional.dropout`): the mask from
    the next key in training; in eval mode the identity, or ``x * (1 - p)``
    in ``downscale_in_infer`` mode."""

    def __init__(self, p: float = 0.5, mode: str = "upscale_in_train"):
        super().__init__()
        self.p, self.mode = float(p), mode

    def forward(self, x):
        return F.dropout(x, self.p, training=self.training, mode=self.mode)


class Identity(nn.Module):
    def forward(self, x):
        return x


class LayerList(nn.ModuleList):
    """``paddle.nn.LayerList``: sublayers named ``"0"``, ``"1"``, ...;
    ``append`` returns the list."""


def _activation(name: str):
    # the exact erf GELU, as the JAX package's F.gelu defaults
    return {"relu": TF.relu, "gelu": TF.gelu, "sigmoid": torch.sigmoid,
            "tanh": torch.tanh}[name]


class MultiHeadAttention(nn.Module):
    """Self- or cross-attention with separate q/k/v projections (ref:
    ``python/paddle/nn/layer/transformer.py``; JAX ``:512-587``). q, k and
    v are views of their projections reshaped to ``[B, S, H, D]``, not
    copies. ``need_weights`` is taken and ignored, as in JAX.

    Decoding caches: :meth:`gen_cache` gives an empty :attr:`Cache` (keys
    and values ``[B, 0, H, D]`` that each step extends) or, with ``type=
    MultiHeadAttention.StaticCache``, the cross-attention keys and values
    projected once. ``forward(..., cache=c)`` returns ``(out, new_cache)``:
    the step's keys and values go after the cached ones; a
    :attr:`StaticCache` is used as it is and returned unchanged."""

    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 kdim: Optional[int] = None, vdim: Optional[int] = None,
                 need_weights: bool = False, weight_attr=None,
                 bias_attr=None, dtype=None, *, device=None):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        device = resolve_device(device)

        def proj(n_in):
            return Linear(n_in, embed_dim, weight_attr, bias_attr,
                          dtype=dtype, device=device)

        self.q_proj = proj(embed_dim)
        self.k_proj = proj(kdim or embed_dim)
        self.v_proj = proj(vdim or embed_dim)
        self.out_proj = proj(embed_dim)

    def _heads(self, x):
        return x.view(x.shape[0], x.shape[1], self.num_heads, self.head_dim)

    def gen_cache(self, key, value=None, type=None):
        if type is MultiHeadAttention.StaticCache:
            value = key if value is None else value
            return MultiHeadAttention.StaticCache(
                self._heads(self.k_proj(key)),
                self._heads(self.v_proj(value)))
        empty = key.new_zeros((key.shape[0], 0, self.num_heads,
                               self.head_dim))
        return MultiHeadAttention.Cache(empty, empty)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None, segment_ids=None):
        key = query if key is None else key
        value = query if value is None else value
        b, sq, _ = query.shape
        q = self._heads(self.q_proj(query))
        if isinstance(cache, MultiHeadAttention.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._heads(self.k_proj(key))
            v = self._heads(self.v_proj(value))
            if cache is not None:
                k = torch.cat([cache[0], k], dim=1)
                v = torch.cat([cache[1], v], dim=1)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training, segment_ids=segment_ids)
        out = self.out_proj(out.reshape(b, sq, self.embed_dim))
        if isinstance(cache, MultiHeadAttention.StaticCache):
            return out, cache
        if cache is not None:
            return out, MultiHeadAttention.Cache(k, v)
        return out


class TransformerEncoderLayer(nn.Module):
    """Post-LN (``normalize_before=False``) or pre-LN encoder block (ref:
    ``python/paddle/nn/layer/transformer.py``). ``norm1``/``norm2`` are
    :class:`LayerNorm` with eps 1e-5, as in the JAX layer; ``dtype`` and
    ``device`` reach every sublayer."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1, activation: str = "relu",
                 attn_dropout: Optional[float] = None,
                 act_dropout: Optional[float] = None,
                 normalize_before: bool = False, weight_attr=None,
                 bias_attr=None, dtype=None, *, device=None):
        super().__init__()
        device = resolve_device(device)
        attrs = dict(weight_attr=weight_attr, bias_attr=bias_attr,
                     dtype=dtype, device=device)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead,
            attn_dropout if attn_dropout is not None else dropout, **attrs)
        self.linear1 = Linear(d_model, dim_feedforward, **attrs)
        self.linear2 = Linear(dim_feedforward, d_model, **attrs)
        self.norm1 = LayerNorm(d_model, dtype=dtype, device=device)
        self.norm2 = LayerNorm(d_model, dtype=dtype, device=device)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout_act = Dropout(act_dropout if act_dropout is not None
                                   else dropout)
        self.activation = _activation(activation)

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


def _stack(layer_fn: Callable[[], nn.Module], num_layers: int, what: str
           ) -> LayerList:
    if not callable(layer_fn):
        raise TypeError(f"pass a factory: {what}(lambda: layer, N)")
    return LayerList([layer_fn() for _ in range(num_layers)])


class TransformerEncoder(nn.Module):
    """``num_layers`` layers, each made by ``encoder_layer_fn()``, then an
    optional final norm."""

    def __init__(self, encoder_layer_fn: Callable[[], nn.Module],
                 num_layers: int, norm: Optional[nn.Module] = None):
        super().__init__()
        self.layers = _stack(encoder_layer_fn, num_layers,
                             "TransformerEncoder")
        self.norm = norm

    def forward(self, src, src_mask=None, segment_ids=None):
        out = src
        for layer in self.layers:
            out = layer(out, src_mask=src_mask, segment_ids=segment_ids)
        if self.norm is not None:
            out = self.norm(out)
        return out


class TransformerDecoderLayer(nn.Module):
    """Masked self-attention, cross-attention over the encoder's memory,
    then the FFN; post-LN or pre-LN (ref ``transformer.py``; JAX
    ``:649-716``). With ``cache`` (from :meth:`gen_cache`, or a previous
    step) the self-attention extends it and the layer returns ``(out,
    new_cache)``."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1, activation: str = "relu",
                 attn_dropout: Optional[float] = None,
                 act_dropout: Optional[float] = None,
                 normalize_before: bool = False, weight_attr=None,
                 bias_attr=None, dtype=None, *, device=None):
        super().__init__()
        device = resolve_device(device)
        attrs = dict(weight_attr=weight_attr, bias_attr=bias_attr,
                     dtype=dtype, device=device)
        self.normalize_before = normalize_before
        ad = attn_dropout if attn_dropout is not None else dropout
        self.self_attn = MultiHeadAttention(d_model, nhead, ad, **attrs)
        self.cross_attn = MultiHeadAttention(d_model, nhead, ad, **attrs)
        self.linear1 = Linear(d_model, dim_feedforward, **attrs)
        self.linear2 = Linear(dim_feedforward, d_model, **attrs)
        self.norm1 = LayerNorm(d_model, dtype=dtype, device=device)
        self.norm2 = LayerNorm(d_model, dtype=dtype, device=device)
        self.norm3 = LayerNorm(d_model, dtype=dtype, device=device)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.dropout_act = Dropout(act_dropout if act_dropout is not None
                                   else dropout)
        self.activation = _activation(activation)

    def gen_cache(self, memory):
        """The self-attention's incremental cache."""
        return self.self_attn.gen_cache(memory)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is not None:
            tgt, new_cache = self.self_attn(tgt, attn_mask=tgt_mask,
                                            cache=cache)
        else:
            tgt = self.self_attn(tgt, attn_mask=tgt_mask)
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        tgt = self.cross_attn(tgt, memory, memory, attn_mask=memory_mask)
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout_act(self.activation(
            self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        if cache is not None:
            return tgt, new_cache
        return tgt


class TransformerDecoder(nn.Module):
    """``num_layers`` layers from ``decoder_layer_fn()``, then an optional
    final norm (JAX ``:719-754``). ``cache`` is one cache a layer; the
    forward then returns ``(out, new_caches)``."""

    def __init__(self, decoder_layer_fn: Callable[[], nn.Module],
                 num_layers: int, norm: Optional[nn.Module] = None):
        super().__init__()
        self.layers = _stack(decoder_layer_fn, num_layers,
                             "TransformerDecoder")
        self.norm = norm

    def gen_cache(self, memory, do_zip: bool = False):
        """One self-attention cache a layer (``do_zip``: their fields
        zipped across the layers)."""
        caches = [layer.gen_cache(memory) for layer in self.layers]
        return list(zip(*caches)) if do_zip else caches

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        out = tgt
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is not None:
                out, c = layer(out, memory, tgt_mask=tgt_mask,
                               memory_mask=memory_mask, cache=cache[i])
                new_caches.append(c)
            else:
                out = layer(out, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask)
        if self.norm is not None:
            out = self.norm(out)
        if cache is not None:
            return out, new_caches
        return out


class Transformer(nn.Module):
    """The encoder-decoder (ref ``transformer.py`` Transformer; JAX
    ``:757-805``): ``num_encoder_layers`` encoder and
    ``num_decoder_layers`` decoder layers, each stack closed by a
    :class:`LayerNorm` in both norm modes (so state_dicts line up), or the
    caller's ``custom_encoder``/``custom_decoder``."""

    def __init__(self, d_model: int = 512, nhead: int = 8,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 dim_feedforward: int = 2048, dropout: float = 0.1,
                 activation: str = "relu", attn_dropout=None,
                 act_dropout=None, normalize_before: bool = False,
                 weight_attr=None, bias_attr=None, custom_encoder=None,
                 custom_decoder=None, *, device=None):
        super().__init__()
        self.d_model, self.nhead = d_model, nhead
        args = (d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
        if custom_encoder is None or custom_decoder is None:
            device = resolve_device(device)
        self.encoder = custom_encoder if custom_encoder is not None else \
            TransformerEncoder(
                lambda: TransformerEncoderLayer(*args, device=device),
                num_encoder_layers, norm=LayerNorm(d_model, device=device))
        self.decoder = custom_decoder if custom_decoder is not None else \
            TransformerDecoder(
                lambda: TransformerDecoderLayer(*args, device=device),
                num_decoder_layers, norm=LayerNorm(d_model, device=device))

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask=src_mask)
        return self.decoder(tgt, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length: int, *, device=None
                                        ) -> torch.Tensor:
        """The causal mask: float32 ``[length, length]``, 0 on and below
        the diagonal, ``-inf`` above (Paddle's additive convention), on
        ``device`` (None: ``cuda:0``, as every entry point)."""
        keep = torch.ones((length, length), dtype=torch.bool,
                          device=resolve_device(device)).tril()
        return torch.zeros(keep.shape, device=keep.device).masked_fill(
            ~keep, float("-inf"))


# -- decoding (ref nn/decode.py BeamSearchDecoder + dynamic_decode) -----------

class BeamSearchDecoder:
    """Wraps a cell, ``cell(inputs, states) -> (logits, new_states)``,
    for beam search by :func:`dynamic_decode` (JAX ``:1937-1950``): the
    cell's batch axis is the beam; ``embedding_fn`` maps token ids to the
    cell's inputs and ``output_fn`` its outputs to logits."""

    def __init__(self, cell, start_token: int, end_token: int,
                 beam_size: int, embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = start_token
        self.end_token = end_token
        self.beam_size = beam_size
        self.embedding_fn = embedding_fn or (lambda ids: ids)
        self.output_fn = output_fn


def _tree_map(fn, tree):
    """``fn`` on each leaf of a tree of lists, tuples, namedtuples and
    dicts (None stays None)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _first_tensor(tree) -> Optional[torch.Tensor]:
    found = []
    _tree_map(lambda t: found.append(t) if isinstance(
        t, torch.Tensor) else None, tree)
    return found[0] if found else None


def dynamic_decode(decoder: BeamSearchDecoder, inits=None,
                   max_step_num: int = 32, **kwargs):
    """Beam search, one source a call with the beams on the cell's batch
    axis (JAX ``:1952-1984``). Scores are float32 log-probabilities, every
    beam but the first starting at -1e30; a finished beam extends only
    with ``end_token``, at no cost; each step keeps the top ``beam_size``
    of the flattened ``[beam, vocab]`` totals, ties to the lower index as
    ``jax.lax.top_k`` breaks them (a stable descending sort: ties are
    common, ``-1e30 + logp`` rounds to -1e30), and gathers every state
    leaf along axis 0 by parent beam. Stops after ``max_step_num`` steps
    or when every beam has finished. Returns ``(ids [beam, steps] int64,
    scores [beam] float32)``, on the device of ``inits``' first tensor
    (else ``kwargs["device"]``, resolved as the entry points resolve
    it)."""
    beam = decoder.beam_size
    first = _first_tensor(inits)
    device = first.device if first is not None else \
        resolve_device(kwargs.get("device"))
    tok = torch.full((beam,), decoder.start_token, dtype=torch.long,
                     device=device)
    states = inits
    scores = torch.full((beam,), -1e30, dtype=torch.float32, device=device)
    scores[0] = 0.0
    seqs = []
    finished = torch.zeros((beam,), dtype=torch.bool, device=device)
    for _ in range(max_step_num):
        logits, states = decoder.cell(decoder.embedding_fn(tok), states)
        if decoder.output_fn is not None:
            logits = decoder.output_fn(logits)
        logp = torch.log_softmax(logits.float(), dim=-1)
        vocab = logp.shape[-1]
        fin_mask = torch.full((vocab,), -1e30, device=device)
        fin_mask[decoder.end_token] = 0.0
        logp = torch.where(finished[:, None], fin_mask[None, :], logp)
        total = (scores[:, None] + logp).reshape(-1)
        top, idx = torch.sort(total, descending=True, stable=True)
        scores, idx = top[:beam], idx[:beam]
        parent = idx // vocab
        tok = idx % vocab
        states = _tree_map(lambda s: s.index_select(0, parent), states)
        seqs = [s.index_select(0, parent) for s in seqs] + [tok]
        finished = finished.index_select(0, parent) | \
            (tok == decoder.end_token)
        if bool(finished.all()):
            break
    return torch.stack(seqs, dim=1), scores


# -- convolution, BatchNorm, pooling, containers (the ResNet path) -----------

class Conv2D(nn.Module):
    """ref: ``python/paddle/nn/layer/conv.py`` Conv2D. Weight OIHW ``[out,
    in/groups, kh, kw]``, by default the JAX layer's KaimingUniform with
    negative slope sqrt(5), U(±1/sqrt(fan_in)); the bias, unless
    ``bias_attr=False``, from the same bound.

    ``padding_mode`` ``"reflect"``, ``"replicate"`` or ``"circular"``
    pads by ``padding`` in that mode (:func:`~.functional.pad`) and then
    convolves with no padding, as Paddle means it. The JAX layer takes the
    argument and zero-pads whatever it says (a fault of the reference,
    ROADMAP Queue 3)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, dilation=1, groups: int = 1,
                 padding_mode: str = "zeros", weight_attr=None,
                 bias_attr=None, data_format: str = "NCHW", dtype=None, *,
                 device=None):
        super().__init__()
        if padding_mode not in ("zeros", "reflect", "replicate", "circular"):
            raise ValueError(f"padding_mode must be 'zeros', 'reflect', "
                             f"'replicate' or 'circular'; got "
                             f"{padding_mode!r}")
        if padding_mode != "zeros" and isinstance(padding, str):
            raise ValueError(f"padding_mode={padding_mode!r} takes integer "
                             f"padding, not {padding!r}")
        self.padding_mode = padding_mode
        device = resolve_device(device)
        kh, kw = F._pair(kernel_size)
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.groups, self.data_format = groups, data_format
        fan_in = in_channels // groups * kh * kw
        self.weight = create_parameter(
            (out_channels, in_channels // groups, kh, kw), weight_attr,
            dtype, default_initializer=I.KaimingUniform(
                fan_in=fan_in, negative_slope=math.sqrt(5),
                nonlinearity="leaky_relu"), device=device)
        bound = 1 / math.sqrt(fan_in) if fan_in > 0 else 0.0
        self.bias = None if bias_attr is False else create_parameter(
            (out_channels,), bias_attr, dtype, is_bias=True,
            default_initializer=I.Uniform(-bound, bound), device=device)

    def forward(self, x):
        # AMP O1 casts a float32 input, weight and bias (JAX
        # nn/layers.py:102-104)
        x, w, b = maybe_cast_input("conv2d", x, self.weight, self.bias)
        padding = self.padding
        if self.padding_mode != "zeros":
            ph, pw = F._pair(padding)
            x = F.pad(x, [pw, pw, ph, ph], mode=self.padding_mode,
                      data_format=self.data_format)
            padding = 0
        return F.conv2d(x, w, b, stride=self.stride,
                        padding=padding, dilation=self.dilation,
                        groups=self.groups, data_format=self.data_format)


class _BatchNormBase(nn.Module):
    """BatchNorm over the channel axis of ``data_format``. Weight 1, bias 0
    by default; the running statistics ``_mean`` (0) and ``_variance`` (1)
    are float32 buffers, moved in training as ``0.9 · running + 0.1 ·
    batch`` (Paddle's momentum) with the unbiased variance. A training
    forward *replaces* them: after a cast to bf16 they come back float32,
    as the JAX layer's do."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, weight_attr=None, bias_attr=None,
                 data_format: str = "NCHW",
                 use_global_stats: Optional[bool] = None, dtype=None, *,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.num_features = num_features
        self.momentum, self.epsilon = momentum, epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        self.weight = None if weight_attr is False else create_parameter(
            (num_features,), weight_attr, dtype,
            default_initializer=I.Constant(1.0), device=device)
        self.bias = None if bias_attr is False else create_parameter(
            (num_features,), bias_attr, dtype, is_bias=True, device=device)
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


class BatchNorm1D(_BatchNormBase):
    """BatchNorm over ``[N, C]`` or ``[N, C, L]``, taken as NCHW with W = 1
    (and L = 1 for ``[N, C]``), as the JAX layer does."""

    def forward(self, x):
        squeeze = x.dim() == 2
        if squeeze:
            x = x[:, :, None]
        out = super().forward(x[..., None])[..., 0]
        return out[:, :, 0] if squeeze else out


class BatchNorm3D(_BatchNormBase):
    """BatchNorm over ``[N, C, D, H, W]`` (the channels on axis 1 under the
    default ``data_format``, as in JAX)."""


class BatchNorm(_BatchNormBase):
    """The legacy ``paddle.nn.BatchNorm``: normalises over every axis but
    the channels (axis 1), then applies ``act`` (``"relu"``, ``"gelu"``,
    ``"sigmoid"``, ``"tanh"``) if given. As in JAX, ``data_layout``,
    ``dtype`` and further keywords are taken and not used; the parameters
    are float32."""

    def __init__(self, num_channels: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, act=None, dtype=None,
                 data_layout: str = "NCHW", *, device=None, **kw):
        super().__init__(num_channels, momentum=momentum, epsilon=epsilon,
                         device=device)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        return _activation(self._act)(out) if self._act else out


class MaxPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format: str = "NCHW"):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.padding, self.data_format = padding, data_format

    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                            data_format=self.data_format)


class AvgPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0,
                 exclusive: bool = True, data_format: str = "NCHW"):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.padding, self.exclusive = padding, exclusive
        self.data_format = data_format

    def forward(self, x):
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding,
                            self.data_format, self.exclusive)


class Flatten(nn.Module):
    """Flattens axes ``start_axis`` to ``stop_axis`` into one."""

    def __init__(self, start_axis: int = 1, stop_axis: int = -1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return torch.flatten(x, self.start_axis % x.dim(),
                             self.stop_axis % x.dim())


class Pad2D(nn.Module):
    def __init__(self, padding, mode: str = "constant", value: float = 0.0,
                 data_format: str = "NCHW"):
        super().__init__()
        self.padding, self.mode, self.value = padding, mode, value
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value,
                     self.data_format)


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
