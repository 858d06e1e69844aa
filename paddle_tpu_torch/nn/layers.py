"""Layers of the port (``paddle_tpu/nn/layers.py`` counterpart): every
public name of the JAX module, each a :class:`~.layer.Layer`.

Linear, LayerNorm, Embedding, the transformer encoder and decoder layers
with ``MultiHeadAttention``'s decoding caches, beam search
(:class:`BeamSearchDecoder`, :func:`dynamic_decode`), the convolutions
(1-D, 2-D, 3-D, transposed), BatchNorm (1-D, 2-D, 3-D, the legacy
:class:`BatchNorm`, :class:`SyncBatchNorm`) and the other norms, pooling,
padding, resizing and container layers (``Sequential``, ``LayerList``,
``ParameterList``, ``LayerDict``), the activation and loss layers over
:mod:`.functional`, :class:`SpectralNorm`, :class:`HSigmoidLoss` and
:class:`RNNTLoss`.

Every layer that holds parameters or buffers builds them on ``device``,
resolved as the models resolve it: None is ``cuda:0`` and raises without
CUDA; ``device="cpu"`` builds on the CPU, where the kernels' plain versions
run. Parameters come from :func:`~.layer.create_parameter`, so
``weight_attr``/``bias_attr`` (a :class:`~.layer.ParamAttr`, an
initializer, or ``False`` for none) and the global initializer mean what
they mean in JAX; the defaults are JAX's (Linear ``XavierNormal``, a zero
bias, LayerNorm ones and zeros, Embedding ``Normal(0, 1)``, the
convolutions ``KaimingUniform``), drawn from the port's key stream.

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
from typing import Callable, Optional

import torch
import torch.nn.functional as TF
from torch import nn

from ..amp.auto_cast import maybe_cast_input
from ..core.device import resolve_device
from . import functional as F
from . import initializer as I
from .layer import Layer, Parameter, create_parameter

__all__ = ["Linear", "LayerNorm", "Embedding", "Dropout", "Identity",
           "LayerList", "MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer", "BeamSearchDecoder",
           "dynamic_decode", "Conv2D", "BatchNorm", "BatchNorm1D",
           "BatchNorm2D", "BatchNorm3D", "MaxPool2D", "AvgPool2D",
           "AdaptiveAvgPool2D", "Flatten", "Pad2D", "ReLU", "Sequential",
           "CrossEntropyLoss"]


class Linear(Layer, nn.Linear):
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
        Layer.__init__(self, dtype=dtype)
        device = resolve_device(device)
        self.in_features, self.out_features = in_features, out_features
        w = create_parameter((in_features, out_features), weight_attr,
                             dtype, default_initializer=I.XavierNormal(),
                             device=device)
        self.weight = Parameter(w.detach().t().contiguous(),
                                w.requires_grad, w.param_attr)
        # kept as the transpose of Paddle's layout (nn.utils reads this)
        self.weight.paddle_transposed = True
        self.bias = None if bias_attr is False else create_parameter(
            (out_features,), bias_attr, dtype, is_bias=True, device=device)

    def forward(self, x):
        x, w, b = maybe_cast_input("linear", x, self.weight, self.bias)
        return TF.linear(x, w, b)


class LayerNorm(Layer, nn.LayerNorm):
    """``paddle.nn.LayerNorm`` (``:164-187``): ``epsilon``, ``weight_attr``
    and ``bias_attr`` (``False``: none); weight 1 and bias 0 by default;
    :func:`~.functional.layer_norm` in the forward. A torch ``LayerNorm``
    underneath (parameters ``weight`` and ``bias``), so state_dict keys and
    the models' ``LayerNorm`` resets hold for it."""

    def __init__(self, normalized_shape, epsilon: float = 1e-5,
                 weight_attr=None, bias_attr=None, dtype=None, *,
                 device=None):
        Layer.__init__(self, dtype=dtype)
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


class Embedding(Layer):
    """``paddle.nn.Embedding`` (``:225-242``): weight ``[num, dim]`` from
    ``Normal(0, 1)`` by default, the ``padding_idx`` row zeroed, and
    :func:`~.functional.embedding` in the forward."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx: Optional[int] = None, sparse: bool = False,
                 weight_attr=None, name=None, dtype=None, *, device=None):
        super().__init__(dtype=dtype)
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


class Dropout(Layer):
    """``paddle.nn.Dropout`` (:func:`~.functional.dropout`): the mask from
    the next key in training; in eval mode the identity, or ``x * (1 - p)``
    in ``downscale_in_infer`` mode. ``name`` is taken and unused, as in
    JAX."""

    def __init__(self, p: float = 0.5, mode: str = "upscale_in_train",
                 name=None):
        super().__init__()
        self.p, self.mode = float(p), mode

    def forward(self, x):
        return F.dropout(x, self.p, training=self.training, mode=self.mode)


class Identity(Layer):
    """The identity; ``Identity(name_scope=, dtype=)`` as ``Layer``."""

    def forward(self, x):
        return x


class LayerList(Layer, nn.ModuleList):
    """``paddle.nn.LayerList``: sublayers named ``"0"``, ``"1"``, ...;
    ``append`` returns the list; ``sublayers()`` and the rest of the
    ``Layer`` API."""

    def __init__(self, sublayers=None):
        Layer.__init__(self)
        if sublayers is not None:
            self.extend(sublayers)


def _activation(name: str):
    # the exact erf GELU, as the JAX package's F.gelu defaults
    return {"relu": TF.relu, "gelu": TF.gelu, "sigmoid": torch.sigmoid,
            "tanh": torch.tanh}[name]


class MultiHeadAttention(Layer):
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
        super().__init__(dtype=dtype)
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


class TransformerEncoderLayer(Layer):
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


class TransformerEncoder(Layer):
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


class TransformerDecoderLayer(Layer):
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


class TransformerDecoder(Layer):
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


class Transformer(Layer):
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


# -- decoding (ref nn/decode.py BeamSearchDecoder + dynamic_decode) ----------

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

class Conv2D(Layer):
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
        super().__init__(dtype=dtype)
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


class _BatchNormBase(Layer):
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
        super().__init__(dtype=dtype)
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


class MaxPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format: str = "NCHW"):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.padding, self.data_format = padding, data_format

    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                            data_format=self.data_format)


class AvgPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 exclusive: bool = True, data_format: str = "NCHW"):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.padding, self.exclusive = padding, exclusive
        self.data_format = data_format

    def forward(self, x):
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding,
                            self.data_format, self.exclusive)


class Flatten(Layer):
    """Flattens axes ``start_axis`` to ``stop_axis`` into one."""

    def __init__(self, start_axis: int = 1, stop_axis: int = -1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return torch.flatten(x, self.start_axis % x.dim(),
                             self.stop_axis % x.dim())


class Pad2D(Layer):
    def __init__(self, padding, mode: str = "constant", value: float = 0.0,
                 data_format: str = "NCHW"):
        super().__init__()
        self.padding, self.mode, self.value = padding, mode, value
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value,
                     self.data_format)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format: str = "NCHW"):
        super().__init__()
        self.output_size, self.data_format = output_size, data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, self.data_format)


class Sequential(Layer, nn.Sequential):
    """Sublayers named ``"0"``, ``"1"``, … in order, or by the names of
    ``(name, layer)`` pairs; one list or tuple of them also works, as in
    JAX."""

    def __init__(self, *layers):
        Layer.__init__(self)
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)):
            layers = tuple(layers[0])
        if layers and isinstance(layers[0], tuple):
            for name, layer in layers:
                self.add_module(name, layer)
        else:
            for i, layer in enumerate(layers):
                self.add_module(str(i), layer)


class CrossEntropyLoss(Layer):
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


# -- the rest of JAX's nn/layers.py ------------------------------------------

def _act_layer(name: str, fn):
    """A layer class calling ``fn(x, *args, **kwargs)`` with the arguments
    it was built with (JAX ``:254-265``)."""
    class _Act(Layer):
        def __init__(self, *a, **k):
            super().__init__()
            self._args, self._kwargs = a, k

        def forward(self, x):
            return fn(x, *self._args, **self._kwargs)

    _Act.__name__ = _Act.__qualname__ = name
    return _Act


ReLU = _act_layer("ReLU", F.relu)
ReLU6 = _act_layer("ReLU6", F.relu6)
GELU = _act_layer("GELU", F.gelu)
Silu = _act_layer("Silu", F.silu)
Sigmoid = _act_layer("Sigmoid", F.sigmoid)
Tanh = _act_layer("Tanh", F.tanh)
Softmax = _act_layer("Softmax", F.softmax)
LeakyReLU = _act_layer("LeakyReLU", F.leaky_relu)
Hardswish = _act_layer("Hardswish", F.hardswish)
Hardsigmoid = _act_layer("Hardsigmoid", F.hardsigmoid)
ELU = _act_layer("ELU", F.elu)
SELU = _act_layer("SELU", F.selu)
CELU = _act_layer("CELU", F.celu)
Hardshrink = _act_layer("Hardshrink", F.hardshrink)
Hardtanh = _act_layer("Hardtanh", F.hardtanh)
Softshrink = _act_layer("Softshrink", F.softshrink)
Softsign = _act_layer("Softsign", F.softsign)
Tanhshrink = _act_layer("Tanhshrink", F.tanhshrink)
ThresholdedReLU = _act_layer("ThresholdedReLU", F.thresholded_relu)
LogSigmoid = _act_layer("LogSigmoid", F.log_sigmoid)
Maxout = _act_layer("Maxout", F.maxout)
Mish = _act_layer("Mish", F.mish)
Softplus = _act_layer("Softplus", F.softplus)
GLU = _act_layer("GLU", F.glu)
LogSoftmax = _act_layer("LogSoftmax", F.log_softmax)


class Swish(Layer):
    def forward(self, x):
        return F.silu(x)


class Softmax2D(Layer):
    """Softmax over the channel axis of ``[N, C, H, W]`` (axis −3)."""

    def forward(self, x):
        return torch.softmax(x, dim=-3)


class PReLU(Layer):
    """Learnable leaky slope: ``num_parameters`` slopes from ``init``."""

    def __init__(self, num_parameters: int = 1, init: float = 0.25,
                 weight_attr=None, data_format: str = "NCHW", *,
                 device=None):
        super().__init__()
        self.data_format = data_format
        self.weight = create_parameter(
            (num_parameters,), weight_attr, None,
            default_initializer=I.Constant(init), device=device)

    def forward(self, x):
        return F.prelu(x, self.weight, self.data_format)


class RReLU(Layer):
    def __init__(self, lower: float = 1. / 8., upper: float = 1. / 3.):
        super().__init__()
        self.lower, self.upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self.lower, self.upper, training=self.training)


# -- norms -------------------------------------------------------------------

class RMSNorm(Layer):
    def __init__(self, hidden_size: int, epsilon: float = 1e-6, dtype=None,
                 *, device=None):
        super().__init__(dtype=dtype)
        self.epsilon = epsilon
        self.weight = create_parameter(
            (hidden_size,), None, dtype,
            default_initializer=I.Constant(1.0), device=device)

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.epsilon)


class GroupNorm(Layer):
    def __init__(self, num_groups: int, num_channels: int,
                 epsilon: float = 1e-5, weight_attr=None, bias_attr=None,
                 data_format: str = "NCHW", dtype=None, *, device=None):
        super().__init__(dtype=dtype)
        self.num_groups, self.epsilon = num_groups, epsilon
        self.data_format = data_format
        self.weight = None if weight_attr is False else create_parameter(
            (num_channels,), weight_attr, dtype,
            default_initializer=I.Constant(1.0), device=device)
        self.bias = None if bias_attr is False else create_parameter(
            (num_channels,), bias_attr, dtype, is_bias=True, device=device)

    def forward(self, x):
        return F.group_norm(x, self.num_groups, self.weight, self.bias,
                            self.epsilon, self.data_format)


class InstanceNorm2D(Layer):
    """Instance norm with the scale ``scale`` (1) and ``bias`` (0), the JAX
    parameter names."""

    def __init__(self, num_features: int, epsilon: float = 1e-5,
                 momentum: float = 0.9, weight_attr=None, bias_attr=None,
                 data_format: str = "NCHW", dtype=None, *, device=None):
        super().__init__(dtype=dtype)
        self.epsilon = epsilon
        self.scale = None if weight_attr is False else create_parameter(
            (num_features,), weight_attr, dtype,
            default_initializer=I.Constant(1.0), device=device)
        self.bias = None if bias_attr is False else create_parameter(
            (num_features,), bias_attr, dtype, is_bias=True,
            default_initializer=I.Constant(0.0), device=device)

    def forward(self, x):
        return F.instance_norm(x, weight=self.scale, bias=self.bias,
                               eps=self.epsilon)


class InstanceNorm1D(InstanceNorm2D):
    """``[N, C, L]``."""


class InstanceNorm3D(InstanceNorm2D):
    """``[N, C, D, H, W]``."""


class LocalResponseNorm(Layer):
    def __init__(self, size: int, alpha: float = 1e-4, beta: float = 0.75,
                 k: float = 1.0, data_format: str = "NCHW"):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k
        self.data_format = data_format

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k, self.data_format)


class SyncBatchNorm(_BatchNormBase):
    """``paddle.nn.SyncBatchNorm``. The port runs on one device, where it
    is :class:`BatchNorm2D`, as JAX's is without a mesh (its statistics
    are global only when the batch axis is sharded)."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """Every BatchNorm sublayer of ``layer`` (not already a
        SyncBatchNorm) swapped for a SyncBatchNorm holding the same
        parameters and running statistics."""
        if isinstance(layer, _BatchNormBase) and not isinstance(
                layer, SyncBatchNorm):
            new = cls(layer.num_features, momentum=layer.momentum,
                      epsilon=layer.epsilon, weight_attr=False,
                      bias_attr=False, data_format=layer.data_format,
                      device=layer._mean.device)
            new.weight, new.bias = layer.weight, layer.bias
            new.register_buffer("_mean", layer._mean)
            new.register_buffer("_variance", layer._variance)
            return new
        for name, sub in list(layer.named_children()):
            setattr(layer, name, cls.convert_sync_batchnorm(sub))
        return layer


class SpectralNorm(Layer):
    """``weight / sigma_max(weight)``: sigma from ``power_iters`` rounds of
    power iteration on the weight viewed as ``[shape[dim], -1]``, with the
    vectors ``weight_u`` and ``weight_v`` kept as buffers (moved in
    training). They start as ``0.1·N(0, 1)`` draws from the key stream
    (JAX draws its own)."""

    def __init__(self, weight_shape, dim: int = 0, power_iters: int = 1,
                 epsilon: float = 1e-12, dtype=None, *, device=None):
        super().__init__()
        self.dim, self.power_iters, self.epsilon = dim, power_iters, epsilon
        h = int(weight_shape[dim])
        w = int(math.prod(weight_shape)) // h
        device = resolve_device(device)
        self.register_buffer("weight_u", I.Normal(0.0, 1.0)(
            (h,), device=device) * 0.1)
        self.register_buffer("weight_v", I.Normal(0.0, 1.0)(
            (w,), device=device) * 0.1)

    def forward(self, weight):
        mat = torch.movedim(weight, self.dim, 0).reshape(
            weight.shape[self.dim], -1)
        u, v = self.weight_u, self.weight_v

        def norm(a):
            return a / (torch.linalg.vector_norm(a) + self.epsilon)

        for _ in range(self.power_iters):
            v = norm(mat.T @ u)
            u = norm(mat @ v)
        sigma = u @ mat @ v
        if self.training:
            self.weight_u, self.weight_v = u.detach(), v.detach()
        return weight / sigma


# -- convolution, pooling, geometry ------------------------------------------

def _conv_weight(layer_shape, fan_in, weight_attr, bias_attr, out_channels,
                 dtype, device):
    """``(weight, bias)`` with JAX's conv defaults: KaimingUniform at slope
    sqrt(5), a bias U(±1/sqrt(fan_in)) unless ``bias_attr`` is False."""
    weight = create_parameter(
        layer_shape, weight_attr, dtype, default_initializer=I.KaimingUniform(
            fan_in=fan_in, negative_slope=math.sqrt(5),
            nonlinearity="leaky_relu"), device=device)
    bound = 1 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    bias = None if bias_attr is False else create_parameter(
        (out_channels,), bias_attr, dtype, is_bias=True,
        default_initializer=I.Uniform(-bound, bound), device=device)
    return weight, bias


class Conv1D(Layer):
    """Weight ``[out, in/groups, k]``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, dilation=1, groups: int = 1,
                 padding_mode: str = "zeros", weight_attr=None,
                 bias_attr=None, data_format: str = "NCL", dtype=None, *,
                 device=None):
        super().__init__(dtype=dtype)
        (k,) = F._ntuple(kernel_size, 1)
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.groups, self.data_format = groups, data_format
        self.weight, self.bias = _conv_weight(
            (out_channels, in_channels // groups, k),
            in_channels // groups * k, weight_attr, bias_attr, out_channels,
            dtype, device)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self.stride,
                        self.padding, self.dilation, self.groups,
                        self.data_format)


class Conv3D(Layer):
    """Weight ``[out, in/groups, kd, kh, kw]``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, dilation=1, groups: int = 1,
                 padding_mode: str = "zeros", weight_attr=None,
                 bias_attr=None, data_format: str = "NCDHW", dtype=None, *,
                 device=None):
        super().__init__(dtype=dtype)
        ks = F._ntuple(kernel_size, 3)
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.groups, self.data_format = groups, data_format
        self.weight, self.bias = _conv_weight(
            (out_channels, in_channels // groups, *ks),
            in_channels // groups * math.prod(ks), weight_attr, bias_attr,
            out_channels, dtype, device)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)


class _ConvTransposeBase(Layer):
    """Weight ``[in, out/groups, *k]`` (Paddle's transposed layout)."""

    def __init__(self, spatial, in_channels, out_channels, kernel_size,
                 stride, padding, output_padding, dilation, groups,
                 weight_attr, bias_attr, data_format, dtype, device):
        super().__init__(dtype=dtype)
        ks = F._ntuple(kernel_size, spatial)
        self.spatial = spatial
        self.stride, self.padding = stride, padding
        self.output_padding, self.dilation = output_padding, dilation
        self.groups, self.data_format = groups, data_format
        self.weight, self.bias = _conv_weight(
            (in_channels, out_channels // groups, *ks),
            in_channels // groups * math.prod(ks), weight_attr, bias_attr,
            out_channels, dtype, device)

    def forward(self, x, output_size=None):
        fn = {1: F.conv1d_transpose, 2: F.conv2d_transpose,
              3: F.conv3d_transpose}[self.spatial]
        return fn(x, self.weight, self.bias, self.stride, self.padding,
                  self.output_padding, self.dilation, self.groups,
                  output_size, data_format=self.data_format)


class Conv1DTranspose(_ConvTransposeBase):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups: int = 1,
                 weight_attr=None, bias_attr=None, data_format: str = "NCL",
                 dtype=None, *, device=None):
        super().__init__(1, in_channels, out_channels, kernel_size, stride,
                         padding, output_padding, dilation, groups,
                         weight_attr, bias_attr, data_format, dtype, device)


class Conv2DTranspose(_ConvTransposeBase):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups: int = 1,
                 weight_attr=None, bias_attr=None,
                 data_format: str = "NCHW", dtype=None, *, device=None):
        super().__init__(2, in_channels, out_channels, kernel_size, stride,
                         padding, output_padding, dilation, groups,
                         weight_attr, bias_attr, data_format, dtype, device)


class Conv3DTranspose(_ConvTransposeBase):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups: int = 1,
                 weight_attr=None, bias_attr=None,
                 data_format: str = "NCDHW", dtype=None, *, device=None):
        super().__init__(3, in_channels, out_channels, kernel_size, stride,
                         padding, output_padding, dilation, groups,
                         weight_attr, bias_attr, data_format, dtype, device)


class _Pool(Layer):
    """A pooling layer: ``fn(x, kernel_size, stride, padding, **extra)``."""

    _fn = None

    def __init__(self, kernel_size, stride=None, padding=0, **extra):
        super().__init__()
        self.kernel_size, self.stride, self.padding = \
            kernel_size, stride, padding
        self._extra = extra

    def forward(self, x):
        return type(self)._fn(x, self.kernel_size, self.stride,
                              self.padding, **self._extra)


class MaxPool1D(_Pool):
    _fn = staticmethod(F.max_pool1d)

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format: str = "NCL"):
        super().__init__(kernel_size, stride, padding,
                         data_format=data_format)


class AvgPool1D(_Pool):
    _fn = staticmethod(F.avg_pool1d)

    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 data_format: str = "NCL"):
        super().__init__(kernel_size, stride, padding, exclusive=exclusive,
                         data_format=data_format)


class MaxPool3D(_Pool):
    _fn = staticmethod(F.max_pool3d)

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format: str = "NCDHW"):
        super().__init__(kernel_size, stride, padding,
                         data_format=data_format)


class AvgPool3D(_Pool):
    _fn = staticmethod(F.avg_pool3d)

    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 data_format: str = "NCDHW"):
        super().__init__(kernel_size, stride, padding,
                         data_format=data_format, exclusive=exclusive)


class MaxUnPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format: str = "NCHW"):
        super().__init__()
        self.kernel_size, self.stride, self.padding = \
            kernel_size, stride, padding
        self.data_format = data_format

    def forward(self, x, indices, output_size=None):
        return F.max_unpool2d(x, indices, self.kernel_size, self.stride,
                              self.padding, output_size, self.data_format)


class MaxUnPool1D(Layer):
    """Scatter by the flat indices of ``max_pool1d``; the output length
    ``(L − 1)·stride + kernel`` unless ``output_size`` (``padding`` taken
    and unused, as in JAX)."""

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format: str = "NCL", output_size=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride or kernel_size
        self.output_size = output_size

    def forward(self, x, indices):
        n, c, length = x.shape
        out_l = self.output_size[-1] if self.output_size else \
            (length - 1) * self.stride + self.kernel_size
        out = x.new_zeros((n * c, out_l)).scatter(
            1, indices.reshape(n * c, length).long(), x.reshape(n * c,
                                                                length))
        return out.reshape(n, c, out_l)


class MaxUnPool3D(Layer):
    """Scatter by flat ``D·H·W`` indices."""

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format: str = "NCDHW", output_size=None):
        super().__init__()
        self.kernel_size = F._ntuple(kernel_size, 3)
        self.stride = F._ntuple(stride, 3) if stride else self.kernel_size
        self.output_size = output_size

    def forward(self, x, indices):
        n, c, d, h, w = x.shape
        if self.output_size:
            od, oh, ow = self.output_size[-3:]
        else:
            od, oh, ow = ((s - 1) * st + k for s, st, k in zip(
                (d, h, w), self.stride, self.kernel_size))
        out = x.new_zeros((n * c, od * oh * ow)).scatter(
            1, indices.reshape(n * c, -1).long(), x.reshape(n * c, -1))
        return out.reshape(n, c, od, oh, ow)


class AdaptiveAvgPool1D(Layer):
    def __init__(self, output_size: int):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveAvgPool3D(Layer):
    def __init__(self, output_size, data_format: str = "NCDHW"):
        super().__init__()
        self.output_size = F._ntuple(output_size, 3)

    def forward(self, x):
        return F.adaptive_avg_pool3d(x, self.output_size)


class _AdaptiveMaxPool(Layer):
    """``return_mask`` is taken and not acted on, as JAX's layers take
    it (the functional form returns the mask)."""

    _nd = 1

    def __init__(self, output_size, return_mask: bool = False):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        from .functional_wave4 import _adaptive_pool, _max
        return _adaptive_pool(x, self.output_size, self._nd, _max)


class AdaptiveMaxPool1D(_AdaptiveMaxPool):
    _nd = 1


class AdaptiveMaxPool2D(_AdaptiveMaxPool):
    _nd = 2


class AdaptiveMaxPool3D(_AdaptiveMaxPool):
    _nd = 3


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 data_format="NCHW"):
        super().__init__()
        self.size, self.scale_factor, self.mode = size, scale_factor, mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None,
                 data_format: str = "NCHW"):
        super().__init__(size, scale_factor, "nearest", data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None,
                 data_format: str = "NCHW"):
        super().__init__(size, scale_factor, "bilinear", data_format)


class _PadNd(Layer):
    """Pads the last ``_spatial`` axes by ``padding`` (last axis first, a
    ``(before, after)`` pair each; an int pads all sides)."""

    _spatial = 1

    def __init__(self, padding, mode: str = "constant", value: float = 0.0,
                 data_format=None):
        super().__init__()
        if isinstance(padding, int):
            padding = [padding] * (2 * self._spatial)
        self.padding, self.mode, self.value = list(padding), mode, value

    def forward(self, x):
        widths = [(0, 0)] * (x.dim() - self._spatial) + list(reversed(
            [(self.padding[2 * i], self.padding[2 * i + 1])
             for i in range(self._spatial)]))
        return F.pad(x, widths, self.mode, self.value)


class Pad1D(_PadNd):
    _spatial = 1


class ZeroPad2D(_PadNd):
    _spatial = 2


class Pad3D(_PadNd):
    _spatial = 3


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1):
        super().__init__()
        self.k, self.s = F._pair(kernel_sizes), F._pair(strides)
        self.p, self.d = F._pair(paddings), F._pair(dilations)

    def forward(self, x):
        return F.unfold(x, self.k, self.s, self.p, self.d)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1):
        super().__init__()
        self.output_sizes, self.kernel_sizes = output_sizes, kernel_sizes
        self.strides, self.paddings, self.dilations = \
            strides, paddings, dilations

    def forward(self, x):
        return F.fold(x, self.output_sizes, self.kernel_sizes, self.strides,
                      self.paddings, self.dilations)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor: int, data_format: str = "NCHW"):
        super().__init__()
        self.upscale_factor, self.data_format = upscale_factor, data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor: int, data_format: str = "NCHW"):
        super().__init__()
        self.downscale_factor = downscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.downscale_factor, self.data_format)


class ChannelShuffle(Layer):
    def __init__(self, groups: int, data_format: str = "NCHW"):
        super().__init__()
        self.groups, self.data_format = groups, data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)


class Unflatten(Layer):
    def __init__(self, axis: int, shape):
        super().__init__()
        self.axis, self.shape = axis, shape

    def forward(self, x):
        return torch.unflatten(x, self.axis, tuple(self.shape))


class Bilinear(Layer):
    """``out[b, o] = x1[b] · W[o] · x2[b] + bias``, weight ``[out, in1,
    in2]``, both from U(±1/sqrt(in1))."""

    def __init__(self, in1_features: int, in2_features: int,
                 out_features: int, weight_attr=None, bias_attr=None,
                 name=None, dtype=None, *, device=None):
        super().__init__(dtype=dtype)
        bound = 1 / math.sqrt(in1_features)
        self.weight = create_parameter(
            (out_features, in1_features, in2_features), weight_attr, dtype,
            default_initializer=I.Uniform(-bound, bound), device=device)
        self.bias = None if bias_attr is False else create_parameter(
            (out_features,), bias_attr, dtype, is_bias=True,
            default_initializer=I.Uniform(-bound, bound), device=device)

    def forward(self, x1, x2):
        out = torch.einsum("bi,oij,bj->bo", x1, self.weight, x2)
        return out + self.bias if self.bias is not None else out


# -- dropouts ----------------------------------------------------------------

class Dropout2D(Layer):
    """Whole feature maps dropped (one draw a sample and channel)."""

    def __init__(self, p: float = 0.5, data_format: str = "NCHW"):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        from .functional_wave4 import dropout2d
        return dropout2d(x, self.p, self.training, self.data_format)


class Dropout3D(Layer):
    def __init__(self, p: float = 0.5, data_format: str = "NCDHW"):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        from .functional_wave4 import dropout3d
        return dropout3d(x, self.p, self.training, self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p

    def forward(self, x):
        from .functional_wave4 import alpha_dropout
        return alpha_dropout(x, self.p, self.training)


# -- distances and containers ------------------------------------------------

class CosineSimilarity(Layer):
    def __init__(self, axis: int = 1, eps: float = 1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


class PairwiseDistance(Layer):
    """``||x − y||_p`` a row, ``epsilon`` added to ``|x − y|`` (JAX's
    layer; the functional form adds it before the absolute value)."""

    def __init__(self, p: float = 2.0, epsilon: float = 1e-6,
                 keepdim: bool = False):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        diff = torch.abs(x - y) + self.epsilon
        if self.p == float("inf"):
            return diff.amax(-1, keepdim=self.keepdim)
        return (diff ** self.p).sum(-1, keepdim=self.keepdim) ** \
            (1.0 / self.p)


class ParameterList(Layer):
    """Parameters named ``"0"``, ``"1"``, ...; ``append`` returns the
    list."""

    def __init__(self, parameters=None):
        super().__init__()
        for p in parameters or ():
            self.append(p)

    def append(self, p):
        self.add_parameter(str(len(self._parameters)), p)
        return self

    def __getitem__(self, idx):
        return self._parameters[str(idx)]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())


class LayerDict(Layer):
    """Sublayers by key, in insertion order."""

    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers:
            self.update(sublayers)

    def __getitem__(self, key):
        return self._modules[key]

    def __setitem__(self, key, sublayer):
        self.add_module(key, sublayer)

    def __delitem__(self, key):
        del self._modules[key]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules)

    def __contains__(self, key):
        return key in self._modules

    def keys(self):
        return self._modules.keys()

    def values(self):
        return self._modules.values()

    def items(self):
        return self._modules.items()

    def update(self, sublayers):
        pairs = sublayers.items() if isinstance(sublayers, dict) \
            else sublayers
        for key, layer in pairs:
            self[key] = layer


# -- losses ------------------------------------------------------------------

def _loss_layer(name: str, fn, arg_names, defaults):
    """A loss layer whose constructor takes ``arg_names`` (with
    ``defaults``) and whose forward is ``fn(*inputs, *those arguments)``."""
    class _Loss(Layer):
        def __init__(self, *args, **kwargs):
            super().__init__()
            vals = dict(zip(arg_names, defaults))
            vals.update(zip(arg_names, args))
            vals.update(kwargs)
            for k, v in vals.items():
                setattr(self, k, v)

        def forward(self, *inputs):
            return fn(*inputs, *(getattr(self, k) for k in arg_names))

    _Loss.__name__ = _Loss.__qualname__ = name
    return _Loss


MSELoss = _loss_layer("MSELoss", F.mse_loss, ("reduction",), ("mean",))
L1Loss = _loss_layer("L1Loss", F.l1_loss, ("reduction",), ("mean",))
NLLLoss = _loss_layer("NLLLoss", F.nll_loss,
                      ("weight", "ignore_index", "reduction"),
                      (None, -100, "mean"))
BCEWithLogitsLoss = _loss_layer(
    "BCEWithLogitsLoss", F.binary_cross_entropy_with_logits,
    ("weight", "reduction", "pos_weight"), (None, "mean", None))
SmoothL1Loss = _loss_layer("SmoothL1Loss", F.smooth_l1_loss,
                           ("reduction", "delta"), ("mean", 1.0))
KLDivLoss = _loss_layer("KLDivLoss", F.kl_div, ("reduction",), ("mean",))
BCELoss = _loss_layer("BCELoss", F.binary_cross_entropy,
                      ("weight", "reduction"), (None, "mean"))
MarginRankingLoss = _loss_layer("MarginRankingLoss", F.margin_ranking_loss,
                                ("margin", "reduction"), (0.0, "mean"))
SoftMarginLoss = _loss_layer("SoftMarginLoss", F.soft_margin_loss,
                             ("reduction",), ("mean",))
TripletMarginLoss = _loss_layer(
    "TripletMarginLoss", F.triplet_margin_loss,
    ("margin", "p", "epsilon", "swap", "reduction"),
    (1.0, 2.0, 1e-6, False, "mean"))
CosineEmbeddingLoss = _loss_layer(
    "CosineEmbeddingLoss", F.cosine_embedding_loss, ("margin", "reduction"),
    (0.0, "mean"))
HingeEmbeddingLoss = _loss_layer(
    "HingeEmbeddingLoss", F.hinge_embedding_loss, ("margin", "reduction"),
    (1.0, "mean"))
PoissonNLLLoss = _loss_layer(
    "PoissonNLLLoss", F.poisson_nll_loss,
    ("log_input", "full", "epsilon", "reduction"),
    (True, False, 1e-8, "mean"))
MultiLabelSoftMarginLoss = _loss_layer(
    "MultiLabelSoftMarginLoss", F.multi_label_soft_margin_loss,
    ("weight", "reduction"), (None, "mean"))


class CTCLoss(Layer):
    def __init__(self, blank: int = 0, reduction: str = "mean"):
        super().__init__()
        self.blank, self.reduction = blank, reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times: bool = False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          self.blank, self.reduction, norm_by_times)


def _reduced(loss, reduction: str):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


class MultiMarginLoss(Layer):
    """``sum_{j≠y} max(0, margin − x[y] + x[j])^p / C``; ``weight`` scales
    each sample by its label's weight."""

    def __init__(self, p: int = 1, margin: float = 1.0, weight=None,
                 reduction: str = "mean"):
        super().__init__()
        self.p, self.margin, self.reduction = p, margin, reduction
        self.weight = weight

    def forward(self, input, label):
        n, c = input.shape
        label = label.long()
        picked = torch.gather(input, 1, label[:, None])
        margins = torch.clamp_min(self.margin - picked + input, 0.0)
        if self.p != 1:
            margins = margins ** self.p
        if self.weight is not None:
            margins = margins * torch.as_tensor(
                self.weight, device=input.device)[label][:, None]
        hit = F.one_hot(label, c, dtype=torch.bool)
        loss = torch.where(hit, 0.0, margins).sum(1) / c
        return _reduced(loss, self.reduction)


class TripletMarginWithDistanceLoss(Layer):
    """The triplet loss over ``distance_function`` (the Euclidean norm of
    the difference by default)."""

    def __init__(self, distance_function=None, margin: float = 1.0,
                 swap: bool = False, reduction: str = "mean"):
        super().__init__()
        self.distance_function = distance_function or (
            lambda a, b: torch.linalg.vector_norm(a - b, dim=-1))
        self.margin, self.swap, self.reduction = margin, swap, reduction

    def forward(self, input, positive, negative):
        dp = self.distance_function(input, positive)
        dn = self.distance_function(input, negative)
        if self.swap:
            dn = torch.minimum(dn, self.distance_function(positive,
                                                          negative))
        return _reduced(torch.clamp_min(dp - dn + self.margin, 0.0),
                        self.reduction)


class GaussianNLLLoss(Layer):
    """``0.5·(log var + (x − mu)²/var)``, ``var`` clipped at ``epsilon``
    (in the inputs' dtype, as JAX's layer computes it)."""

    def __init__(self, full: bool = False, epsilon: float = 1e-6,
                 reduction: str = "mean"):
        super().__init__()
        self.full, self.epsilon, self.reduction = full, epsilon, reduction

    def forward(self, input, label, variance):
        var = torch.clamp_min(variance, self.epsilon)
        loss = 0.5 * (torch.log(var) + (input - label) ** 2 / var)
        if self.full:
            loss = loss + 0.5 * math.log(2 * math.pi)
        return _reduced(loss, self.reduction)


def hsigmoid_paths(num_classes: int):
    """``(paths, codes, valid)`` of every class in the complete binary
    tree (inner node i has children 2i+1 and 2i+2; class c is leaf c +
    C − 1): the inner nodes from the root down, the branch taken (1 for
    right), and which of the ``depth`` slots are used."""
    import numpy as np
    depth = max(1, math.ceil(math.log2(num_classes)))
    paths = np.zeros((num_classes, depth), np.int64)
    codes = np.zeros((num_classes, depth), np.float32)
    valid = np.zeros((num_classes, depth), np.float32)
    for c in range(num_classes):
        node, trail = c + (num_classes - 1), []
        while node > 0:
            parent = (node - 1) // 2
            trail.append((parent, float(node == 2 * parent + 2)))
            node = parent
        for d, (p, code) in enumerate(reversed(trail)):
            if d < depth:
                paths[c, d], codes[c, d], valid[c, d] = p, code, 1.0
    return (torch.from_numpy(paths), torch.from_numpy(codes),
            torch.from_numpy(valid))


def hsigmoid_nll(input, label, weight, bias, paths, codes, valid):
    """The mean over samples of the binary cross-entropies at each inner
    node of the sample's class path, in float32."""
    label = label.reshape(-1).long()
    p, cd, v = paths[label], codes[label], valid[label]
    logits = torch.einsum("nd,ntd->nt", input.float(), weight[p].float())
    if bias is not None:
        logits = logits + bias[p]
    return (-F.log_sigmoid((1.0 - 2.0 * cd) * logits) * v).sum(-1).mean()


class HSigmoidLoss(Layer):
    """Hierarchical sigmoid over a complete binary tree of classes: weight
    ``[C − 1, feature]`` (XavierNormal) and bias ``[C − 1]``; the paths are
    precomputed (``path_table``/``path_code`` taken and unused, as in
    JAX)."""

    def __init__(self, feature_size: int, num_classes: int,
                 weight_attr=None, bias_attr=None, is_custom: bool = False,
                 is_sparse: bool = False, *, device=None):
        super().__init__()
        if num_classes < 2:
            raise ValueError("num_classes must be >= 2")
        device = resolve_device(device)
        self.num_classes = num_classes
        self.weight = create_parameter(
            (num_classes - 1, feature_size), weight_attr, None,
            default_initializer=I.XavierNormal(), device=device)
        self.bias = None if bias_attr is False else create_parameter(
            (num_classes - 1,), bias_attr, None, is_bias=True, device=device)
        for name, t in zip(("_paths", "_codes", "_valid"),
                           hsigmoid_paths(num_classes)):
            self.register_buffer(name, t.to(device), persistable=False)

    def forward(self, input, label, path_table=None, path_code=None):
        return hsigmoid_nll(input, label, self.weight, self.bias,
                            self._paths, self._codes, self._valid)


class RNNTLoss(Layer):
    """The RNN transducer loss as JAX's layer computes it (``:1858-1930``):
    ``acts [B, T, U+1, V]`` logits, log-softmax in float32, the forward
    lattice over ``[T, U+1]`` in log space, ``-(alpha[T−1, U_b] +
    blank[t_b − 1, U_b])`` a sequence. As in JAX the lattice runs to the
    last frame whatever ``input_lengths`` says (the blank term reads the
    sequence's own last frame), and ``fastemit_lambda`` is taken and not
    used."""

    def __init__(self, blank: int = 0, fastemit_lambda: float = 0.0,
                 reduction: str = "mean"):
        super().__init__()
        self.blank, self.reduction = blank, reduction

    def forward(self, acts, labels, input_lengths=None, label_lengths=None):
        logp = torch.log_softmax(acts.float(), dim=-1)
        b, t_max, u1, _ = logp.shape
        u_max = u1 - 1
        blank_lp = logp[..., self.blank]                       # [B, T, U+1]
        lab_lp = torch.gather(logp[:, :, :-1, :], -1, labels.long()[
            :, None, :, None].expand(b, t_max, u_max, 1))[..., 0]
        alpha = None
        for t in range(t_max):
            if t == 0:
                a0 = torch.zeros(b, device=logp.device)
            else:
                a0 = alpha[:, 0] + blank_lp[:, t, 0]
            row = [a0]
            for u in range(1, u_max + 1):
                # JAX's quirk: row t's label inputs are lab[t, :u_max]
                left = row[-1] + lab_lp[:, t, u - 1]
                row.append(left if t == 0 else torch.logaddexp(
                    alpha[:, u] + blank_lp[:, t, u], left))
            alpha = torch.stack(row, dim=1)
        if input_lengths is None:
            input_lengths = torch.full((b,), t_max, dtype=torch.long)
        if label_lengths is None:
            label_lengths = torch.full((b,), u_max, dtype=torch.long)
        il = torch.as_tensor(input_lengths, device=logp.device).long()
        ll = torch.as_tensor(label_lengths, device=logp.device).long()
        rows = torch.arange(b, device=logp.device)
        losses = -(alpha[rows, ll] + blank_lp[rows, il - 1, ll])
        return _reduced(losses, self.reduction)


# the cells' base, under the name JAX's layers module gives it
from .rnn import _RNNCellBase as RNNCellBase  # noqa: E402

__all__ += [
    "RMSNorm", "GroupNorm", "ReLU6", "GELU", "Silu", "Sigmoid", "Tanh",
    "Softmax", "LeakyReLU", "Hardswish", "Hardsigmoid", "ParameterList",
    "Upsample", "MSELoss", "L1Loss", "NLLLoss", "BCEWithLogitsLoss",
    "SmoothL1Loss", "KLDivLoss", "Unfold",
    "ELU", "SELU", "CELU", "Hardshrink", "Hardtanh", "Softshrink",
    "Softsign", "Tanhshrink", "ThresholdedReLU", "LogSigmoid", "Maxout",
    "PReLU", "RReLU", "Mish", "Softplus", "GLU", "LogSoftmax",
    "BCELoss", "MarginRankingLoss", "SoftMarginLoss", "TripletMarginLoss",
    "CosineEmbeddingLoss", "HingeEmbeddingLoss", "PoissonNLLLoss",
    "MultiLabelSoftMarginLoss", "CTCLoss",
    "Conv3D", "Conv2DTranspose", "Conv3DTranspose", "MaxPool3D", "AvgPool3D",
    "MaxUnPool2D", "InstanceNorm2D", "LocalResponseNorm", "PixelShuffle",
    "ChannelShuffle", "Fold", "Dropout2D",
    "Conv1D", "Conv1DTranspose", "MaxPool1D", "AvgPool1D",
    "AdaptiveAvgPool1D", "Bilinear",
    "SyncBatchNorm", "InstanceNorm1D", "InstanceNorm3D", "SpectralNorm",
    "UpsamplingNearest2D", "UpsamplingBilinear2D", "Pad1D", "Pad3D",
    "ZeroPad2D", "CosineSimilarity", "PairwiseDistance", "Dropout3D",
    "AlphaDropout", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
    "AdaptiveMaxPool3D", "AdaptiveAvgPool3D", "Softmax2D", "Swish",
    "PixelUnshuffle", "LayerDict", "MaxUnPool1D", "MaxUnPool3D",
    "MultiMarginLoss", "TripletMarginWithDistanceLoss", "GaussianNLLLoss",
    "HSigmoidLoss", "RNNTLoss", "RNNCellBase", "Unflatten"]
