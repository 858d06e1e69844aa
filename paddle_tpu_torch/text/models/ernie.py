"""ERNIE pretraining — ``paddle_tpu/text/models/ernie.py`` on one device.

ERNIE is a BERT-shaped bidirectional encoder with an extra *task-type*
embedding table, and for pretraining a tied-embedding MLM head plus a
sentence-order (SOP) head. BASELINE config 5 trains it through
``PipelineLayer(ernie_pipeline_descs(cfg))``, whose head is an untied MLM
projection. Both forms are here, built from the port's
``nn.TransformerEncoder`` under the JAX attribute names, so state_dict keys
match the JAX keys one for one (``ernie.encoder.layers.0.self_attn.q_proj.
weight``, ``mlm_bias``; ``0.embeddings.word_embeddings.weight``,
``3.block.linear1.weight``, ``13.proj.weight`` in the pipeline). Linear
weights are in PyTorch's ``[out, in]`` layout;
:mod:`paddle_tpu_torch.convert` transposes the JAX matrices.

Attention runs through ``nn.functional.scaled_dot_product_attention``: at
head dim 64 and sequence lengths that are multiples of 128 that is K4 on the
GPU, in the form the JAX package runs for the shape (K4a-direct and
K4b-fused up to 512 keys at 12 heads; the streamed forward, dq and dk/dv at
ERNIE's own 2048-token context), with ``attention_mask`` as an additive key
bias. ERNIE trains at its published dropout (0.1, the defaults): attention
dropout in the kernels (the mask hashed from the position and a seed drawn
from the key stream), hidden dropout from ``torch.Generator`` masks keyed
the same way; ``hidden_dropout=0, attention_dropout=0`` trains as bench.py
does.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as TF
from torch import nn

from ...core.device import resolve_device
from ...nn.functional import cross_entropy
from ...nn.layer import Layer
from ...nn.layers import (Dropout, Linear, TransformerEncoder,
                          TransformerEncoderLayer)
from .bert import init_weights

__all__ = ["ErnieConfig", "Ernie", "ErnieEmbeddings", "ErnieForPretraining",
           "ernie_base", "ernie_tiny", "ernie_pipeline_descs"]


@dataclass
class ErnieConfig:
    vocab_size: int = 40000
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 2048
    type_vocab_size: int = 4
    task_type_vocab_size: int = 3
    use_task_id: bool = True
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_epsilon: float = 1e-12
    initializer_range: float = 0.02


def ernie_base(**overrides) -> ErnieConfig:
    """ernie-3.0-base-zh dimensions."""
    return ErnieConfig(**overrides)


def ernie_tiny(**overrides) -> ErnieConfig:
    return ErnieConfig(**{**dict(vocab_size=1024, hidden_size=128,
                                 num_layers=2, num_heads=4,
                                 intermediate_size=512,
                                 max_position_embeddings=128), **overrides})


class ErnieEmbeddings(Layer):
    """Word + position + token-type (+ task-type) embeddings, LayerNorm,
    dropout."""

    def __init__(self, cfg: ErnieConfig, **factory):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, h, **factory)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                h, **factory)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, h,
                                                  **factory)
        if cfg.use_task_id:
            self.task_type_embeddings = nn.Embedding(
                cfg.task_type_vocab_size, h, **factory)
        self.layer_norm = nn.LayerNorm(h, eps=cfg.layer_norm_epsilon,
                                       **factory)
        self.dropout = Dropout(cfg.hidden_dropout)

    def forward(self, input_ids, token_type_ids=None, task_type_ids=None):
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)[None, :]
        x = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = x + self.token_type_embeddings(token_type_ids)
        if self.cfg.use_task_id:
            if task_type_ids is None:
                task_type_ids = torch.zeros_like(input_ids)
            x = x + self.task_type_embeddings(task_type_ids)
        return self.dropout(self.layer_norm(x))


def _encoder_layer(cfg: ErnieConfig, **factory) -> TransformerEncoderLayer:
    return TransformerEncoderLayer(
        cfg.hidden_size, cfg.num_heads, cfg.intermediate_size,
        dropout=cfg.hidden_dropout, activation="gelu",
        attn_dropout=cfg.attention_dropout, **factory)


class Ernie(Layer):
    def __init__(self, cfg: ErnieConfig, **factory):
        super().__init__()
        self.cfg = cfg
        self.embeddings = ErnieEmbeddings(cfg, **factory)
        self.encoder = TransformerEncoder(
            lambda: _encoder_layer(cfg, **factory), cfg.num_layers)
        self.pooler = Linear(cfg.hidden_size, cfg.hidden_size, **factory)

    def forward(self, input_ids, token_type_ids=None, task_type_ids=None,
                attention_mask=None):
        """``attention_mask`` ``[B, S]`` 1/0 becomes the additive ``[B, 1,
        1, S]`` mask ``(1 - mask) * -1e9`` in the activation dtype, which
        the attention routing turns into K4's key bias."""
        x = self.embeddings(input_ids, token_type_ids, task_type_ids)
        mask = None
        if attention_mask is not None:
            mask = (1.0 - attention_mask[:, None, None, :].to(x.dtype)) * -1e9
        x = self.encoder(x, src_mask=mask)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return x, pooled


class ErnieForPretraining(Layer):
    """ERNIE with the MLM head (tied to the word embeddings, plus the
    trained ``mlm_bias``) and the sentence-order head.

    ``device=None`` builds on ``cuda:0`` and raises without CUDA; pass
    ``device="cpu"`` for the CPU. Weights are drawn from ``seed`` as
    :func:`~.bert.init_weights` says; ``mlm_bias`` starts at zero."""

    def __init__(self, cfg: ErnieConfig, *, device=None,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        factory = dict(device=resolve_device(device), dtype=dtype)
        self.ernie = Ernie(cfg, **factory)
        h = cfg.hidden_size
        self.mlm_transform = Linear(h, h, **factory)
        self.mlm_norm = nn.LayerNorm(h, eps=cfg.layer_norm_epsilon,
                                     **factory)
        # a trainable parameter in the JAX model too
        self.mlm_bias = nn.Parameter(torch.zeros(cfg.vocab_size, **factory))
        self.sop_head = Linear(h, 2, **factory)
        init_weights(self, cfg.initializer_range, seed)

    @property
    def device(self) -> torch.device:
        return self.mlm_bias.device

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                masked_lm_labels=None, sop_labels=None):
        """``(logits [B, S, vocab], sop_logits [B, 2])``, or with
        ``masked_lm_labels`` the pretraining loss: the MLM cross-entropy
        averaged over the labels that are not -100, plus the SOP
        cross-entropy when ``sop_labels`` are given."""
        seq, pooled = self.ernie(input_ids, token_type_ids, None,
                                 attention_mask)
        h = self.mlm_norm(TF.gelu(self.mlm_transform(seq)))
        # a plain product, left to torch.matmul as the JAX package leaves
        # it to XLA
        logits = torch.matmul(
            h, self.ernie.embeddings.word_embeddings.weight.T) + self.mlm_bias
        sop_logits = self.sop_head(pooled)
        if masked_lm_labels is None:
            return logits, sop_logits
        loss = cross_entropy(logits, masked_lm_labels, ignore_index=-100,
                             reduction="mean")
        if sop_labels is not None:
            loss = loss + cross_entropy(sop_logits, sop_labels.reshape(-1),
                                        reduction="mean")
        return loss


class _ErniePipeEmbed(Layer):
    """Stage-0 head for the pipeline: ids -> embedded activations."""

    def __init__(self, cfg: ErnieConfig, seed: int = 0, **factory):
        super().__init__()
        self.embeddings = ErnieEmbeddings(cfg, **factory)
        init_weights(self, cfg.initializer_range, seed)

    def forward(self, input_ids):
        return self.embeddings(input_ids)


class _ErniePipeBlock(Layer):
    def __init__(self, cfg: ErnieConfig, seed: int = 0, **factory):
        super().__init__()
        self.block = _encoder_layer(cfg, **factory)
        init_weights(self, cfg.initializer_range, seed)

    def forward(self, x):
        return self.block(x)


class _ErniePipeHead(Layer):
    """Final transform, norm and the untied MLM projection (pipeline stages
    do not tie to the stage-0 embedding)."""

    def __init__(self, cfg: ErnieConfig, seed: int = 0, **factory):
        super().__init__()
        h = cfg.hidden_size
        self.transform = Linear(h, h, **factory)
        self.norm = nn.LayerNorm(h, eps=cfg.layer_norm_epsilon, **factory)
        self.proj = Linear(h, cfg.vocab_size, **factory)
        init_weights(self, cfg.initializer_range, seed)

    def forward(self, x):
        return self.proj(self.norm(TF.gelu(self.transform(x))))


def ernie_pipeline_descs(cfg: ErnieConfig, *, device=None,
                         dtype: torch.dtype = torch.float32, seed: int = 0):
    """LayerDesc list for ``PipelineLayer`` (BASELINE config 5): the
    embedding head, ``num_layers`` encoder blocks and the MLM tail. Layer
    ``i`` draws its weights from ``seed + i``; ``device=None`` builds on
    ``cuda:0``, as the models do."""
    from ...distributed.fleet.meta_parallel.pp_layers import LayerDesc
    factory = dict(device=resolve_device(device), dtype=dtype)
    descs = [LayerDesc(_ErniePipeEmbed, cfg, seed, **factory)]
    descs += [LayerDesc(_ErniePipeBlock, cfg, seed + 1 + i, **factory)
              for i in range(cfg.num_layers)]
    descs.append(LayerDesc(_ErniePipeHead, cfg, seed + 1 + cfg.num_layers,
                           **factory))
    return descs
