"""BERT pretraining — ``paddle_tpu/text/models/bert.py`` on one device.

Encoder-only transformer with MLM and NSP heads (BASELINE config 3:
BERT-base pretraining under AMP O2), built from the port's
``nn.TransformerEncoder`` under the JAX attribute names, so state_dict keys
match the JAX keys one for one (``bert.encoder.layers.0.self_attn.q_proj.
weight``, ``mlm_bias``, …). Linear weights are in PyTorch's ``[out, in]``
layout; :mod:`paddle_tpu_torch.convert` transposes the JAX matrices.

Attention runs through ``nn.functional.scaled_dot_product_attention``: at
head dim 64 and sequence lengths that are multiples of 128 that is K4 on
the GPU (forward ``flash_packed_fwd``, backward ``flash_packed_bwd``), with
``attention_mask`` as an additive key bias and ``packed_segment_ids`` as
segment ids. BERT trains at its published dropout (0.1, the defaults):
attention dropout in the kernels (the mask hashed from the position and a
seed drawn from the key stream), hidden dropout from ``torch.Generator``
masks keyed the same way; ``hidden_dropout=0, attention_dropout=0`` trains
as bench.py does.
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

__all__ = ["BertConfig", "Bert", "BertForPretraining", "bert_base",
           "bert_tiny"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_epsilon: float = 1e-12
    initializer_range: float = 0.02


def bert_base(**overrides) -> BertConfig:
    return BertConfig(**overrides)


def bert_tiny(**overrides) -> BertConfig:
    return BertConfig(**{**dict(vocab_size=1024, hidden_size=128, num_layers=2,
                                num_heads=4, intermediate_size=512,
                                max_position_embeddings=128), **overrides})


@torch.no_grad()
def init_weights(module: nn.Module, std: float, seed: int) -> None:
    """The JAX models' initialisation, drawn from ``seed`` with a
    ``torch.Generator`` on the module's device: N(0, std) for every Linear
    and embedding matrix, zero biases, unit LayerNorm scales (the draws
    differ from JAX's; tests carry weights across with
    :func:`~paddle_tpu_torch.convert.from_jax_state_dict`)."""
    gen = torch.Generator(device=next(iter(module.parameters())).device)
    gen.manual_seed(seed)
    for mod in module.modules():
        if isinstance(mod, (nn.Linear, nn.Embedding)):
            mod.weight.normal_(0.0, std, generator=gen)
            if getattr(mod, "bias", None) is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()


class BertEmbeddings(Layer):
    def __init__(self, cfg: BertConfig, **factory):
        super().__init__()
        h = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, h, **factory)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                h, **factory)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, h,
                                                  **factory)
        self.layer_norm = nn.LayerNorm(h, eps=cfg.layer_norm_epsilon,
                                       **factory)
        self.dropout = Dropout(cfg.hidden_dropout)

    def forward(self, input_ids, token_type_ids=None):
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)[None, :]
        x = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = x + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(x))


class Bert(Layer):
    def __init__(self, cfg: BertConfig, **factory):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg, **factory)
        self.encoder = TransformerEncoder(
            lambda: TransformerEncoderLayer(
                cfg.hidden_size, cfg.num_heads, cfg.intermediate_size,
                dropout=cfg.hidden_dropout, activation="gelu",
                attn_dropout=cfg.attention_dropout, **factory),
            cfg.num_layers)
        self.pooler = Linear(cfg.hidden_size, cfg.hidden_size, **factory)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                packed_segment_ids=None):
        """``attention_mask`` ``[B, S]`` 1/0 becomes the additive ``[B, 1,
        1, S]`` mask ``(1 - mask) * -1e9`` in the activation dtype, which
        the attention routing turns into K4's key bias.
        ``packed_segment_ids`` ``[B, S]`` int activates packed attention:
        several sequences share a row and attend within their segment."""
        x = self.embeddings(input_ids, token_type_ids)
        mask = None
        if attention_mask is not None:
            mask = (1.0 - attention_mask[:, None, None, :].to(x.dtype)) * -1e9
        x = self.encoder(x, src_mask=mask, segment_ids=packed_segment_ids)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return x, pooled


class BertForPretraining(Layer):
    """BERT with the MLM head (tied to the word embeddings, plus
    ``mlm_bias``) and the NSP head.

    ``device=None`` builds on ``cuda:0`` and raises without CUDA; pass
    ``device="cpu"`` for the CPU. Weights are drawn from ``seed`` with a
    ``torch.Generator`` on that device: N(0, initializer_range) for every
    Linear and embedding matrix, zero biases (``mlm_bias`` included), unit
    LayerNorm scales, as the JAX model initialises them (the draws differ;
    tests carry weights across with
    :func:`~paddle_tpu_torch.convert.from_jax_state_dict`)."""

    def __init__(self, cfg: BertConfig, *, device=None,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        factory = dict(device=resolve_device(device), dtype=dtype)
        self.bert = Bert(cfg, **factory)
        h = cfg.hidden_size
        self.mlm_transform = Linear(h, h, **factory)
        self.mlm_norm = nn.LayerNorm(h, eps=cfg.layer_norm_epsilon,
                                     **factory)
        # a trainable parameter in the JAX model too: in its state_dict
        # and get_params, with a gradient that AdamW applies
        self.mlm_bias = nn.Parameter(torch.zeros(cfg.vocab_size, **factory))
        self.nsp_head = Linear(h, 2, **factory)
        self.reset_parameters(seed)

    @property
    def device(self) -> torch.device:
        return self.mlm_bias.device

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        init_weights(self, self.cfg.initializer_range, seed)
        self.mlm_bias.zero_()

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                masked_lm_labels=None, next_sentence_labels=None,
                packed_segment_ids=None):
        """``(logits [B, S, vocab], nsp_logits [B, 2])``, or with
        ``masked_lm_labels`` the pretraining loss: the MLM cross-entropy
        averaged over the labels that are not -100, plus the NSP
        cross-entropy when ``next_sentence_labels`` are given."""
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask,
                                packed_segment_ids=packed_segment_ids)
        h = self.mlm_norm(TF.gelu(self.mlm_transform(seq)))
        # a plain product, left to torch.matmul as the JAX package leaves
        # it to XLA
        logits = torch.matmul(
            h, self.bert.embeddings.word_embeddings.weight.T) + self.mlm_bias
        nsp_logits = self.nsp_head(pooled)
        if masked_lm_labels is None:
            return logits, nsp_logits
        loss = cross_entropy(logits, masked_lm_labels, ignore_index=-100,
                             reduction="mean")
        if next_sentence_labels is not None:
            loss = loss + cross_entropy(nsp_logits,
                                        next_sentence_labels.reshape(-1),
                                        reduction="mean")
        return loss
