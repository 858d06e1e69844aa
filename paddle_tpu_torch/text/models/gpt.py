"""GPT causal LM — ``paddle_tpu/text/models/gpt.py`` on one device.

Single-device form: ``nn.Linear``, ``nn.LayerNorm`` and ``nn.Embedding``
under the JAX attribute names, so state_dict keys match the JAX keys one
for one (``gpt.h.0.attn.qkv_proj.weight``, …). Weights are in PyTorch's
``[out, in]`` layout; :mod:`paddle_tpu_torch.convert` transposes the JAX
``[in, out]`` matrices. Attention in ``forward`` goes through
:func:`~paddle_tpu_torch.ops.flash_attention` (K1 forward, K2/K3 backward
on the GPU, attention-prob dropout in the kernels), or with
``use_flash_attention=False`` through
:func:`~paddle_tpu_torch.nn.functional.scaled_dot_product_attention` over
repeated KV heads, as the JAX model does; ``decode``/``generate`` use a
dense KV cache and plain attention. ``forward(ids, labels)`` returns the
training loss. Hidden dropout sits where the JAX model has it (after the
embeddings, the attention output and the MLP). With ``recompute`` each
block trains under activation recompute with ``recompute_policy``
(:mod:`paddle_tpu_torch.distributed.fleet.utils.recompute`). The
projections are the port's :class:`~paddle_tpu_torch.nn.Linear`, which
AMP O1 (``amp.auto_cast``) casts; the tied logits product is not cast, as
in JAX. ``sequence_parallel`` and ``context_parallel`` act only under a
mesh in JAX; the port runs on one device without one and computes what
JAX computes there. ``generate`` decodes greedily or samples
(``do_sample`` with ``temperature``, ``top_k``, ``top_p`` and ``seed``) as
the JAX model computes it; the Gumbel noise of each draw comes from
:func:`gumbel_noise` with a ``torch.Generator`` seeded from ``seed``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.device import resolve_device
from ...core.random import torch_generator
from ...distributed.fleet.utils.recompute import recompute
from ...nn import functional as PF
from ...nn.functional import cross_entropy
from ...nn.layer import Layer
from ...nn.layers import Dropout, Linear
from ...ops import flash_attention

__all__ = ["GPTConfig", "GPT", "GPTForCausalLM", "filter_logits",
           "gpt3_1p3b", "gpt_tiny", "gumbel_noise"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 2048
    num_layers: int = 24
    num_heads: int = 16
    # grouped-query attention: fewer KV heads shared by query-head groups
    # (None = MHA); the flash kernel reads shared KV rows without a repeat
    num_kv_heads: Optional[int] = None
    max_position_embeddings: int = 2048
    intermediate_size: Optional[int] = None  # default 4*hidden
    hidden_dropout: float = 0.0
    attention_dropout: float = 0.0
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    use_flash_attention: bool = True
    tie_word_embeddings: bool = True
    # acts under a mesh only (JAX's sequence_parallel_constraint); the
    # port has none, as JAX on one device has none
    sequence_parallel: bool = False
    recompute: bool = False
    # the recompute policy's name (RecomputePolicy) when recompute is on
    recompute_policy: Optional[str] = "dots_and_flash_saveable"
    # None | 'ring' | 'ulysses' over the 'sep' mesh axis: inactive without
    # a mesh, as JAX's _cp_active() is
    context_parallel: Optional[str] = None

    @property
    def ffn_size(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size

    @property
    def kv_heads(self) -> int:
        return (self.num_kv_heads if self.num_kv_heads is not None
                else self.num_heads)


def gpt3_1p3b(**overrides) -> GPTConfig:
    """GPT-3 XL / 1.3B: 24 layers, d=2048, 16 heads."""
    return GPTConfig(**{**dict(hidden_size=2048, num_layers=24, num_heads=16),
                        **overrides})


def gpt_tiny(**overrides) -> GPTConfig:
    return GPTConfig(**{**dict(vocab_size=1024, hidden_size=128, num_layers=2,
                               num_heads=4, max_position_embeddings=256),
                        **overrides})


KVCache = Tuple[torch.Tensor, torch.Tensor]


class GPTAttention(Layer):
    def __init__(self, cfg: GPTConfig, **factory):
        super().__init__()
        self.cfg = cfg
        self.num_heads = cfg.num_heads
        self.kv_heads = cfg.kv_heads
        self.head_dim = cfg.hidden_size // cfg.num_heads
        if self.kv_heads < 1 or self.num_heads % self.kv_heads:
            raise ValueError(
                f"num_heads ({self.num_heads}) must be a multiple of "
                f"num_kv_heads ({self.kv_heads})")
        h = cfg.hidden_size
        if self.kv_heads == self.num_heads:
            self.qkv_proj = Linear(h, 3 * h, **factory)
        else:
            self.q_proj = Linear(h, h, **factory)
            self.kv_proj = Linear(h, 2 * self.kv_heads * self.head_dim,
                                  **factory)
        self.out_proj = Linear(h, h, **factory)
        self.dropout = Dropout(cfg.hidden_dropout)

    def _project_qkv(self, x):
        """-> q [b,s,H,D], k/v [b,s,KH,D]: strided views of the projection,
        which the flash kernel reads without a copy."""
        b, s, _ = x.shape
        if self.kv_heads == self.num_heads:
            qkv = self.qkv_proj(x).view(b, s, 3, self.num_heads,
                                        self.head_dim)
            return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        q = self.q_proj(x).view(b, s, self.num_heads, self.head_dim)
        kv = self.kv_proj(x).view(b, s, 2, self.kv_heads, self.head_dim)
        return q, kv[:, :, 0], kv[:, :, 1]

    def _repeat_kv(self, k, v):
        rep = self.num_heads // self.kv_heads
        if rep == 1:
            return k, v
        return (torch.repeat_interleave(k, rep, dim=2),
                torch.repeat_interleave(v, rep, dim=2))

    def forward(self, x):
        b, s, h = x.shape
        q, k, v = self._project_qkv(x)
        if self.cfg.use_flash_attention:
            # flash handles grouped KV natively and attention-prob dropout
            # in the kernel (JAX gpt.py:184-187)
            out = flash_attention(q, k, v,
                                  dropout=self.cfg.attention_dropout,
                                  causal=True, training=self.training)
        else:
            out = PF.scaled_dot_product_attention(
                q, *self._repeat_kv(k, v), is_causal=True,
                dropout_p=self.cfg.attention_dropout,
                training=self.training)
        return self.dropout(self.out_proj(out.reshape(b, s, h)))

    def decode(self, x, cache: KVCache, offset: int):
        """Incremental attention over a dense KV cache.

        x: [b, s, h] new tokens; cache: (k, v) each [b, max_len, KH, D],
        written in place at ``offset`` (the JAX version returns an updated
        copy); keys past ``offset + s`` and above the intra-block diagonal
        are masked. Returns (out [b, s, h], cache)."""
        b, s, h = x.shape
        q, k, v = self._project_qkv(x)
        k_cache, v_cache = cache
        k_cache[:, offset:offset + s] = k
        v_cache[:, offset:offset + s] = v
        max_len = k_cache.shape[1]
        q_pos = offset + torch.arange(s, device=x.device)
        k_pos = torch.arange(max_len, device=x.device)
        mask = k_pos[None, :] <= q_pos[:, None]               # [s, max]
        kr, vr = self._repeat_kv(k_cache, v_cache)
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) \
            * (1.0 / math.sqrt(self.head_dim))
        scores = scores.masked_fill(~mask, float("-inf"))
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, vr)
        return self.out_proj(out.reshape(b, s, h)), (k_cache, v_cache)


class GPTMLP(Layer):
    def __init__(self, cfg: GPTConfig, **factory):
        super().__init__()
        self.up = Linear(cfg.hidden_size, cfg.ffn_size, **factory)
        self.down = Linear(cfg.ffn_size, cfg.hidden_size, **factory)
        self.dropout = Dropout(cfg.hidden_dropout)

    def forward(self, x):
        return self.dropout(self.down(F.gelu(self.up(x),
                                             approximate="tanh")))


class GPTBlock(Layer):
    """Pre-LN decoder block."""

    def __init__(self, cfg: GPTConfig, **factory):
        super().__init__()
        self.cfg = cfg
        eps = cfg.layer_norm_epsilon
        self.ln_1 = nn.LayerNorm(cfg.hidden_size, eps=eps, **factory)
        self.attn = GPTAttention(cfg, **factory)
        self.ln_2 = nn.LayerNorm(cfg.hidden_size, eps=eps, **factory)
        self.mlp = GPTMLP(cfg, **factory)

    def _inner(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))

    def forward(self, x):
        if self.cfg.recompute and self.training:
            # JAX gpt.py:264-278: the block under jax.checkpoint with the
            # config's policy
            return recompute(self._inner, x,
                             policy=self.cfg.recompute_policy)
        return self._inner(x)

    def decode(self, x, cache: KVCache, offset: int):
        attn_out, cache = self.attn.decode(self.ln_1(x), cache, offset)
        x = x + attn_out
        return x + self.mlp(self.ln_2(x)), cache


class GPT(Layer):
    def __init__(self, cfg: GPTConfig, **factory):
        super().__init__()
        self.cfg = cfg
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **factory)
        self.wpe = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size,
                                **factory)
        self.drop = Dropout(cfg.hidden_dropout)
        self.h = nn.ModuleList([GPTBlock(cfg, **factory)
                                for _ in range(cfg.num_layers)])
        self.ln_f = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_epsilon,
                                 **factory)

    def forward(self, input_ids):
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)[None, :]
        x = self.drop(self.wte(input_ids) + self.wpe(pos))
        for block in self.h:
            x = block(x)
        return self.ln_f(x)

    def init_cache(self, batch: int, max_len: int,
                   dtype: Optional[torch.dtype] = None) -> List[KVCache]:
        w = self.wte.weight
        head_dim = self.cfg.hidden_size // self.cfg.num_heads
        shape = (batch, max_len, self.cfg.kv_heads, head_dim)
        dtype = dtype or w.dtype
        return [(torch.zeros(shape, dtype=dtype, device=w.device),
                 torch.zeros(shape, dtype=dtype, device=w.device))
                for _ in self.h]

    def decode(self, input_ids, caches: List[KVCache], offset: int):
        """Forward with KV caches; ``offset`` = positions already cached.
        Returns (hidden, caches)."""
        s = input_ids.shape[1]
        pos = offset + torch.arange(s, device=input_ids.device)[None, :]
        x = self.wte(input_ids) + self.wpe(pos)
        new_caches = []
        for block, cache in zip(self.h, caches):
            x, cache = block.decode(x, cache, offset)
            new_caches.append(cache)
        return self.ln_f(x), new_caches


def gumbel_noise(shape, dtype: torch.dtype,
                 generator: torch.Generator) -> torch.Tensor:
    """Standard Gumbel noise in ``dtype``, ``-log(-log(u))`` with ``u``
    uniform in ``[tiny, 1)``, as ``jax.random.gumbel`` draws it (the bits
    differ: the draw is the generator's, computed in float32 and rounded
    once, so a 16-bit ``u`` never rounds up to 1). One call a sampled
    token; :meth:`GPTForCausalLM.generate` draws through this module
    attribute, so a test can hand in JAX's draws."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=generator.device)
    u = u * (1.0 - tiny) + tiny
    return (-torch.log(-torch.log(u))).to(dtype)


def filter_logits(logits: torch.Tensor, top_k: int = 0,
                  top_p: float = 1.0) -> torch.Tensor:
    """The JAX model's sampling filters on ``[B, V]`` logits (already
    divided by the temperature), ``-inf`` where a token is cut.

    Top-k keeps every logit ``>=`` the k-th largest, so ties at the k-th
    value all survive. Top-p keeps the logits ``>=`` the sorted logit at
    ``cutoff = sum(cum < top_p)`` over the descending softmax's running
    sum; where no prefix reaches ``top_p`` (float32 rounding with
    ``top_p`` just under 1) the cutoff is past the end, JAX's
    ``take_along_axis`` gives NaN there and nothing is cut, as here."""
    if top_k:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        bar = torch.tensor(top_p, dtype=cum.dtype, device=cum.device)
        idx = (cum < bar).sum(-1, keepdim=True)
        past = idx >= logits.shape[-1]
        cutoff = torch.gather(sorted_logits, -1,
                              idx.clamp(max=logits.shape[-1] - 1))
        cutoff = torch.where(past, float("nan"), cutoff)
        logits = torch.where(logits < cutoff, float("-inf"), logits)
    return logits


class GPTForCausalLM(Layer):
    """GPT with the (optionally tied) LM head.

    ``device=None`` builds on ``cuda:0`` and raises without CUDA; pass
    ``device="cpu"`` for the CPU. Weights are drawn from ``seed`` with a
    ``torch.Generator`` on that device: N(0, initializer_range) for every
    matrix and embedding, zero biases, unit LayerNorm scales, as the JAX
    model initialises them (the draws differ; tests carry weights across
    with :func:`~paddle_tpu_torch.convert.from_jax_state_dict`)."""

    def __init__(self, cfg: GPTConfig, *, device=None,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        factory = dict(device=resolve_device(device), dtype=dtype)
        self.gpt = GPT(cfg, **factory)
        if not cfg.tie_word_embeddings:
            self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size,
                                  bias_attr=False, **factory)
        self.reset_parameters(seed)

    @property
    def device(self) -> torch.device:
        return self.gpt.wte.weight.device

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        std = self.cfg.initializer_range
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                mod.weight.normal_(0.0, std, generator=gen)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()

    def logits(self, hidden):
        if self.cfg.tie_word_embeddings:
            # a plain product, left to torch.matmul as the JAX package
            # leaves it to XLA
            return torch.matmul(hidden, self.gpt.wte.weight.T)
        return self.lm_head(hidden)

    def forward(self, input_ids, labels=None):
        """Logits ``[B, S, vocab]``, or with ``labels`` the training loss:
        the mean over every position of the per-token cross-entropy
        (``reduction="none"``, 0 where the label is -100), as the JAX
        model takes it — ignored positions count in the divisor."""
        logits = self.logits(self.gpt(input_ids))
        if labels is None:
            return logits
        loss = cross_entropy(logits, labels, reduction="none",
                             ignore_index=-100)
        return loss.mean()

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 32,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0,
                 eos_token_id: Optional[int] = None, seed: int = 0):
        """Autoregressive decoding with a dense KV cache, greedy or sampled
        (``do_sample``).

        Each step divides the last position's logits by ``max(temperature,
        1e-6)`` (greedy too, as the JAX model does) and takes the argmax,
        or with ``do_sample`` filters them (:func:`filter_logits`) and
        draws ``argmax(logits + gumbel)``, the categorical draw of
        ``jax.random.categorical``, from :func:`gumbel_noise` on a
        ``torch.Generator`` seeded from ``seed``.

        Returns [b, prompt_len + max_new_tokens] token ids; positions after
        an emitted eos are padded with eos."""
        input_ids = torch.as_tensor(input_ids, device=self.device)
        b, prompt_len = input_ids.shape
        total = prompt_len + max_new_tokens
        if total > self.cfg.max_position_embeddings:
            raise ValueError(
                f"prompt {prompt_len} + max_new_tokens {max_new_tokens} "
                f"exceeds max_position_embeddings "
                f"{self.cfg.max_position_embeddings}")
        if max_new_tokens <= 0:
            return input_ids
        was_training = self.training
        self.eval()
        caches = self.gpt.init_cache(b, total)
        hidden, caches = self.gpt.decode(input_ids, caches, 0)
        gen = torch_generator(seed, self.device) if do_sample else None

        def pick(logits):
            logits = logits / max(temperature, 1e-6)
            if not do_sample:
                return torch.argmax(logits, dim=-1)
            logits = filter_logits(logits, top_k, top_p)
            noise = gumbel_noise(tuple(logits.shape), logits.dtype, gen)
            return torch.argmax(logits + noise.to(logits.device), dim=-1)

        tok = pick(self.logits(hidden[:, -1:])[:, 0])
        finished = (tok == eos_token_id) if eos_token_id is not None \
            else None
        out = [input_ids, tok[:, None]]
        for offset in range(prompt_len, total - 1):
            hidden, caches = self.gpt.decode(tok[:, None], caches, offset)
            tok = pick(self.logits(hidden)[:, 0])
            if finished is not None:
                tok = torch.where(finished, torch.full_like(tok, eos_token_id),
                                  tok)
                finished = finished | (tok == eos_token_id)
            out.append(tok[:, None])
        if was_training:
            self.train()
        return torch.cat(out, dim=1)
