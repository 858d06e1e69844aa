"""Flash attention, ``[batch, seq, heads, head_dim]`` layout.

Port of ``paddle_tpu/ops/flash_attention.py``:

- :func:`flash_attention` routes as the JAX function routes. A head dim
  in ``SUPPORTED_HEAD_DIMS`` (:func:`attention_route`) goes the kernel path
  (``flash_attention_pallas``): K4 for d=64 attention whose heads match and
  whose lengths are multiples of 128, K1 otherwise
  (``_hopper/flash_attention``), the CUDA kernels for CUDA tensors and
  their plain versions for CPU tensors. Any other head dim (``gpt_tiny``'s
  32) goes the dense route, on the CPU and on the card alike, as JAX's
  ``supported_shapes`` sends it to ``reference_attention`` or
  ``_dense_prob_dropout_attention``; ``flash_attention.dense_routes`` counts
  it. Attention-prob dropout in training runs in the kernels on a CUDA
  tensor and in their plain versions, with the same position-hashed mask,
  on a CPU tensor, and through :func:`dropout_keep_dense` on the dense
  route;
- :func:`flash_attn_unpadded` is the varlen entry: packed ``[total, H, D]``
  tokens with ``cu_seqlens`` per side, on the kernel route as one
  ``[1, total, H, D]`` row with per-side segment ids, else JAX's padded
  dense fallback;
- :func:`reference_attention` and :func:`single_query_attention` are the
  plain tensor code of the reference (the serving decode step uses the
  second, as the JAX engine does).

Scores are accumulated in float32 (the JAX code's
``preferred_element_type=float32``), probabilities cast to the input dtype
before the value product, and a row with no valid key gives 0.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..core import random as rng
from ._hopper.flash_attention import (SUPPORTED_HEAD_DIMS, as_dropout,
                                      dropout_keep_dense,
                                      flash_attention_hopper)

__all__ = ["flash_attention", "flash_attn_unpadded", "reference_attention",
           "single_query_attention", "attention_route"]


def _masked_softmax(scores: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis where fully-masked rows (all -inf) give
    0, not NaN — the kernels' masked-row convention."""
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.where(torch.isfinite(scores), torch.exp(scores - m),
                    torch.zeros_like(scores))
    return e / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)


def reference_attention(q, k, v, causal: bool = False,
                        scale: Optional[float] = None,
                        bias: Optional[torch.Tensor] = None, *,
                        keep: Optional[torch.Tensor] = None):
    """Plain attention, f32 softmax. Grouped-query kv (fewer kv heads) is
    repeated per query head; rows with no valid key give 0. ``bias``
    (broadcast to ``[B, H, Sq, Sk]``, optional) is added to the scaled
    scores before the causal mask, as in JAX. ``keep`` (``[B, H, Sq, Sk]``
    f32, optional) multiplies the probabilities before they are cast to the
    input dtype for the value product: with :func:`dropout_keep_dense`'s
    mask this is JAX's ``_dense_prob_dropout_attention``."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if k.shape[2] != h:
        rep = h // k.shape[2]
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        scores = scores + bias
    if causal:
        mask = torch.tril(torch.ones(sq, sk, dtype=torch.bool,
                                     device=q.device), diagonal=sk - sq)
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = _masked_softmax(scores)
    if keep is not None:
        probs = probs * keep
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)


def single_query_attention(q, k, v, lengths=None,
                           scale: Optional[float] = None):
    """Decode-step attention: one query position over gathered KV.

    ``q`` is ``[B, 1, H, D]``; ``k``/``v`` are ``[B, Sk, KH, D]`` with
    ``KH`` dividing ``H`` (query head ``h`` reads kv head ``h // (H //
    KH)`` through a head reshape, no repeated KV). ``lengths`` (``[B]``
    int, optional) masks each row to its first ``lengths[b]`` keys; a row
    with zero valid keys returns 0."""
    b, sq, h, d = q.shape
    if sq != 1:
        raise ValueError(f"single_query_attention needs Sq=1, got {sq}")
    sk, kh = k.shape[1], k.shape[2]
    if h % kh:
        raise ValueError(f"query heads ({h}) not a multiple of kv heads "
                         f"({kh})")
    g = h // kh
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q[:, 0].reshape(b, kh, g, d)
    scores = torch.einsum("bkgd,bskd->bkgs", qg.float(), k.float()) * scale
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=q.device)
        valid = torch.arange(sk, device=q.device)[None, :] < lengths[:, None]
        scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    probs = _masked_softmax(scores).to(q.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v)
    return out.reshape(b, 1, h, d)


def attention_route(query) -> str:
    """Where :func:`flash_attention` sends ``query``: ``"kernels"`` (K1-K4
    through ``flash_attention_hopper``) for a head dim in
    ``SUPPORTED_HEAD_DIMS``, ``"dense"`` for any other. Decided by the head
    dim alone, before any launch, the same on the CPU and on the card, as
    JAX's ``supported_shapes`` decides by head dim (and, for its kernels,
    by lengths that the port's kernels take ragged). JAX's kernels take
    float16, so float16 goes the kernel route too: its plain version on the
    CPU, and on the card the 16-bit bodies, which take float16 as they take
    bf16."""
    return "kernels" if query.shape[-1] in SUPPORTED_HEAD_DIMS else "dense"


def flash_attention(query, key, value, dropout: float = 0.0,
                    causal: bool = False, return_softmax: bool = False, *,
                    scale: Optional[float] = None, training: bool = True,
                    fixed_seed_offset=None):
    """``paddle.nn.functional.flash_attention`` ([B, S, H, D]). On the
    kernel route (:func:`attention_route`) it goes through
    :func:`~._hopper.flash_attention.flash_attention_hopper`, as the JAX
    function goes through ``flash_attention_pallas``: K4 or K1 (the kernel
    on a CUDA tensor, which raises on inputs it does not take, never
    falling back; the plain version on a CPU tensor). On the dense route it
    runs :func:`reference_attention` (:func:`single_query_attention` for one
    query) or, with dropout in training, the dense mirror of the kernels'
    mask, as JAX does off its kernels, and adds one to
    ``flash_attention.dense_routes``. Nothing is caught: the route is
    chosen before any launch.

    ``dropout`` is attention-prob dropout in training, in the kernel: the
    mask is regenerated in the backward from (position, seed).
    ``fixed_seed_offset`` pins the int32 seed; otherwise it is drawn from
    the next key. ``return_softmax`` is not supported, as in JAX."""
    if return_softmax:
        raise NotImplementedError("return_softmax is a debug-only GPU "
                                  "feature")
    drop = dropout > 0.0 and training
    seed = None
    if drop:
        seed = rng.draw_seed() if fixed_seed_offset is None else \
            fixed_seed_offset
    if attention_route(query) == "dense":
        flash_attention.dense_routes += 1
        if drop:
            dr = as_dropout(dropout, seed)
            b, sq, h, _ = query.shape
            keep = dropout_keep_dense(b * h, sq, key.shape[1], dr.seed,
                                      dr.rate, query.device)
            return reference_attention(query, key, value, causal, scale,
                                       keep=keep.reshape(b, h, sq, -1))
        if query.shape[1] == 1:
            return single_query_attention(query, key, value, scale=scale)
        return reference_attention(query, key, value, causal, scale)
    if not drop:
        return flash_attention_hopper(query, key, value, causal=causal,
                                      scale=scale)
    return flash_attention_hopper(query, key, value, causal=causal,
                                  scale=scale, dropout=dropout,
                                  dropout_seed=seed)


#: calls that took the dense route since the count was last set to 0
flash_attention.dense_routes = 0


def _token_index(cu: torch.Tensor, total: int):
    """``(seg, pos, valid)`` of each of ``total`` packed tokens: its
    sequence, its position in it, and whether it lies before ``cu[-1]``
    (tokens past it are padding of the packed dimension)."""
    idx = torch.arange(total, device=cu.device)
    seg = torch.searchsorted(cu, idx, right=True) - 1
    return seg, idx - cu[seg], idx < cu[-1]


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q: int, max_seqlen_k: int,
                        scale: Optional[float] = None, dropout: float = 0.0,
                        causal: bool = False):
    """Varlen attention over packed tokens (JAX ``:186-252``): ``query``
    ``[total_q, H, D]``, ``key``/``value`` ``[total_k, HK, D]``, sequence
    ``i`` of each side its tokens ``cu[i]:cu[i + 1]``.

    - **Fast path** (dropout 0; causal only when ``cu_seqlens_q is
      cu_seqlens_k``, since causality over the packed row is by global
      position): on the kernel route (:func:`attention_route`) the packed
      ``[1, total, H, D]`` row goes through ``flash_attention_hopper`` with
      a segment id a token on each side, JAX's sentinels for tokens past
      ``cu[-1]`` (-1 on the query side, -2 on the key side, so padding
      never matches padding and a padded row comes out 0). On the card
      that is K1 forward and K2/K3 backward (K4 at head dim 64 with equal
      heads and lengths that are multiples of 128, as JAX routes it), on
      the CPU their plain versions; no padding is computed.
    - **Fallback** (otherwise, and off the kernel route): the tokens are
      scattered into ``[B, max_seqlen, H, D]``, the padded keys masked by a
      ``-inf`` bias, :func:`reference_attention` run, and the rows packed
      back, as JAX does. ``dropout`` takes this path, which applies none,
      as in JAX. A token past ``cu_seqlens_q[-1]`` comes out 0, as on the
      fast path (JAX's fallback gathers a clamped row there).
    """
    b = cu_seqlens_q.shape[0] - 1
    total_q, h, d = query.shape
    dev = query.device
    cu_q = torch.as_tensor(cu_seqlens_q, device=dev).long()
    cu_k = torch.as_tensor(cu_seqlens_k, device=dev).long()
    fast_ok = dropout == 0.0 and (not causal or
                                  cu_seqlens_q is cu_seqlens_k)
    if fast_ok and attention_route(query) == "kernels":
        def token_segments(cu, total, pad_sentinel):
            seg, _, valid = _token_index(cu, total)
            return torch.where(valid, seg, pad_sentinel).to(torch.int32)

        out = flash_attention_hopper(
            query[None], key[None], value[None], causal=causal, scale=scale,
            segment_ids=token_segments(cu_q, total_q, -1)[None],
            segment_ids_k=token_segments(cu_k, key.shape[0], -2)[None])
        return out[0]

    def to_padded(x, cu, max_len):
        seg, pos, valid = _token_index(cu, x.shape[0])
        keep = valid & (pos < max_len)
        out = x.new_zeros(b, max_len, x.shape[-2], x.shape[-1])
        return out.index_put((seg[keep], pos[keep]), x[keep])

    qp = to_padded(query, cu_q, max_seqlen_q)
    kp = to_padded(key, cu_k, max_seqlen_k)
    vp = to_padded(value, cu_k, max_seqlen_k)
    lens_q = cu_q[1:] - cu_q[:-1]
    lens_k = cu_k[1:] - cu_k[:-1]
    qmask = torch.arange(max_seqlen_q, device=dev)[None, :] < lens_q[:, None]
    kmask = torch.arange(max_seqlen_k, device=dev)[None, :] < lens_k[:, None]
    bias = torch.where(kmask[:, None, None, :], 0.0, float("-inf"))
    out = reference_attention(qp, kp, vp, causal, scale, bias)
    out = torch.where(qmask[:, :, None, None], out, 0.0).to(query.dtype)
    seg, pos, valid = _token_index(cu_q, total_q)
    rows = torch.nonzero(valid)[:, 0]
    packed = query.new_zeros(total_q, h, d)
    return packed.index_put((rows,), out[seg[rows], pos[rows]])
