"""Functional ops of the port (``paddle_tpu/nn/functional.py`` counterpart).

So far what the GPT and BERT training paths need: :func:`cross_entropy`
with hard labels, :func:`scaled_dot_product_attention` with its routing to
the attention kernels, and :func:`dropout` at rate 0 or in eval mode.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops._hopper.flash_attention import flash_attention_hopper

__all__ = ["cross_entropy", "dropout", "scaled_dot_product_attention"]


def cross_entropy(input: torch.Tensor, label: torch.Tensor, weight=None,
                  ignore_index: int = -100, reduction: str = "mean",
                  soft_label: bool = False, axis: int = -1,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Softmax cross-entropy over ``axis`` with hard integer labels, as
    ``paddle_tpu.nn.functional.cross_entropy`` computes it: log-softmax in
    float32, the label's log-probability picked by a gather (the JAX code
    takes it through a one-hot), 0 where the label is ``ignore_index``.
    ``reduction`` is ``"none"``, ``"sum"`` or ``"mean"``; the mean divides
    by the number of labels that are not ignored (at least 1).

    ``soft_label``, ``weight`` and ``label_smoothing`` are not ported yet
    and raise."""
    if soft_label or weight is not None or label_smoothing:
        raise NotImplementedError(
            "cross_entropy: soft_label, weight and label_smoothing are not "
            "ported yet (hard labels only)")
    if reduction not in ("none", "sum", "mean"):
        raise ValueError(f"reduction must be 'none', 'sum' or 'mean'; got "
                         f"{reduction!r}")
    logp = torch.log_softmax(input.float(), dim=axis).movedim(axis, -1)
    if label.dim() == input.dim() and label.shape[-1] == 1:
        label = label.squeeze(-1)
    label = label.long()
    valid = label != ignore_index
    picked = torch.gather(logp, -1, torch.where(valid, label, 0)[..., None])
    loss = torch.where(valid, -picked[..., 0], 0.0)
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    return loss.sum() / torch.clamp(valid.sum(), min=1)


def dropout(x: torch.Tensor, p: float = 0.5, training: bool = True
            ) -> torch.Tensor:
    """``x`` itself at rate 0 or in eval mode. Dropout in training draws
    its mask from the JAX step's key stream, which is not ported yet: a
    rate above 0 in training raises."""
    if p > 0.0 and training:
        raise NotImplementedError(
            f"dropout at rate {p} in training is not ported yet "
            f"(ROADMAP Queue 1); use rate 0 or eval mode")
    return x


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
                     scale: float) -> torch.Tensor:
    """The JAX function's dense path: f32 scores, ``-inf`` where a bool
    mask is False or causal masks, a float mask added, softmax rounded to
    the input dtype before the value product."""
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
    ``dropout_p`` above 0 in training raises (not ported yet)."""
    b, sq, h, d = query.shape
    sk = key.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if dropout_p > 0.0 and training:
        raise NotImplementedError(
            "attention-prob dropout is not ported yet (K1's and K4's "
            "dropout option, ROADMAP Queue 1)")
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
                                          segment_ids=seg)
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
            segment_ids_k=seg_k, key_bias=bias)
    return _dense_attention(query, key, value, attn_mask, is_causal, scale)
