"""Flash attention at head dim 64 on Hopper: K4's single-key-tile forms.

Port of ``paddle_tpu/ops/_pallas/flash_attention_packed.py`` where the
whole key sequence fits one tile (``block_k >= seq_k``, Sk <= 512): the
forward ``_fwd_kernel_direct`` (K4a-direct, launched by ``_fwd``) and the
fused backward ``_bwd_fused_kernel`` (K4b-fused, launched by ``_bwd``),
as ``csrc/flash_packed.cu``, built by ``nvcc`` at first use and called
through ``ctypes`` like K1-K3.

The TPU packs G heads on the 128-lane axis to fill its vector registers;
that is the TPU's layout and is not carried over. Both kernels read the
public ``[B, S, H, 64]`` layout through strides, one head per block.

- :func:`flash_packed_fwd` ``-> (o [B, Sq, H, 64], lse [B, H, Sq] f32)``;
- :func:`flash_packed_bwd` ``-> (dq, dk, dv)``, with ``delta = rowsum(do
  * o)`` a torch op here, as ``_bwd`` computes it outside its kernel;
- :func:`flash_attention_packed`, the differentiable public entry.

Masks work as the TPU kernels apply them: the scale, then bottom-right
causal, then segments (``seg_q == seg_k``, else ``NEG_INF``), then the
additive f32 key bias; ``p = exp(s - m) * (s > NEG_INF / 2)``.

On a CUDA tensor each wrapper launches its kernel, or raises on anything
the kernel does not take; each launch adds one to its ``launches``. On a
CPU tensor the plain versions :func:`flash_packed_fwd_reference` and
:func:`flash_packed_bwd_reference` run instead. Nothing falls back from
one to the other. The streamed forms (``_fwd_kernel``, ``_bwd_dq_kernel``,
``_bwd_dkv_kernel``, ``_bwd_dkv_kernel_direct``, for Sk > 512) and dropout
are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .flash_attention import (NEG_INF, _DTYPE_CODE, _bwd_arg_error, _call,
                              _delta, _kernel, _strides, kernel_arg_error)

__all__ = ["flash_attention_packed", "flash_packed_fwd",
           "flash_packed_fwd_reference", "flash_packed_bwd",
           "flash_packed_bwd_reference", "pack_group", "HEAD_D", "MAX_SEQ_K"]

HEAD_D = 64  # the packed path exists for exactly this head dim
MAX_PACK_LANES = 1024
MAX_SEQ_K = 512  # the single key tile of _pick_blocks_packed at dp <= 768
_STREAMED = ("the streamed K4 forms (_fwd_kernel, _bwd_dq_kernel, "
             "_bwd_dkv_kernel, _bwd_dkv_kernel_direct) are not ported yet "
             "(ROADMAP Queue 2)")

Masks = Tuple[Optional[torch.Tensor], Optional[torch.Tensor],
              Optional[torch.Tensor]]


def pack_group(num_heads: int) -> int:
    """Largest even divisor of num_heads whose packed width fits the TPU's
    lane cap; 0 when there is none. The routing keys on it as the JAX
    package does (``flash_attention.py:916``)."""
    best = 0
    for g in range(2, num_heads + 1, 2):
        if num_heads % g == 0 and g * HEAD_D <= MAX_PACK_LANES:
            best = g
    return best


def _shapes(q, k, v):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"packed attention takes [B, S, H, 64] tensors; "
                         f"got q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if d != HEAD_D or k.shape[3] != d:
        raise ValueError(f"packed path is d=64 only; got q {d}, k "
                         f"{k.shape[3]}")
    if k.shape[0] != b or k.shape[2] != h:
        raise ValueError(f"packed path needs kv heads == query heads and "
                         f"one batch; got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    return b, sq, sk, h


def _masks(b, sq, sk, device, segment_ids, segment_ids_k, key_bias
           ) -> Masks:
    """``(seg_q [B, Sq] int32, seg_k [B, Sk] int32, bias [B, Sk] f32)``,
    each dense or None, as ``flash_attention_packed`` (``:776-801``)
    shapes them: ``segment_ids_k`` defaults to ``segment_ids`` when
    Sq == Sk, and the bias becomes float32 only here."""
    seg_q = seg_k = bias = None
    if segment_ids is not None:
        sk_ids = segment_ids_k if segment_ids_k is not None else \
            (segment_ids if sq == sk else None)
        if sk_ids is None:
            raise ValueError("segment_ids_k required when sq != sk")
        seg_q = torch.as_tensor(segment_ids, device=device)
        seg_k = torch.as_tensor(sk_ids, device=device)
        for name, ids, s in (("segment_ids", seg_q, sq),
                             ("segment_ids_k", seg_k, sk)):
            if tuple(ids.shape) != (b, s):
                raise ValueError(f"{name} must be [batch, seq] = "
                                 f"[{b}, {s}]; got {tuple(ids.shape)}")
        seg_q = seg_q.to(torch.int32).contiguous()
        seg_k = seg_k.to(torch.int32).contiguous()
    elif segment_ids_k is not None:
        raise ValueError("segment_ids_k given without segment_ids")
    if key_bias is not None:
        bias = torch.as_tensor(key_bias, device=device)
        if bias.numel() != b * sk:
            raise ValueError(f"key_bias must hold [batch, seq_k] = "
                             f"[{b}, {sk}] values; got {tuple(bias.shape)}")
        bias = bias.to(torch.float32).reshape(b, sk).contiguous()
    return seg_q, seg_k, bias


def _scores(q, k, causal, scale, masks) -> torch.Tensor:
    """f32 scores ``[B, H, Sq, Sk]`` after ``_fwd_kernel_direct``'s masks,
    in its order."""
    seg_q, seg_k, bias = masks
    sq, sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        valid = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
        s = torch.where(torch.tril(valid, diagonal=sk - sq), s, NEG_INF)
    if seg_q is not None:
        same = seg_q[:, None, :, None] == seg_k[:, None, None, :]
        s = torch.where(same, s, NEG_INF)
    if bias is not None:
        s = s + bias[:, None, None, :]
    return s


def flash_packed_fwd_reference(q, k, v, causal: bool = False,
                               scale: Optional[float] = None,
                               masks: Masks = (None, None, None)
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K4a-direct: the same function as the kernel, in
    float32, with its rounding point (p rounded to v's dtype before the
    value product, divided by l after). ``masks`` as :func:`_masks` gives
    them. Returns ``(o [B, Sq, H, 64]`` in q's dtype, ``lse [B, H, Sq]``
    float32)."""
    _shapes(q, k, v)
    scale = 1.0 / math.sqrt(HEAD_D) if scale is None else float(scale)
    s = _scores(q, k, causal, scale, masks)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * (s > NEG_INF / 2)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float()) / l
    lse = (m + torch.log(l))[..., 0]
    return o.transpose(1, 2).to(q.dtype), lse


def flash_packed_bwd_reference(q, k, v, o, lse, do, causal: bool = False,
                               scale: Optional[float] = None,
                               masks: Masks = (None, None, None)
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Plain PyTorch K4b-fused: dq, dk and dv from one recompute of s and
    p, in float32, with ``_bwd_fused_kernel``'s rounding points (``ds`` to
    k's dtype before the dq and dk products, ``p`` to do's dtype before the
    dv product). A row with no valid key gives dq = 0 and adds nothing to
    dk/dv. Returns the gradients in the input dtypes."""
    _shapes(q, k, v)
    scale = 1.0 / math.sqrt(HEAD_D) if scale is None else float(scale)
    delta = _delta(o, do)[..., None]                        # [B, H, Sq, 1]
    s = _scores(q, k, causal, scale, masks)
    p = torch.exp(s - lse.float()[..., None]) * (s > NEG_INF / 2)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = (p * (dp - delta) * scale).to(k.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _kernel_arg_error(q, k, v, masks, do=None) -> Optional[str]:
    """Why the CUDA kernels cannot take these tensors, or None: K1-K3's
    limits on q, k, v (and do), at least one query and one key, and masks
    of the kernels' shapes and types."""
    b, sq, sk, h = _shapes(q, k, v)
    why = kernel_arg_error(q, k, v) if do is None else \
        _bwd_arg_error(q, k, v, do)
    if why is not None:
        return why
    if sq < 1 or sk < 1:
        return f"shape {tuple(q.shape)} has no query or no key"
    seg_q, seg_k, bias = masks
    if (seg_q is None) != (seg_k is None):
        return "segment ids need both seg_q and seg_k"
    for name, t, shape, dtype in (("seg_q", seg_q, (b, sq), torch.int32),
                                  ("seg_k", seg_k, (b, sk), torch.int32),
                                  ("key_bias", bias, (b, sk), torch.float32)):
        if t is not None and (tuple(t.shape) != shape or t.dtype != dtype
                              or t.device != q.device
                              or not t.is_contiguous()):
            return f"{name} must be dense {dtype} {list(shape)} on " \
                   f"{q.device}; got {t.dtype} {list(t.shape)} on {t.device}"
    return None


def _require(q, k, v, masks, what, do=None) -> None:
    if k.shape[1] > MAX_SEQ_K:
        raise NotImplementedError(f"{what} at Sk = {k.shape[1]} > "
                                  f"{MAX_SEQ_K}: {_STREAMED}")
    if q.device.type != "cuda":
        raise ValueError(f"{what} kernel runs on CUDA tensors, not "
                         f"{q.device}")
    why = _kernel_arg_error(q, k, v, masks, do)
    if why is not None:
        raise ValueError(f"{what} kernel cannot take these inputs: {why}")


def _mask_ptrs(masks):
    return [None if t is None else t.data_ptr() for t in masks]


def _launch_fwd(q, k, v, causal: bool, scale: float, masks: Masks):
    """K4a-direct on CUDA tensors: ``(o, lse)``."""
    _require(q, k, v, masks, "flash_packed_fwd")
    lib, fn = _kernel("flash_packed", "paddle_flash_packed_fwd", 8, 9)
    b, sq, sk, h = _shapes(q, k, v)
    o = torch.empty((b, sq, h, HEAD_D), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    _call(lib, fn, "flash_packed_fwd", q, k, q.data_ptr(), k.data_ptr(),
          v.data_ptr(), o.data_ptr(), lse.data_ptr(), *_mask_ptrs(masks),
          b, h, h, sq, sk, HEAD_D, *_strides(q, k, v), float(scale),
          int(bool(causal)), _DTYPE_CODE[q.dtype])
    flash_packed_fwd.launches += 1
    return o, lse


def _launch_bwd(q, k, v, do, lse, delta, causal: bool, scale: float,
                masks: Masks):
    """K4b-fused on CUDA tensors: ``(dq, dk, dv)`` in one launch from
    K4a's lse and ``delta`` (both dense ``[B, H, Sq]`` float32). dq sums
    over the key tiles in a float32 buffer in a fixed order (no atomics),
    so results repeat bit for bit."""
    _require(q, k, v, masks, "flash_packed_bwd", do)
    b, sq, sk, h = _shapes(q, k, v)
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, h, sq) or t.dtype != torch.float32 or \
                not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"flash_packed_bwd: {name} must be dense "
                             f"float32 [{b}, {h}, {sq}] on {q.device}")
    if do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} is not q's shape "
                         f"{tuple(q.shape)}")
    lib, fn = _kernel("flash_packed", "paddle_flash_packed_bwd", 13, 12)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    # the f32 sum of dq over key tiles; in f32 dq itself holds it
    dq_acc = dq if q.dtype == torch.float32 else \
        torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _call(lib, fn, "flash_packed_bwd", q, k, q.data_ptr(), k.data_ptr(),
          v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
          *_mask_ptrs(masks), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
          dq_acc.data_ptr(), b, h, h, sq, sk, HEAD_D,
          *_strides(q, k, v, do), float(scale), int(bool(causal)),
          _DTYPE_CODE[q.dtype])
    flash_packed_bwd.launches += 1
    return dq, dk, dv


def _same_device(*ts) -> torch.device:
    devices = {t.device for t in ts if t is not None}
    if len(devices) != 1:
        raise ValueError(f"packed attention inputs on different devices: "
                         f"{devices}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"packed attention runs on CUDA or the CPU, not "
                         f"{dev}")
    return dev


def flash_packed_fwd(q, k, v, causal: bool = False,
                     scale: Optional[float] = None,
                     masks: Masks = (None, None, None)
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4a-direct: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. Not differentiable itself (:func:`flash_attention_packed`
    is). Returns ``(o [B, Sq, H, 64], lse [B, H, Sq] float32)``."""
    dev = _same_device(q, k, v, *masks)
    scale = 1.0 / math.sqrt(HEAD_D) if scale is None else float(scale)
    if dev.type == "cpu":
        return flash_packed_fwd_reference(q, k, v, causal, scale, masks)
    return _launch_fwd(q, k, v, causal, scale, masks)


def flash_packed_bwd(q, k, v, o, lse, do, causal: bool = False,
                     scale: Optional[float] = None,
                     masks: Masks = (None, None, None)
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4b-fused: the CUDA kernel for CUDA tensors (``delta`` computed
    here by a torch op, as ``_bwd`` does at ``:530-532``), the plain
    version for CPU tensors. ``o`` and ``lse`` are K4a's outputs, ``do``
    the cotangent of ``o``. Returns ``(dq, dk, dv)``, each in its input's
    shape."""
    dev = _same_device(q, k, v, o, lse, do, *masks)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o and do must have q's shape {tuple(q.shape)}; "
                         f"got o {tuple(o.shape)}, do {tuple(do.shape)}")
    scale = 1.0 / math.sqrt(HEAD_D) if scale is None else float(scale)
    if dev.type == "cpu":
        return flash_packed_bwd_reference(q, k, v, o, lse, do, causal,
                                          scale, masks)
    return _launch_bwd(q, k, v, do, lse.float().contiguous(), _delta(o, do),
                       causal, scale, masks)


class _FlashPacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_k, bias, causal, scale):
        masks = (seg_q, seg_k, bias)
        o, lse = flash_packed_fwd(q, k, v, causal, scale, masks)
        ctx.save_for_backward(q, k, v, o, lse, *(
            torch.empty(0) if t is None else t for t in masks))
        ctx.has_mask = tuple(t is not None for t in masks)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, *saved = ctx.saved_tensors
        masks = tuple(t if has else None
                      for t, has in zip(saved, ctx.has_mask))
        if do.stride(-1) != 1:   # e.g. the expanded ones of out.sum()
            do = do.contiguous()
        dq, dk, dv = flash_packed_bwd(q, k, v, o, lse, do, ctx.causal,
                                      ctx.scale, masks)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_packed(query, key, value, causal: bool = False,
                           scale: Optional[float] = None, segment_ids=None,
                           segment_ids_k=None, dropout: float = 0.0,
                           key_bias=None) -> torch.Tensor:
    """``[B, S, H, 64]`` flash attention with the whole key sequence in one
    tile (Sk <= 512): K4a-direct forward, K4b-fused backward. Equal to
    ``flash_attention_pallas`` on d=64 MHA shapes; the JAX package routes
    those here when ``pack_group(H)`` is non-zero. ``segment_ids`` ``[B,
    Sq]`` (and ``segment_ids_k`` ``[B, Sk]``) keep attention within equal
    ids; ``key_bias`` ``[B, Sk]`` is added to every query's scores."""
    b, sq, sk, h = _shapes(query, key, value)
    if not pack_group(h):
        raise ValueError(f"no even pack group divides {h} heads")
    if dropout > 0.0:
        raise NotImplementedError(
            "attention-prob dropout in K4 (the murmur3 mask with "
            "_flat_head numbering) is not ported yet (ROADMAP Queue 1)")
    if sk > MAX_SEQ_K:
        raise NotImplementedError(f"packed attention at Sk = {sk} > "
                                  f"{MAX_SEQ_K}: {_STREAMED}")
    scale = 1.0 / math.sqrt(HEAD_D) if scale is None else float(scale)
    masks = _masks(b, sq, sk, query.device, segment_ids, segment_ids_k,
                   key_bias)
    return _FlashPacked.apply(query, key, value, *masks, bool(causal), scale)


#: kernel launches since each count was last set to 0 (CUDA path only)
flash_packed_fwd.launches = 0
flash_packed_bwd.launches = 0
