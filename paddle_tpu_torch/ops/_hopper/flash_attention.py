"""Flash attention on Hopper: K1 (forward), K2 and K3 (backward).

Port of ``paddle_tpu/ops/_pallas/flash_attention.py``: ``_fwd`` driving
``_fwd_kernel`` (K1) and ``_bwd`` driving ``_bwd_dq_kernel`` (K2) and
``_bwd_dkv_kernel`` (K3). The kernels are ``csrc/flash_fwd_tc.cu`` (K1 in
bf16 and float16, on the tensor cores), ``csrc/flash_fwd.cu`` (K1 in
float32, on the CUDA cores: on the tensor cores float32 would mean TF32),
``csrc/flash_bwd_tc.cu`` (K2 and K3 in bf16 and float16 at head dims 64 and
128, on the tensor cores) and ``csrc/flash_bwd.cu`` (K2 and K3 in float32,
and in bf16 and float16 at head dim 256, on the CUDA cores), built by
``nvcc`` at first use
(:mod:`.build`) and called through ``ctypes``. :func:`flash_fwd` picks K1's
body by dtype, :func:`flash_bwd_dq` and :func:`flash_bwd_dkv` K2's and K3's
by dtype and head dim, openly, and each body counts its launches
(``flash_fwd_tc.launches``, ``flash_fwd.launches``,
``flash_bwd_dq_tc.launches``, ``flash_bwd_dq.launches``, and the same for
dkv); nothing falls back from one body to the other.

- ``flash_fwd(q, k, v, causal, scale) -> (o, lse)`` takes the public
  ``[B, S, H, D]`` layout (k/v may have fewer heads, ``HK`` dividing ``H``)
  and returns ``o [B, Sq, H, D]`` in the input dtype and ``lse [B, H, Sq]``
  in float32 — the JAX kernel's ``[B*H, 1, Sq]`` lse, unflattened. It is an
  autograd function: its backward is :func:`flash_bwd`. Its forward is the
  operator ``torch.ops.paddle_tpu_torch.flash_fwd`` (:func:`flash_fwd_op`),
  which activation recompute's policies can save.
  :func:`flash_attention_with_lse` is JAX's entry of that name: the same
  forward with the lse differentiable too, ``[B, Sq, H]``.
- ``flash_bwd(q, k, v, o, lse, do, causal, scale, dlse=None) -> (dq, dk,
  dv)`` in the same layout, dk/dv at ``HK`` heads. ``delta = rowsum(do*o)``
  (minus ``dlse`` when given) is a torch op here, as ``_bwd`` computes it in
  jnp outside its kernels; :func:`flash_bwd_dq` (K2) and
  :func:`flash_bwd_dkv` (K3) launch the kernels, :func:`flash_bwd_dq_tc`
  and :func:`flash_bwd_dkv_tc` their tensor-core bodies alone.

K1-K3 take the TPU kernels' masks (``masks=(seg_q, seg_k, bias)``, each
dense or None: segment ids ``[B, Sq]`` and ``[B, Sk]`` int32 and an f32 key
bias ``[B, Sk]``, per batch row and shared by its heads) in their order:
the scale, then bottom-right causal, then segments (``seg_q == seg_k``,
else ``NEG_INF``), then ``+ bias``. A masked score stays masked under a
finite bias, a row with no valid key gives o = 0, lse = NEG_INF + log
1e-30 and dq = 0, and a ``-inf`` bias gives no NaN: the row max starts at
``NEG_INF``. The bias is a mask and gets no gradient.

Attention-prob dropout (``dropout=AttnDropout(rate, seed)``) is the TPU
kernels' own: a murmur3 hash of the flat score index ``(b*H + h)*Sq*Sk +
q*Sk + k`` (uint32, wrapping), xor the seed, drops a probability where it
falls below ``keep_threshold(rate)``; a kept one is scaled by
``keep_scale(rate)``. The softmax denominator uses the undropped p, the PV
sum ``p * keep``; the backward applies ``keep`` to ``dp`` and ``p * keep``
to dv, so forward and backward regenerate one mask from ``(position,
seed)``. :func:`dropout_keep_dense` is the JAX function of that name in
torch; the attention sources share ``csrc/dropout.cuh``.

On a CUDA tensor each wrapper launches its kernel, or raises on anything
the kernel does not take (head dim outside {64, 128, 256}, a dtype other
than float32, bfloat16 or float16 (JAX's kernels take float16 as they take
bf16, and the 16-bit bodies are one template over the two), a last
dimension that is not dense, 16-bit rows not 16-byte aligned); each launch
adds one to the wrapper's ``launches``. On a CPU tensor
:func:`flash_fwd_reference` and :func:`flash_bwd_reference`, the plain
PyTorch versions of the same functions, run instead. Nothing falls back
from one to the other.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from ...core import random as rng
from . import KernelLaunchError

__all__ = ["flash_fwd", "flash_fwd_tc", "flash_fwd_reference", "flash_bwd",
           "flash_bwd_reference", "flash_bwd_dq", "flash_bwd_dkv",
           "flash_bwd_dq_tc", "flash_bwd_dkv_tc", "TC_BWD_HEAD_DIMS",
           "flash_fwd_op", "flash_attention_with_lse",
           "mma_dot",
           "kernel_arg_error", "NEG_INF", "SUPPORTED_HEAD_DIMS",
           "AttnDropout", "keep_threshold", "keep_scale",
           "dropout_keep_dense", "Masks", "NO_MASKS", "TC_KEY_TILE",
           "TC_DTYPES",
           "CUDA_CORE_KEY_TILE", "kernel_key_tile", "require_aligned_rows",
           "tune_flash_blocks"]

NEG_INF = -1e30  # the TPU kernel's masked score, kept for its lse convention
SUPPORTED_HEAD_DIMS = (64, 128, 256)
#: keys a stage of the 16-bit tensor-core body (csrc/flash_fwd_tc.cu) takes,
#: by head dim: the points where it rounds p (the body reports its own,
#: paddle_flash_fwd_tc_stage, and chip_smoke.py holds the two equal)
TC_KEY_TILE = {64: 128, 128: 128, 256: 64}
#: head dims whose bf16 and float16 K2/K3 run on the tensor-core bodies
#: (csrc/flash_bwd_tc.cu); 16 bits at 256 and float32 stay on flash_bwd.cu
TC_BWD_HEAD_DIMS = (64, 128)
#: keys a tile of the float32 CUDA-core bodies (flash_fwd.cu,
#: flash_packed_stream.cu) takes
CUDA_CORE_KEY_TILE = 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the types the tensor-core bodies take (mma.cuh's element trait)
TC_DTYPES = (torch.bfloat16, torch.float16)

#: ``(seg_q [B, Sq] int32, seg_k [B, Sk] int32, bias [B, Sk] f32)``, each
#: dense or None
Masks = Tuple[Optional[torch.Tensor], Optional[torch.Tensor],
              Optional[torch.Tensor]]
NO_MASKS: Masks = (None, None, None)


# ---------------------------------------------------------------------------
# Attention-prob dropout: the TPU kernels' position hash
# (_pallas/flash_attention.py:125-168, flash_attention_packed.py:96-99)
# ---------------------------------------------------------------------------

class AttnDropout(NamedTuple):
    """K1-K4's dropout option: ``rate`` and the int32 ``seed`` of the
    hash."""
    rate: float
    seed: int


_M32 = 0xFFFFFFFF


def keep_threshold(rate: float) -> int:
    """uint32 threshold, computed as JAX computes it: a hash below it
    drops (P = rate)."""
    return min(int(rate * 4294967296.0), 4294967295)


def keep_scale(rate: float) -> float:
    """The factor of a kept probability, ``float32(1 / (1 - rate))``."""
    return torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32).item()


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for int64 ``x`` in [0, 2^32): in 16-bit halves of
    ``c``, so no product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's finalizer on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _keep_factor(bh, q_pos, k_pos, seq_q: int, seq_k: int, seed: int,
                 rate: float) -> torch.Tensor:
    """f32 keep factors of the scores at broadcastable int64 ``(bh, q_pos,
    k_pos)``: 0 where dropped, ``keep_scale(rate)`` where kept. The flat
    index wraps at 2^32 as ``jnp.uint32`` does, and the seed enters as the
    bits of an int32."""
    idx = ((((bh * seq_q + q_pos) & _M32) * seq_k + k_pos) & _M32)
    keep = _mix32(idx ^ (int(seed) & _M32)) >= keep_threshold(rate)
    return keep.to(torch.float32) * keep_scale(rate)


def dropout_keep_dense(bh: int, sq: int, sk: int, seed: int, rate: float,
                       device=None, first_head: int = 0) -> torch.Tensor:
    """``[bh, sq, sk]`` f32 keep factors of head rows ``first_head ..
    first_head + bh - 1``: JAX's ``dropout_keep_dense`` (``first_head = 0``),
    built a few heads at a time so the int64 hash stays small."""
    out = torch.empty((bh, sq, sk), dtype=torch.float32, device=device)
    q_pos = torch.arange(sq, device=device)[None, :, None]
    k_pos = torch.arange(sk, device=device)[None, None, :]
    step = max(1, (1 << 24) // max(1, sq * sk))
    for h0 in range(0, bh, step):
        rows = torch.arange(first_head + h0, first_head + min(bh, h0 + step),
                            device=device)[:, None, None]
        out[h0:h0 + step] = _keep_factor(rows, q_pos, k_pos, sq, sk, seed,
                                         rate)
    return out


def _keep(dropout: Optional[AttnDropout], b: int, h: int, sq: int, sk: int,
          device, first_head: int = 0) -> Optional[torch.Tensor]:
    """``[B, H, Sq, Sk]`` keep factors of ``dropout`` (None without), of
    the flat heads from ``first_head`` on."""
    if dropout is None:
        return None
    return dropout_keep_dense(b * h, sq, sk, dropout.seed, dropout.rate,
                              device, first_head).reshape(b, h, sq, sk)


def _dropout_args(dropout: Optional[AttnDropout]):
    """The kernels' four dropout arguments: on, threshold, seed bits, keep
    scale."""
    if dropout is None:
        return [0, 0, 0, 1.0]
    return [1, keep_threshold(dropout.rate), int(dropout.seed) & _M32,
            keep_scale(dropout.rate)]


def as_dropout(rate: float, seed) -> Optional[AttnDropout]:
    """``AttnDropout(rate, seed)``, or None at rate 0. ``seed`` None draws
    one from the next key (``flash_attention_pallas``'s ``randint(next_key(),
    ...)``); a tensor or array seed gives its one int32 value."""
    if not rate > 0.0:
        return None
    if rate >= 1.0:
        raise ValueError(f"attention dropout rate must be below 1; got "
                         f"{rate}")
    if seed is None:
        seed = rng.draw_seed()
    elif not isinstance(seed, int):
        seed = int(torch.as_tensor(seed).reshape(-1)[0].item())
    return AttnDropout(float(rate), int(seed))


def _masks(b, sq, sk, device, segment_ids, segment_ids_k, key_bias
           ) -> Masks:
    """``(seg_q [B, Sq] int32, seg_k [B, Sk] int32, bias [B, Sk] f32)``,
    each dense or None, as ``flash_attention_pallas`` (``:955-975``) and
    ``flash_attention_packed`` (``:776-801``) shape them: ``segment_ids_k``
    defaults to ``segment_ids`` when Sq == Sk, and the bias becomes float32
    only here."""
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


def _mask_error(masks: Masks, b: int, sq: int, sk: int,
               device) -> Optional[str]:
    """Why the kernels cannot take these masks, or None: segment ids both
    or neither, each mask dense at its shape and type on ``device``."""
    seg_q, seg_k, bias = masks
    if (seg_q is None) != (seg_k is None):
        return "segment ids need both seg_q and seg_k"
    for name, t, shape, dtype in (("seg_q", seg_q, (b, sq), torch.int32),
                                  ("seg_k", seg_k, (b, sk), torch.int32),
                                  ("key_bias", bias, (b, sk), torch.float32)):
        if t is not None and (tuple(t.shape) != shape or t.dtype != dtype
                              or t.device != device
                              or not t.is_contiguous()):
            return f"{name} must be dense {dtype} {list(shape)} on " \
                   f"{device}; got {t.dtype} {list(t.shape)} on {t.device}"
    return None


def _masked_scores(s, causal: bool, masks: Masks):
    """The TPU kernels' masks on f32 scores ``[B, ..., Sq, Sk]`` (K1's
    ``[B, HK, G, Sq, Sk]``, K4's ``[B, H, Sq, Sk]``), in their order:
    bottom-right causal, then segments, then the key bias."""
    seg_q, seg_k, bias = masks
    b, sq, sk = s.shape[0], s.shape[-2], s.shape[-1]
    heads = (1,) * (s.dim() - 3)
    if causal:
        valid = torch.ones(sq, sk, dtype=torch.bool, device=s.device)
        s = torch.where(torch.tril(valid, diagonal=sk - sq), s, NEG_INF)
    if seg_q is not None:
        same = seg_q.view(b, *heads, sq, 1) == seg_k.view(b, *heads, 1, sk)
        s = torch.where(same, s, NEG_INF)
    if bias is not None:
        s = s + bias.view(b, *heads, 1, sk)
    return s


def _shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_fwd takes [B, S, H, D] tensors; got "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k and v must be [B, Sk, HK, D] = "
                         f"[{b}, Sk, HK, {d}]; got k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if hk < 1 or h % hk:
        raise ValueError(f"query heads ({h}) must be a multiple of kv heads "
                         f"({hk})")
    return b, sq, sk, h, hk, d


def kernel_arg_error(q, k, v, masks: Masks = NO_MASKS) -> Optional[str]:
    """Why the CUDA kernel cannot take these tensors, or None. Device
    aside, these are the kernel's limits; the plain version has none."""
    b, sq, sk, h, hk, d = _shapes(q, k, v)
    why = _mask_error(masks, b, sq, sk, q.device)
    if why is not None:
        return why
    if d not in SUPPORTED_HEAD_DIMS:
        return f"head dim {d} not in {SUPPORTED_HEAD_DIMS}"
    if q.dtype not in _DTYPE_CODE:
        return f"dtype {q.dtype} is not float32, bfloat16 or float16"
    if k.dtype != q.dtype or v.dtype != q.dtype:
        return f"q, k, v dtypes differ ({q.dtype}, {k.dtype}, {v.dtype})"
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            return f"{name}'s last dimension is not dense (stride " \
                   f"{t.stride(3)})"
    if max(sq, sk) >= 2 ** 31 or b * h >= 65536:
        return f"shape {tuple(q.shape)} exceeds the kernel's grid"
    return None


def kernel_key_tile(dtype: torch.dtype, d: int) -> int:
    """The keys a stage of the CUDA body that ``dtype`` and head dim ``d``
    reach takes: the tensor-core body's stage for bf16 and float16
    (``TC_KEY_TILE``),
    the CUDA-core bodies' 64-key tile for float32. The plain versions walk
    the same stages by default, so they round p where the kernel rounds it
    (in float32 the rounding is the identity and only the order of the sums
    follows)."""
    if dtype == torch.float32:
        return CUDA_CORE_KEY_TILE
    return TC_KEY_TILE.get(d, 128)


def flash_fwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False,
                        scale: Optional[float] = None,
                        dropout: Optional[AttnDropout] = None, *,
                        first_head: int = 0, masks: Masks = NO_MASKS,
                        key_tile: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K1: ``_fwd_kernel``'s online softmax over the key
    stages of ``key_tile`` keys, in order, in float32.

    Bottom-right causal, then the segments and the key bias of ``masks``,
    grouped-query KV by head reshape (no repeat), masked scores at
    ``NEG_INF``. m, l and acc are float32 and m starts at ``NEG_INF``; each
    stage takes ``m' = max(m, max s)``, ``p = exp(s - m') * (s > NEG_INF /
    2)``, ``l = l exp(m - m') + sum p`` and ``acc = acc exp(m - m') + p v``
    with p (``p * keep`` under ``dropout``, while l sums the undropped p)
    rounded to v's dtype before the value product, as the TPU kernel rounds
    it against the running max of its key block (``:287``) when its blocks
    are pinned at 128/128 (JAX's default blocks, ``_pick_blocks``, are
    wider and round p elsewhere: within the bf16 tolerance, with fewer
    outputs bit-equal). The kernel's
    masked-row convention: o = 0, lse = NEG_INF + log(1e-30). ``key_tile``
    defaults to the stage of the body the dtype reaches
    (:func:`kernel_key_tile`); the kernel skips stages above a query tile's
    causal band, where every row's walk leaves m, l and acc as they were.
    ``first_head`` numbers the heads' masks from a flat head past 0, as in a
    slice of a larger batch (the kernels take whole batches, from 0).
    Returns ``(o [B, Sq, H, D]`` in q's dtype, ``lse [B, H, Sq]``
    float32)."""
    b, sq, sk, h, hk, d = _shapes(q, k, v)
    g = h // hk
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    key_tile = kernel_key_tile(q.dtype, d) if key_tile is None else \
        int(key_tile)
    qf = q.float().reshape(b, sq, hk, g, d)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf) * scale   # [B,HK,G,Sq,Sk]
    s = _masked_scores(s, causal, masks)
    keep = _keep(dropout, b, h, sq, sk, q.device, first_head)
    if keep is not None:
        keep = keep.reshape(b, hk, g, sq, sk)
    m = torch.full((b, hk, g, sq, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, hk, g, sq, 1), device=q.device)
    acc = torch.zeros((b, hk, g, sq, d), device=q.device)
    for k0 in range(0, sk, key_tile):
        t = slice(k0, min(k0 + key_tile, sk))
        st = s[..., t]
        m_new = torch.maximum(m, st.amax(dim=-1, keepdim=True))
        p = torch.where(st > NEG_INF / 2, torch.exp(st - m_new),
                        torch.zeros_like(st))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        if keep is not None:
            p = p * keep[..., t]
        acc = acc * alpha + torch.einsum(
            "bkgqs,bskd->bkgqd", p.to(v.dtype).float(), vf[:, t])
        m = m_new
    l = torch.clamp(l, min=1e-30)
    o = (acc / l).permute(0, 3, 1, 2, 4).reshape(b, sq, h, d)
    lse = (m + torch.log(l))[..., 0].reshape(b, h, sq)
    return o.to(q.dtype), lse


def _delta(o, do, dlse=None):
    """``rowsum(do * o)`` in float32 as ``[B, H, Sq]``, minus ``dlse``
    when the lse has a cotangent (``_bwd``'s ``:598-605``)."""
    delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta.contiguous()


#: products an mma.sync.m16n8k16 step sums
MMA_STEP = 16


def _exponent(x: torch.Tensor) -> torch.Tensor:
    """floor(log2 |x|) of float64 ``x`` as int64 (-2000 where x is 0)."""
    e = torch.frexp(x)[1].long() - 1
    return torch.where(x != 0, e, torch.full_like(e, -2000))


def _toward_zero_f32(x: torch.Tensor) -> torch.Tensor:
    """float64 ``x`` rounded toward zero to float32 (as float64)."""
    f = x.float()
    f = torch.where(f.double().abs() > x.abs(),
                    torch.nextafter(f, torch.zeros_like(f)), f)
    return f.double()


def mma_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum("bqhd,bkhd->bhqk", a, b)`` of bf16 or float16 ``a [B, Sq,
    H, D]`` and
    ``b [B, Sk, HK, D]`` (``HK`` dividing ``H``: query head h takes b's head
    ``h // (H / HK)``) in float32, summed over d as Hopper's
    ``mma.sync.m16n8k16`` sums 16-bit products into a float32 accumulator, in
    steps of 16 in the order of d: in each step the products (exact) and
    the running sum are truncated toward zero to the grid 2^(E - 25), E the
    largest exponent among them (a product's exponent taken as the sum of
    its factors'), added exactly, and the step's sum truncated toward zero
    to float32. ``chip_smoke.py`` holds this against the card's own sums bit
    for bit. The tensor-core backward bodies (K2/K3's and K4's streamed
    ones) sum dp (and s) this way; a plain float32 einsum rounds elsewhere.
    Returns ``[B, H, Sq, Sk]``."""
    B, sq, h, d = a.shape
    sk, hk = b.shape[1], b.shape[2]
    g = h // hk
    af = a.double().permute(0, 2, 1, 3).reshape(B * h, sq, d)
    bf = b.double().permute(0, 2, 1, 3).reshape(B * hk, sk, d)
    ea, eb = _exponent(af), _exponent(bf)
    out = torch.empty(B * h, sq, sk, dtype=torch.float32, device=a.device)
    rows = max(1, 2 ** 21 // max(sk, 1))   # bounds the [rows, Sk, 16] steps
    for bh in range(B * h):
        kv = (bh // h) * hk + (bh % h) // g
        for r0 in range(0, sq, rows):
            ra, rea = af[bh, r0:r0 + rows], ea[bh, r0:r0 + rows]
            acc = torch.zeros(ra.shape[0], sk, dtype=torch.float64,
                              device=a.device)
            for c in range(0, d, MMA_STEP):
                st = slice(c, c + MMA_STEP)
                prod = ra[:, None, st] * bf[kv, None, :, st]
                e = torch.where(prod != 0, rea[:, None, st] +
                                eb[kv, None, :, st], -2000)
                top = torch.maximum(e.amax(-1), _exponent(acc))
                lsb = torch.exp2((top.clamp(min=-1000) - 25).double())
                acc = _toward_zero_f32(
                    torch.trunc(prod / lsb[..., None]).sum(-1) * lsb +
                    torch.trunc(acc / lsb) * lsb)
            out[bh, r0:r0 + rows] = acc.float()
    return out.reshape(B, h, sq, sk)


def flash_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        causal: bool = False, scale: Optional[float] = None,
                        dlse: Optional[torch.Tensor] = None,
                        dropout: Optional[AttnDropout] = None, *,
                        first_head: int = 0, masks: Masks = NO_MASKS,
                        mma_sums: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch K2 and K3: the gradients ``_bwd`` computes, in float32.

    Recomputes the masked scores (K1's ``masks``) and ``p = exp(s - lse)``
    from K1's lse (0 where the score is
    masked, so a row with no valid key gives dq = 0 and adds nothing to
    dk/dv), and rounds at ``_bwd``'s points: ``ds`` to q's dtype before
    the dq and dk products, ``p`` (``p * keep`` with ``dropout``, which
    also scales ``dp``) to do's dtype before the dv product. Those
    roundings are element by element, so the kernels' stages move nothing
    here but the order of the f32 sums.
    Grouped-query dk/dv sum over each KV head's query heads. ``first_head``
    as :func:`flash_fwd_reference` takes it. ``mma_sums`` sums ``dp = dO
    v^T`` as the 16-bit tensor-core bodies do (:func:`mma_dot`), which is how
    the card holds those bodies to this: in a row whose every key carries
    the -1e9 padding bias, the f32 lse absorbs log l, so p = 1 at each key
    and ds is l times its usual size, and a dp summed in another order
    flips its bf16 rounding by more than the comparison allows. Returns
    ``(dq [B, Sq, H, D], dk [B, Sk, HK, D], dv [B, Sk, HK, D])`` in the
    input dtypes."""
    b, sq, sk, h, hk, d = _shapes(q, k, v)
    g = h // hk
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    delta = _delta(o, do, dlse).reshape(b, hk, g, sq, 1)
    qf = q.float().reshape(b, sq, hk, g, d)
    dof = do.float().reshape(b, sq, hk, g, d)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf) * scale   # [B,HK,G,Sq,Sk]
    s = _masked_scores(s, causal, masks)
    valid = s > NEG_INF / 2
    p = torch.where(valid, torch.exp(s - lse.float().reshape(b, hk, g, sq, 1)),
                    torch.zeros_like(s))
    dp = mma_dot(do, v).reshape(b, hk, g, sq, sk) if mma_sums else \
        torch.einsum("bqkgd,bskd->bkgqs", dof, vf)
    pv = p
    keep = _keep(dropout, b, h, sq, sk, q.device, first_head)
    if keep is not None:
        keep = keep.reshape(b, hk, g, sq, sk)
        pv, dp = p * keep, dp * keep
    ds = (p * (dp - delta) * scale).to(q.dtype).float()
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf).reshape(b, sq, h, d)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf)
    dv = torch.einsum("bkgqs,bqkgd->bskd", pv.to(do.dtype).float(), dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _kernel(stem: str, name: str, n_ptrs: int, n_strides: int):
    """The C entry ``name`` of ``csrc/<stem>.cu`` with its argtypes set:
    ``n_ptrs`` pointers, the six sizes, ``n_strides`` strides, scale,
    causal, dtype, the four dropout arguments (:func:`_dropout_args`) and
    the stream. Without argtypes ctypes passes every int as 32 bits and
    cuts the pointers."""
    from .build import library
    lib = library(stem)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6 +
                       [ctypes.c_longlong] * n_strides +
                       [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32,
                        ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.paddle_cuda_error_string.argtypes = [ctypes.c_int]
        lib.paddle_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def _strides(*ts):
    return [s for t in ts for s in (t.stride(0), t.stride(1), t.stride(2))]


def _call(lib, fn, what: str, q, k, *args):
    """Run ``fn(*args, stream)`` on q's device; raise on a refused launch
    (it never runs, and a synchronise would not report it)."""
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        msg = lib.paddle_cuda_error_string(err).decode()
        raise KernelLaunchError(f"{what} kernel launch failed: {msg} "
                                f"(cudaError {err}) for q {tuple(q.shape)} "
                                f"{q.dtype}, k {tuple(k.shape)}")


def _mask_ptrs(masks: Masks):
    return [None if t is None else t.data_ptr() for t in masks]


def require_aligned_rows(what: str, *named) -> None:
    """Raise unless every ``(name, tensor)`` starts on 16 bytes and has
    batch, sequence and head strides of whole 8-value pieces: the tensor-core
    bodies read 16-bit rows by 16-byte copies."""
    for name, t in named:
        if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
            raise ValueError(f"{what} kernel cannot take these inputs: "
                             f"{name}'s rows are not 16-byte aligned "
                             f"(strides {t.stride()})")


def _launch(q, k, v, causal: bool, scale: float,
            dropout: Optional[AttnDropout] = None, masks: Masks = NO_MASKS):
    """K1 on CUDA tensors, from the body of q's dtype: bf16 and float16 the
    tensor-core body (``flash_fwd_tc.cu``, counted by :func:`flash_fwd_tc`),
    float32 the CUDA-core body (``flash_fwd.cu``, counted by
    :func:`flash_fwd`)."""
    tc = q.dtype in TC_DTYPES
    what = "flash_fwd_tc" if tc else "flash_fwd"
    if tc:
        require_aligned_rows(what, ("q", q), ("k", k), ("v", v))
    lib, fn = _kernel(what, "paddle_" + what, 8, 9)
    b, sq, sk, h, hk, d = _shapes(q, k, v)
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    _call(lib, fn, what, q, k, q.data_ptr(), k.data_ptr(),
          v.data_ptr(), o.data_ptr(), lse.data_ptr(), *_mask_ptrs(masks),
          b, h, hk, sq, sk, d,
          *_strides(q, k, v), float(scale), int(bool(causal)),
          _DTYPE_CODE[q.dtype], *_dropout_args(dropout))
    (flash_fwd_tc if tc else flash_fwd).launches += 1
    return o, lse


def _bwd_args(q, k, v, do, causal, scale, dropout):
    b, sq, sk, h, hk, d = _shapes(q, k, v)
    return ([b, h, hk, sq, sk, d] + _strides(q, k, v, do) +
            [float(scale), int(bool(causal)), _DTYPE_CODE[q.dtype]] +
            _dropout_args(dropout))


def _require_kernel_inputs(q, k, v, do, lse, delta, masks: Masks):
    """Raise unless the backward kernels can take these tensors: checked
    before any pointer reaches them."""
    if q.device.type != "cuda":
        raise ValueError(f"the flash backward kernels run on CUDA tensors, "
                         f"not {q.device}; flash_bwd takes CPU tensors")
    b, sq, _, h, _, _ = _shapes(q, k, v)
    why = _bwd_arg_error(q, k, v, do, masks)
    if why is None and len({t.device for t in (q, k, v, do, lse, delta)}) > 1:
        why = "inputs on different devices"
    if why is None and do.shape != q.shape:
        why = f"do {tuple(do.shape)} is not q's shape {tuple(q.shape)}"
    if why is None and any(t.shape != (b, h, sq) or t.dtype != torch.float32
                           or not t.is_contiguous() for t in (lse, delta)):
        why = f"lse and delta must be dense float32 [{b}, {h}, {sq}]"
    if why is not None:
        raise ValueError(f"flash backward kernels cannot take these inputs: "
                         f"{why}")


def _bwd_body_tc(q) -> bool:
    """Whether K2 and K3 of q's dtype and head dim run on the tensor-core
    bodies (bf16 and float16 at ``TC_BWD_HEAD_DIMS``) or on the CUDA-core
    ones."""
    return q.dtype in TC_DTYPES and q.shape[-1] in TC_BWD_HEAD_DIMS


def _launch_bwd(which: str, tc: bool, q, k, v, do, lse, delta, causal: bool,
                scale: float, dropout: Optional[AttnDropout], masks: Masks):
    """K2 (``which = "dq"``, returns dq) or K3 (``"dkv"``, returns ``(dk,
    dv)``) on CUDA tensors, from the tensor-core body (``tc``:
    ``flash_bwd_tc.cu``, q, k, v and do rows 16-byte aligned) or the
    CUDA-core body (``flash_bwd.cu``), each counted by its own wrapper."""
    _require_kernel_inputs(q, k, v, do, lse, delta, masks)
    what = f"flash_bwd_{which}" + ("_tc" if tc else "")
    if tc:
        require_aligned_rows(what, ("q", q), ("k", k), ("v", v), ("do", do))
    if which == "dq":
        outs = [torch.empty(q.shape, dtype=q.dtype, device=q.device)]
    else:
        outs = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
                for t in (k, v)]
    lib, fn = _kernel("flash_bwd_tc" if tc else "flash_bwd", "paddle_" + what,
                      9 + len(outs), 12)
    _call(lib, fn, what, q, k, q.data_ptr(), k.data_ptr(),
          v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
          *_mask_ptrs(masks), *(t.data_ptr() for t in outs),
          *_bwd_args(q, k, v, do, causal, scale, dropout))
    {"flash_bwd_dq": flash_bwd_dq, "flash_bwd_dq_tc": flash_bwd_dq_tc,
     "flash_bwd_dkv": flash_bwd_dkv, "flash_bwd_dkv_tc": flash_bwd_dkv_tc}[
         what].launches += 1
    return outs[0] if which == "dq" else tuple(outs)


def _require_tc(q, what: str) -> None:
    """Raise unless q's dtype and head dim are the tensor-core bodies'."""
    if not _bwd_body_tc(q):
        raise ValueError(
            f"{what} takes bfloat16 at head dims {TC_BWD_HEAD_DIMS} (and "
            f"float16 there), not "
            f"{q.dtype} at {q.shape[-1]} ({what[:-3]} runs those on its "
            f"CUDA-core body)")


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool, scale: float,
                 dropout: Optional[AttnDropout] = None,
                 masks: Masks = NO_MASKS) -> torch.Tensor:
    """K2 on CUDA tensors: ``dq [B, Sq, H, D]`` from q, k, v, do, K1's lse
    and ``delta`` (both dense ``[B, H, Sq]`` float32), with K1's
    ``masks``. bf16 and float16 at head dims 64 and 128 run the tensor-core
    body (counted by :func:`flash_bwd_dq_tc`), float32 and 16 bits at 256
    the CUDA-core body (counted here)."""
    return _launch_bwd("dq", _bwd_body_tc(q), q, k, v, do, lse, delta,
                       causal, scale, dropout, masks)


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool, scale: float,
                  dropout: Optional[AttnDropout] = None,
                  masks: Masks = NO_MASKS
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 on CUDA tensors: ``(dk, dv)``, each ``[B, Sk, HK, D]``, summed
    over the query heads of each KV head's group, with K1's ``masks``; the
    body picked as :func:`flash_bwd_dq` picks it (the tensor-core one
    counted by :func:`flash_bwd_dkv_tc`)."""
    return _launch_bwd("dkv", _bwd_body_tc(q), q, k, v, do, lse, delta,
                       causal, scale, dropout, masks)


def flash_bwd_dq_tc(q, k, v, do, lse, delta, causal: bool, scale: float,
                    dropout: Optional[AttnDropout] = None,
                    masks: Masks = NO_MASKS) -> torch.Tensor:
    """K2's tensor-core body alone (bf16 or float16 at head dims 64 and 128,
    rows
    16-byte aligned; anything else raises), arguments as
    :func:`flash_bwd_dq`, which reaches it for every such input."""
    _require_tc(q, "flash_bwd_dq_tc")
    return _launch_bwd("dq", True, q, k, v, do, lse, delta, causal, scale,
                       dropout, masks)


def flash_bwd_dkv_tc(q, k, v, do, lse, delta, causal: bool, scale: float,
                     dropout: Optional[AttnDropout] = None,
                     masks: Masks = NO_MASKS
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's tensor-core body alone, as :func:`flash_bwd_dq_tc` takes it.
    Returns ``(dk, dv)``."""
    _require_tc(q, "flash_bwd_dkv_tc")
    return _launch_bwd("dkv", True, q, k, v, do, lse, delta, causal, scale,
                       dropout, masks)


def _bwd_arg_error(q, k, v, do, masks: Masks = NO_MASKS) -> Optional[str]:
    """Why the backward kernels cannot take these tensors, or None: K1's
    limits, and do in q's dtype with a dense last dimension."""
    why = kernel_arg_error(q, k, v, masks)
    if why is None and do.dtype != q.dtype:
        why = f"do's dtype {do.dtype} differs from q's {q.dtype}"
    if why is None and do.stride(3) != 1:
        why = f"do's last dimension is not dense (stride {do.stride(3)})"
    return why


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
              causal: bool = False, scale: Optional[float] = None,
              dlse: Optional[torch.Tensor] = None,
              dropout: Optional[AttnDropout] = None,
              masks: Masks = NO_MASKS
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1's backward: K2 and K3 for CUDA tensors, the plain version for CPU
    tensors. ``o`` and ``lse`` are K1's outputs (with the same
    ``dropout`` and ``masks``), ``do`` the cotangent of ``o`` and ``dlse``
    (optional) that of ``lse``. Returns ``(dq [B, Sq, H, D], dk [B, Sk, HK,
    D], dv [B, Sk, HK, D])``; the key bias gets no gradient."""
    b, sq, sk, h, hk, d = _shapes(q, k, v)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o and do must have q's shape {tuple(q.shape)}; "
                         f"got o {tuple(o.shape)}, do {tuple(do.shape)}")
    for name, t in (("lse", lse), ("dlse", dlse)):
        if t is not None and t.shape != (b, h, sq):
            raise ValueError(f"{name} must be [B, H, Sq] = [{b}, {h}, {sq}]; "
                             f"got {tuple(t.shape)}")
    devices = {t.device for t in (q, k, v, o, lse, do, dlse, *masks)
               if t is not None}
    if len(devices) != 1:
        raise ValueError(f"flash_bwd inputs on different devices: {devices}")
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, o, lse, do, causal, scale, dlse,
                                   dropout, masks=masks)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd runs on CUDA or the CPU, not "
                         f"{q.device}")
    if 0 in (b, sq, sk, h):   # no work: nothing to launch
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    delta = _delta(o, do, dlse)
    lse = lse.float().contiguous()
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal, scale, dropout, masks)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale, dropout,
                           masks)
    return dq, dk, dv


@torch.library.custom_op("paddle_tpu_torch::flash_fwd", mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 seg_q: Optional[torch.Tensor], seg_k: Optional[torch.Tensor],
                 bias: Optional[torch.Tensor], causal: bool, scale: float,
                 rate: float, seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's forward as one operator, ``torch.ops.paddle_tpu_torch.
    flash_fwd``: the kernel on CUDA tensors, the plain version on CPU
    tensors; dropout as ``(rate, seed)``, off at rate 0. The ctypes launch
    is invisible to the dispatcher; as an operator it is seen, so an
    activation-recompute policy can keep ``(o, lse)`` from the forward
    instead of launching K1 again in the backward (the JAX kernel names
    them ``flash_out`` and ``flash_lse`` for its policies). Not
    differentiable itself: :func:`flash_fwd` wraps it."""
    dropout = AttnDropout(rate, seed) if rate > 0.0 else None
    masks = (seg_q, seg_k, bias)
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, causal, scale, dropout,
                                   masks=masks)
    return _launch(q, k, v, causal, scale, dropout, masks)


class _FlashFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_k, bias, causal, scale, dropout,
                lse_grad):
        masks = (seg_q, seg_k, bias)
        rate, seed = (0.0, 0) if dropout is None else dropout
        o, lse = torch.ops.paddle_tpu_torch.flash_fwd(
            q, k, v, seg_q, seg_k, bias, causal, scale, float(rate),
            int(seed))
        ctx.save_for_backward(q, k, v, o, lse, *(
            torch.empty(0) if t is None else t for t in masks))
        ctx.has_mask = tuple(t is not None for t in masks)
        ctx.causal, ctx.scale, ctx.dropout = causal, scale, dropout
        ctx.lse_grad = lse_grad
        if not lse_grad:
            ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        # lse's cotangent (flash_attention_with_lse) folds into delta
        q, k, v, o, lse, *saved = ctx.saved_tensors
        masks = tuple(t if has else None
                      for t, has in zip(saved, ctx.has_mask))
        if do.stride(-1) != 1:   # e.g. the expanded ones of out.sum()
            do = do.contiguous()
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, ctx.causal, ctx.scale,
                               dlse=dlse if ctx.lse_grad else None,
                               dropout=ctx.dropout, masks=masks)
        # the masks, the key bias among them, get no gradient
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False, scale: Optional[float] = None,
              dropout: Optional[AttnDropout] = None,
              masks: Masks = NO_MASKS, lse_grad: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 forward: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. ``masks`` are ``(seg_q, seg_k, bias)`` as :func:`_masks`
    gives them. Returns ``(o [B, Sq, H, D], lse [B, H, Sq] float32)``;
    gradients flow to q, k and v through :func:`flash_bwd`, with the same
    ``dropout`` mask and ``masks``. The lse is differentiable only with
    ``lse_grad``: its cotangent then reaches :func:`flash_bwd` as
    ``dlse``."""
    _shapes(q, k, v)
    devices = {t.device for t in (q, k, v, *masks) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"q, k, v and the masks on different devices: "
                         f"{devices}")
    if q.device.type == "cuda":
        why = kernel_arg_error(q, k, v, masks)
        if why is not None:
            raise ValueError(f"flash_fwd kernel cannot take these inputs: "
                             f"{why}")
    elif q.device.type != "cpu":
        raise ValueError(f"flash_fwd runs on CUDA or the CPU, not "
                         f"{q.device}")
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    return _FlashFwd.apply(q, k, v, *masks, bool(causal), scale, dropout,
                           bool(lse_grad))


def flash_fwd_tc(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool = False, scale: Optional[float] = None,
                 dropout: Optional[AttnDropout] = None,
                 masks: Masks = NO_MASKS
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's tensor-core body (bf16 and float16): the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. Not differentiable itself;
    :func:`flash_fwd` reaches it for every 16-bit CUDA input."""
    _shapes(q, k, v)
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, causal, scale, dropout,
                                   masks=masks)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd_tc runs on CUDA or the CPU, not "
                         f"{q.device}")
    if q.dtype not in TC_DTYPES:
        raise ValueError(f"flash_fwd_tc takes bfloat16 or float16, not "
                         f"{q.dtype} (flash_fwd runs float32 on its CUDA-core "
                         f"body)")
    why = kernel_arg_error(q, k, v, masks)
    if why is not None:
        raise ValueError(f"flash_fwd_tc kernel cannot take these inputs: "
                         f"{why}")
    return _launch(q, k, v, causal, scale, dropout, masks)


def flash_attention_hopper(query: torch.Tensor, key: torch.Tensor,
                           value: torch.Tensor, causal: bool = False,
                           scale: Optional[float] = None, segment_ids=None,
                           segment_ids_k=None, dropout: float = 0.0,
                           dropout_seed=None, key_bias=None) -> torch.Tensor:
    """``flash_attention_pallas``'s routing (``:909-926``), ``[B, S, H,
    D]``: with the flag ``flash_head_pack`` on (its default), a d=64 MHA
    input whose sequence lengths are multiples of 128 and whose
    ``pack_group(H)`` is non-zero goes to K4
    (:func:`~.flash_attention_packed.flash_attention_packed`); any other
    input goes to K1. ``segment_ids`` ``[B, Sq]`` (and ``segment_ids_k``
    ``[B, Sk]``, which defaults to ``segment_ids`` when Sq == Sk) keep
    attention within equal ids; ``key_bias`` ``[B, Sk]`` is added to every
    query's scores, as ``:955-975`` shapes them. ``dropout`` is
    attention-prob dropout in the kernel, seeded by ``dropout_seed`` (drawn
    from the next key when None, as ``:969-973`` draws it). On the K1
    route the flags ``flash_block_q``/``flash_block_k`` are checked as
    JAX checks them (:func:`_pick_blocks`); a valid value changes nothing
    here."""
    from ...core import flags
    from .flash_attention_packed import flash_attention_packed, pack_group
    b, sq, h, d = query.shape
    sk, hk = key.shape[1], key.shape[2]
    if d == 64 and hk == h and sq % 128 == 0 and sk % 128 == 0 and \
            int(flags.flag("flash_head_pack")) and pack_group(h):
        return flash_attention_packed(
            query, key, value, causal=causal, scale=scale,
            segment_ids=segment_ids, segment_ids_k=segment_ids_k,
            dropout=dropout, dropout_seed=dropout_seed, key_bias=key_bias)
    _pick_blocks(sq, sk, d)     # JAX's checks of the block flags
    masks = _masks(b, sq, sk, query.device, segment_ids, segment_ids_k,
                   key_bias)
    return flash_fwd(query, key, value, causal=causal, scale=scale,
                     dropout=as_dropout(dropout, dropout_seed),
                     masks=masks)[0]


def _pick_blocks(sq: int, sk: int, d: int) -> Tuple[int, int]:
    """The JAX kernel's ``(block_q, block_k)`` (``:85-121``), by its rule:
    the flags ``flash_block_q``/``flash_block_k`` when set (both or
    neither, multiples of 128, else ``ValueError`` as in JAX), then the
    autotune cache's ``flash_attention`` entry (:func:`tune_flash_blocks`),
    then the static table; the largest multiple of 128 up to the target
    that divides the length, else 128, or the length itself where it is
    shorter. The port's bodies tile by their own stages whatever this
    says: it decides only what :func:`flash_attention_with_lse` refuses."""
    from ...core import flags
    ov_q = int(flags.flag("flash_block_q"))
    ov_k = int(flags.flag("flash_block_k"))
    if ov_q or ov_k:
        if not (ov_q and ov_k):
            raise ValueError(
                f"flash_block_q/flash_block_k must be set together "
                f"(got q={ov_q}, k={ov_k}); set both or neither")
        if ov_q % 128 or ov_k % 128:
            raise ValueError(
                f"flash block overrides must be multiples of 128; got "
                f"q={ov_q}, k={ov_k}")
        tq, tk = ov_q, ov_k
    elif (tuned := _tuned_blocks(sq, sk, d)) is not None:
        tq, tk = tuned
    else:
        tq, tk = (512, 1024) if d <= 64 else (1024, 1024) if d <= 128 \
            else (128, 256)

    def fit(target, s):
        b = min(target, s)
        while b > 128 and s % b:
            b -= 128
        return b

    return fit(tq, sq), fit(tk, sk)


def _tuned_blocks(sq: int, sk: int, d: int) -> Optional[Tuple[int, int]]:
    from .autotune import get_cache
    hit = get_cache().get("flash_attention", f"sq{sq}_sk{sk}_d{d}")
    return tuple(hit) if isinstance(hit, (list, tuple)) else None


def tune_flash_blocks(query, key, value, causal: bool = False,
                      candidates=None, iters: int = 3):
    """JAX's ``tune_flash_blocks`` (``:63-83``) over the one block choice
    the port's K1 takes: 128/128, its 128-key stages, to which its rounding
    claim is scoped (``flash_fwd_reference``). It times
    :func:`flash_attention_hopper` on the inputs and stores the choice
    under JAX's kernel name and key (``flash_attention``,
    ``sq{Sq}_sk{Sk}_d{D}``), where :func:`_pick_blocks` reads it. Any other
    candidate raises ``ValueError``: a block that moved where p is rounded
    would be another function."""
    from .autotune import autotune
    cands = [tuple(c) for c in (candidates or [(128, 128)])]
    if cands != [(128, 128)]:
        raise ValueError(f"the port's flash kernels take blocks 128/128 "
                         f"only; got {cands}")
    b, sq, h, d = query.shape
    sk = key.shape[1]

    def run(cfg):
        return flash_attention_hopper(query, key, value, causal=causal)

    return tuple(autotune("flash_attention", f"sq{sq}_sk{sk}_d{d}", cands,
                          run, iters=iters))


def flash_attention_with_lse(query: torch.Tensor, key: torch.Tensor,
                             value: torch.Tensor, causal: bool = False,
                             scale: Optional[float] = None,
                             block_q: Optional[int] = None,
                             block_k: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[B, S, H, D]`` attention returning ``(o, lse [B, Sq, H] float32)``
    (JAX ``:845``), both differentiable: K1 forward, K2/K3 backward, with
    lse's cotangent folded into K2/K3's delta (``delta - dlse``, JAX
    ``:601-605``). Two ``(o, lse)`` partials over disjoint key sets merge
    into attention over all keys (``lse = logaddexp(lse1, lse2)``, ``o``
    their convex combination), differentiably end to end: the ring of
    context parallelism is built on it. Raises where JAX raises: lengths
    the JAX kernel's blocks (``block_q``/``block_k``, by default its table)
    do not divide, and query heads not a multiple of the kv heads. The
    port's kernels tile by their own stages; the blocks decide only what
    is refused."""
    b, sq, h, d = query.shape
    sk, hk = key.shape[1], key.shape[2]
    auto_q, auto_k = _pick_blocks(sq, sk, d)
    block_q, block_k = block_q or auto_q, block_k or auto_k
    if sq % min(block_q, sq) or sk % min(block_k, sk):
        raise ValueError(
            f"flash_attention_with_lse needs seq lengths divisible by the "
            f"block sizes; got sq={sq}, sk={sk}")
    if hk != h and (hk == 0 or h % hk):
        raise ValueError(
            f"query heads {h} must be a multiple of kv heads {hk}")
    o, lse = flash_fwd(query, key, value, causal=causal, scale=scale,
                       lse_grad=True)
    return o, lse.transpose(1, 2)


#: kernel launches since each count was last set to 0 (CUDA path only);
#: flash_fwd counts K1's float32 body, flash_fwd_tc its 16-bit tensor-core
#: body; flash_bwd_dq/_dkv count K2/K3's CUDA-core bodies, flash_bwd_dq_tc/
#: _dkv_tc their 16-bit tensor-core bodies at head dims 64 and 128
flash_fwd.launches = 0
flash_fwd_tc.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0
flash_bwd_dq_tc.launches = 0
flash_bwd_dkv_tc.launches = 0
