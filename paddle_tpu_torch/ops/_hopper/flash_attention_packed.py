"""Flash attention at head dim 64 on Hopper: K4, in all six of its forms.

Port of ``paddle_tpu/ops/_pallas/flash_attention_packed.py``. Where the
whole key sequence fits one of the JAX package's tiles (Sk <= 512 at 12
heads) it runs the forward ``_fwd_kernel_direct`` (K4a-direct: bf16 and
float16 on the tensor cores, ``csrc/flash_packed_tc.cu``; float32 on the
CUDA cores, ``csrc/flash_packed.cu``) and the fused backward
``_bwd_fused_kernel`` (K4b-fused: bf16 and float16 on the tensor cores, one
thread-block cluster a head, ``csrc/flash_bwd_tc.cu``; float32 on the CUDA
cores, ``csrc/flash_packed.cu``);
where it does not, the streamed forms ``_fwd_kernel``, ``_bwd_dq_kernel``
and ``_bwd_dkv_kernel``, and ``_bwd_dkv_kernel_direct`` when all the
queries fit one tile while the keys do not, as ``csrc/flash_packed_stream.cu``
(the streamed forward, dq, dk/dv and dk/dv-direct in float32; in bf16 and
float16 the forward is K1's
tensor-core body, ``csrc/flash_fwd_tc.cu``, since ``_fwd_kernel`` is K1's
function at head dim 64 with as many KV heads as heads, and dq, dk/dv and
dk/dv-direct run K2's and K3's tensor-core bodies, ``csrc/flash_bwd_tc.cu``,
since ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` are K2's and K3's functions
there too, and ``_bwd_dkv_kernel_direct`` computes ``_bwd_dkv_kernel``'s
function: the same sums, with all the queries in one tile).
All are built by ``nvcc`` at first use and called through ``ctypes`` like
K1-K3. :func:`plan` picks the form the JAX package would run for every
input, from its tile arithmetic (``_pick_blocks_packed`` and the caller's
``block_q``/``block_k`` pins); inside each kernel the tiles are this card's
own (64 x 64 on the CUDA cores; the tensor-core bodies' own stages).

The TPU packs G heads on the 128-lane axis to fill its vector registers;
that is the TPU's layout and is not carried over. Every kernel reads the
public ``[B, S, H, 64]`` layout through strides, one head per block.

- :func:`flash_packed_fwd` (K4a-direct) and :func:`flash_packed_fwd_stream`
  ``-> (o [B, Sq, H, 64], lse [B, H, Sq] f32)``; on the card
  :func:`flash_packed_fwd` picks K4a-direct's body by dtype, openly: bf16
  and float16 the tensor-core body (counted in
  ``flash_packed_fwd_tc.launches``), float32 the CUDA-core body
  (``flash_packed_fwd.launches``), whose f32 products are
  the reference's (on the tensor cores f32 would be TF32); nothing falls back
  from one body to the other; :func:`flash_packed_fwd_stream` the same way
  (``flash_packed_fwd_stream_tc.launches``, ``flash_packed_fwd_stream.
  launches``);
- :func:`flash_packed_bwd` (K4b-fused) ``-> (dq, dk, dv)``, with ``delta =
  rowsum(do * o)`` a torch op here, as ``_bwd`` computes it outside its
  kernel; on the card 16 bits run the tensor-core body (counted in
  ``flash_packed_bwd_tc.launches``), float32 the CUDA-core body
  (``flash_packed_bwd.launches``; ``_launch_bwd(..., tc=False)`` runs it
  in bf16 as a yardstick that no path takes); :func:`flash_packed_bwd_dq`
  ``-> dq`` and :func:`flash_packed_bwd_dkv` /
  :func:`flash_packed_bwd_dkv_direct` ``-> (dk, dv)``, which take that
  ``delta``; on the card dq, dk/dv and dk/dv-direct pick their body by
  dtype, openly: bf16 and float16 the tensor-core bodies (counted in
  ``flash_packed_bwd_dq_tc.launches``, ``flash_packed_bwd_dkv_tc.
  launches`` and ``flash_packed_bwd_dkv_direct_tc.launches``), float32 the
  CUDA-core bodies (``flash_packed_bwd_dq.launches``,
  ``flash_packed_bwd_dkv.launches``, ``flash_packed_bwd_dkv_direct.
  launches``; ``_launch_bwd_split("dkv_direct", ..., tc=False)`` runs
  dk/dv-direct's CUDA-core body in 16 bits as a yardstick that no path
  takes);
- :func:`flash_attention_packed`, the differentiable public entry, whose
  forward calls the operator ``torch.ops.paddle_tpu_torch.flash_packed_fwd``
  (:func:`flash_packed_fwd_op`: K4a-direct or the streamed forward), so
  that activation recompute's policy can keep its ``(o, lse)``.

Masks work as the TPU kernels apply them: the scale, then bottom-right
causal, then segments (``seg_q == seg_k``, else ``NEG_INF``), then the
additive f32 key bias; ``p = exp(s - m) * (s > NEG_INF / 2)``.

On a CUDA tensor each wrapper launches its kernel, or raises on anything
the kernel does not take; each launch adds one to its ``launches``. On a
CPU tensor its plain version (the same name with ``_reference``) runs
instead. Nothing falls back from one to the other.

Every form takes attention-prob dropout (``dropout=AttnDropout(rate,
seed)``) as the TPU bodies apply it: the mask of the flat query head ``b*H
+ h`` (the row ``_flat_head`` gives a TPU packed head) and the absolute
score position, the softmax denominator from the undropped p, ``p * keep``
rounded to v's type in the value product, ``keep`` on dp in the backward
and ``p * keep`` in dv. The plain versions' ``first_head`` numbers the
masks from a flat head past 0, for a slice of a larger batch.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from .flash_attention import (NEG_INF, _DTYPE_CODE, TC_DTYPES, AttnDropout,
                              Masks,
                              _bwd_arg_error, _call, _delta, _dropout_args,
                              _keep, _kernel, _mask_ptrs, _masked_scores,
                              _masks, _strides, as_dropout,
                              flash_fwd_reference, kernel_arg_error,
                              mma_dot, require_aligned_rows)

__all__ = ["flash_attention_packed", "flash_packed_fwd",
           "flash_packed_fwd_tc", "flash_packed_fwd_reference",
           "flash_packed_bwd", "flash_packed_bwd_tc",
           "fused_cluster_size",
           "flash_packed_bwd_reference", "flash_packed_fwd_stream",
           "flash_packed_fwd_stream_tc", "flash_packed_fwd_stream_reference",
           "flash_packed_bwd_dq", "flash_packed_bwd_dq_tc",
           "flash_packed_bwd_dq_reference", "flash_packed_bwd_dkv",
           "flash_packed_bwd_dkv_tc",
           "flash_packed_bwd_dkv_reference", "flash_packed_bwd_dkv_direct",
           "flash_packed_bwd_dkv_direct_tc",
           "flash_packed_bwd_dkv_direct_reference", "pack_group", "plan",
           "Plan", "HEAD_D", "MAX_SEQ_K", "MAX_SEQ_Q_DIRECT", "KERNEL_TILE",
           "mma_dot"]

HEAD_D = 64  # the packed path exists for exactly this head dim
MAX_PACK_LANES = 1024
MAX_SEQ_K = 512  # the keys K4a-direct's kernel keeps in shared memory
MAX_SEQ_Q_DIRECT = 512  # the queries dk/dv-direct's kernel stages at once
#: query rows and keys per tile inside the K4 kernels on the CUDA cores, and
#: per stage of the streamed backward's tensor-core bodies at head dim 64
#: (the unit of their f32 sums; ``paddle_flash_bwd_tc_stage(64, dkv)``
#: reports it)
KERNEL_TILE = 64
#: K4b-fused's tensor-core body: one block a 64-key tile, a cluster of them
#: a head, at most the portable cluster size
MAX_CLUSTER_TILES = 8


def fused_cluster_size(sk: int) -> int:
    """The blocks of K4b-fused's tensor-core cluster for ``sk`` keys
    (``ceil(sk / 64)``, as the launch in ``csrc/flash_bwd_tc.cu`` takes
    them), or 0 past ``MAX_CLUSTER_TILES`` tiles, which it refuses."""
    nk = -(-sk // KERNEL_TILE)
    return nk if 1 <= nk <= MAX_CLUSTER_TILES else 0


def pack_group(num_heads: int) -> int:
    """Largest even divisor of num_heads whose packed width fits the TPU's
    lane cap; 0 when there is none. The routing keys on it as the JAX
    package does (``flash_attention.py:916``)."""
    best = 0
    for g in range(2, num_heads + 1, 2):
        if num_heads % g == 0 and g * HEAD_D <= MAX_PACK_LANES:
            best = g
    return best


def _pick_blocks_packed(sq: int, sk: int, dp: int, bwd: bool = False
                        ) -> Tuple[int, int]:
    """The JAX package's ``(block_q, block_k)`` for the packed width ``dp =
    G*64`` (``:53-87``, without its autotune cache, which is empty unless a
    TPU sweep filled it). The port's kernels tile by 64 whatever this
    says; it decides only which form runs."""
    if bwd:
        cq, ck = (256, 512) if dp <= 768 else (128, 256)
    else:
        cq, ck = (256, 512) if dp <= 768 else (256, 256)

    def fit(cap, s):
        b = min(cap, s)
        while b > 128 and s % b:
            b -= 128
        return b

    return fit(cq, sq), fit(ck, sk)


class Plan(NamedTuple):
    """The K4 forms one input runs: ``fwd`` is ``"direct"`` (K4a-direct)
    or ``"stream"``; ``bwd`` is ``"fused"`` (K4b-fused) or ``"dq"`` (the
    streamed dq, then ``dkv``: ``"direct"`` or ``"stream"``)."""
    fwd: str
    bwd: str
    dkv: Optional[str]


def plan(sq: int, sk: int, num_heads: int, block_q: Optional[int] = None,
         block_k: Optional[int] = None) -> Plan:
    """The forms JAX's ``flash_attention_packed`` runs for these lengths,
    by its own arithmetic: its tiles at ``dp = 64 * pack_group(H)``, or the
    caller's pins for both directions (``:740-750``); one key tile -> the
    direct forward (``_fwd`` ``:232``) and the fused backward (``_bwd``
    ``:542``), else the streamed forms; then the dk/dv tile mirror, and one
    query tile -> dk/dv-direct (``:613-626``). Raises ``ValueError`` where
    JAX does: lengths the forward tiles do not divide."""
    g = pack_group(num_heads)
    if not g:
        raise ValueError(f"no even pack group divides {num_heads} heads")
    dp = g * HEAD_D
    auto_q, auto_k = _pick_blocks_packed(sq, sk, dp)
    bwd_auto_q, bwd_auto_k = _pick_blocks_packed(sq, sk, dp, bwd=True)
    # explicit caller blocks pin BOTH directions, as in JAX
    bwd_bq, bwd_bk = block_q or bwd_auto_q, block_k or bwd_auto_k
    block_q, block_k = block_q or auto_q, block_k or auto_k
    if sq % min(block_q, sq) or sk % min(block_k, sk):
        raise ValueError(f"packed flash needs seq lengths divisible by "
                         f"blocks; sq={sq}, sk={sk}")
    fwd = "direct" if sk // min(block_k, sk) == 1 else "stream"
    bq, bk = min(bwd_bq, sq), min(bwd_bk, sk)
    if sk // bk == 1:
        return Plan(fwd, "fused", None)
    # dk/dv mirror the dq tiling (the small tile on its streamed axis, q),
    # unmirrored when sq != sk makes the swap non-dividing
    kq, kk = bk, bq
    if sq % min(kq, sq) or sk % min(kk, sk):
        kq, kk = bq, bk
    return Plan(fwd, "dq", "direct" if sq // min(kq, sq) == 1 else "stream")


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


def _scores(q, k, causal, scale, masks) -> torch.Tensor:
    """f32 scores ``[B, H, Sq, Sk]`` after ``_fwd_kernel_direct``'s masks,
    in its order."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    return _masked_scores(s, causal, masks)


def _dropped(p, keep):
    return p if keep is None else p * keep


def flash_packed_fwd_reference(q, k, v, causal: bool = False,
                               scale: Optional[float] = None,
                               masks: Masks = (None, None, None),
                               dropout: Optional[AttnDropout] = None,
                               *, first_head: int = 0
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K4a-direct: the same function as the kernel, in
    float32, with its rounding point (p, or ``p * keep`` with ``dropout``,
    rounded to v's dtype before the value product, divided by l after).
    ``masks`` as :func:`_masks` gives them. Returns ``(o [B, Sq, H, 64]`` in
    q's dtype, ``lse [B, H, Sq]`` float32)."""
    b, sq, sk, h = _shapes(q, k, v)
    scale = 1.0 / math.sqrt(HEAD_D) if scale is None else float(scale)
    s = _scores(q, k, causal, scale, masks)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * (s > NEG_INF / 2)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    p = _dropped(p, _keep(dropout, b, h, sq, sk, q.device, first_head))
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float()) / l
    lse = (m + torch.log(l))[..., 0]
    return o.transpose(1, 2).to(q.dtype), lse


def flash_packed_bwd_reference(q, k, v, o, lse, do, causal: bool = False,
                               scale: Optional[float] = None,
                               masks: Masks = (None, None, None),
                               dropout: Optional[AttnDropout] = None,
                               *, first_head: int = 0, mma_sums: bool = False
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Plain PyTorch K4b-fused: dq, dk and dv from one recompute of s and
    p, in float32, with ``_bwd_fused_kernel``'s rounding points (``ds`` to
    k's dtype before the dq and dk products, ``p`` to do's dtype before the
    dv product); with ``dropout``, dp and the dv product's p are scaled by
    ``keep``. A row with no valid key gives dq = 0 and adds nothing to
    dk/dv. ``mma_sums`` sums ``dp = dO v^T`` as the 16-bit tensor-core body
    does (:func:`mma_dot`), which is how the card holds that body to this
    (see :func:`flash_packed_bwd_dq_reference`). Returns the gradients in
    the input dtypes."""
    b, sq, sk, h = _shapes(q, k, v)
    scale = 1.0 / math.sqrt(HEAD_D) if scale is None else float(scale)
    delta = _delta(o, do)[..., None]                        # [B, H, Sq, 1]
    s = _scores(q, k, causal, scale, masks)
    p = torch.exp(s - lse.float()[..., None]) * (s > NEG_INF / 2)
    dp = mma_dot(do, v) if mma_sums else \
        torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    keep = _keep(dropout, b, h, sq, sk, q.device, first_head)
    dp, pv = _dropped(dp, keep), _dropped(p, keep)
    ds = (p * (dp - delta) * scale).to(k.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", pv.to(do.dtype).float(), do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _tiles(n: int):
    """The kernels' 64-wide tiles of a length ``n``, as slices in order."""
    return [slice(t, min(t + KERNEL_TILE, n))
            for t in range(0, n, KERNEL_TILE)]


def flash_packed_fwd_stream_reference(q, k, v, causal: bool = False,
                                      scale: Optional[float] = None,
                                      masks: Masks = (None, None, None),
                                      dropout: Optional[AttnDropout] = None,
                                      *, first_head: int = 0
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch ``flash_packed_fwd_stream``: ``_fwd_kernel``'s online
    softmax, which is K1's at head dim 64 with as many KV heads as heads, so
    this is K1's plain version (:func:`~.flash_attention.flash_fwd_reference`:
    the key stages of the body the dtype reaches, p against the running max
    rounded to v's dtype before the value product, ``p * keep`` with
    ``dropout`` while l sums the undropped p). Returns ``(o [B, Sq, H, 64]``
    in q's dtype, ``lse [B, H, Sq]`` float32)."""
    _shapes(q, k, v)
    return flash_fwd_reference(q, k, v, causal, scale, dropout,
                               first_head=first_head, masks=masks)


def _bwd_p_ds(q, k, v, do, lse, delta, causal, scale, masks, dropout,
              first_head, mma_sums=False):
    """The backward's recompute, ``[B, H, Sq, Sk]`` f32: the p of the dv
    product (``p = exp(s - lse)``, 0 where masked, times ``keep`` with
    ``dropout``) and ``ds = p (dp keep - delta) scale`` rounded to the
    input dtype, as ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` round it.
    With ``mma_sums``, ``dp = dO v^T`` is summed as :func:`mma_dot` sums
    it."""
    b, sq, sk, h = _shapes(q, k, v)
    s = _scores(q, k, causal, scale, masks)
    p = torch.exp(s - lse.float()[..., None]) * (s > NEG_INF / 2)
    dp = mma_dot(do, v) if mma_sums else \
        torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    keep = _keep(dropout, b, h, sq, sk, q.device, first_head)
    dp = _dropped(dp, keep)
    ds = (p * (dp - delta.float()[..., None]) * scale).to(q.dtype).float()
    return _dropped(p, keep), ds


def flash_packed_bwd_dq_reference(q, k, v, do, lse, delta,
                                  causal: bool = False,
                                  scale: Optional[float] = None,
                                  masks: Masks = (None, None, None),
                                  dropout: Optional[AttnDropout] = None,
                                  *, first_head: int = 0,
                                  mma_sums: bool = False) -> torch.Tensor:
    """Plain PyTorch ``flash_packed_bwd_dq``: ``dq = ds k`` summed over the
    kernel's 64-key tiles in order, in float32, from the forward's lse and
    ``delta`` (``[B, H, Sq]`` f32). ``mma_sums`` sums dp as the 16-bit
    tensor-core body does (:func:`mma_dot`), which is how the card holds
    that body to this: in a row whose every key carries the -1e9 padding
    bias, the f32 lse absorbs log l, so p = 1 at each key and ds is l times
    its usual size, and a dp summed in another order flips its bf16
    rounding by more than the comparison allows. Returns dq in q's
    dtype."""
    _shapes(q, k, v)
    scale = 1.0 / math.sqrt(HEAD_D) if scale is None else float(scale)
    _, ds = _bwd_p_ds(q, k, v, do, lse, delta, causal, scale, masks,
                      dropout, first_head, mma_sums)
    kf = k.float()
    dq = torch.zeros(q.shape, device=q.device)
    for t in _tiles(k.shape[1]):
        dq += torch.einsum("bhqk,bkhd->bqhd", ds[..., t], kf[:, t])
    return dq.to(q.dtype)


def _dkv_reference(q, k, v, do, lse, delta, causal, scale, masks, dropout,
                   first_head, mma_sums=False):
    _shapes(q, k, v)
    scale = 1.0 / math.sqrt(HEAD_D) if scale is None else float(scale)
    p, ds = _bwd_p_ds(q, k, v, do, lse, delta, causal, scale, masks,
                      dropout, first_head, mma_sums)
    pr = p.to(do.dtype).float()
    qf, dof = q.float(), do.float()
    dk = torch.zeros(k.shape, device=q.device)
    dv = torch.zeros(v.shape, device=q.device)
    for t in _tiles(q.shape[1]):
        dk += torch.einsum("bhqk,bqhd->bkhd", ds[:, :, t], qf[:, t])
        dv += torch.einsum("bhqk,bqhd->bkhd", pr[:, :, t], dof[:, t])
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_packed_bwd_dkv_reference(q, k, v, do, lse, delta,
                                   causal: bool = False,
                                   scale: Optional[float] = None,
                                   masks: Masks = (None, None, None),
                                   dropout: Optional[AttnDropout] = None,
                                   *, first_head: int = 0,
                                   mma_sums: bool = False
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch ``flash_packed_bwd_dkv``: ``dk = ds^T q`` and ``dv =
    (p rounded to do's dtype)^T do``, summed over the kernel's 64-query
    tiles in order, in float32. A row with no valid key adds nothing.
    ``mma_sums`` as :func:`flash_packed_bwd_dq_reference` takes it.
    Returns ``(dk, dv)`` in the input dtypes."""
    return _dkv_reference(q, k, v, do, lse, delta, causal, scale, masks,
                          dropout, first_head, mma_sums)


def flash_packed_bwd_dkv_direct_reference(
        q, k, v, do, lse, delta, causal: bool = False,
        scale: Optional[float] = None, masks: Masks = (None, None, None),
        dropout: Optional[AttnDropout] = None, *, first_head: int = 0,
        mma_sums: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch ``flash_packed_bwd_dkv_direct`` (``_bwd_dkv_kernel_
    direct``'s function, all queries in one tile): the same sums as
    :func:`flash_packed_bwd_dkv_reference`, in the same order; ``mma_sums``
    as there (the tensor-core body runs dk/dv-direct in 16 bits)."""
    return _dkv_reference(q, k, v, do, lse, delta, causal, scale, masks,
                          dropout, first_head, mma_sums)


def _kernel_arg_error(q, k, v, masks, do=None) -> Optional[str]:
    """Why the CUDA kernels cannot take these tensors, or None: K1-K3's
    limits on q, k, v (and do), at least one query and one key, and masks
    of the kernels' shapes and types."""
    _, sq, sk, _ = _shapes(q, k, v)
    why = kernel_arg_error(q, k, v, masks) if do is None else \
        _bwd_arg_error(q, k, v, do, masks)
    if why is None and (sq < 1 or sk < 1):
        why = f"shape {tuple(q.shape)} has no query or no key"
    return why


def _require(q, k, v, masks, what, do=None, max_sk: Optional[int] = None,
             max_sq: Optional[int] = None) -> None:
    """Raise unless the kernel ``what`` can take these tensors: CUDA, the
    kernels' limits on q, k, v (and do) and the masks, and the kernel's
    own bound on the lengths."""
    if q.device.type != "cuda":
        raise ValueError(f"{what} kernel runs on CUDA tensors, not "
                         f"{q.device}")
    why = _kernel_arg_error(q, k, v, masks, do)
    if why is None and max_sk is not None and k.shape[1] > max_sk:
        why = f"Sk = {k.shape[1]} > {max_sk}"
    if why is None and max_sq is not None and q.shape[1] > max_sq:
        why = f"Sq = {q.shape[1]} > {max_sq}"
    if why is not None:
        raise ValueError(f"{what} kernel cannot take these inputs: {why}")


def _require_stats(q, lse, delta, what) -> None:
    b, sq, h = q.shape[0], q.shape[1], q.shape[2]
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, h, sq) or t.dtype != torch.float32 or \
                not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{what}: {name} must be dense float32 "
                             f"[{b}, {h}, {sq}] on {q.device}")


def _launch_fwd(q, k, v, causal: bool, scale: float, masks: Masks,
                dropout: Optional[AttnDropout] = None):
    """K4a-direct on CUDA tensors: ``(o, lse)``, from the body of q's
    dtype: bf16 and float16 the tensor-core body (``flash_packed_tc.cu``,
    counted by :func:`flash_packed_fwd_tc`), float32 the CUDA-core body
    (``flash_packed.cu``, counted by :func:`flash_packed_fwd`). The
    tensor-core body reads rows by 16-byte copies: q, k and v must start on
    16 bytes and have batch, sequence and head strides of whole 8-value
    pieces."""
    tc = q.dtype in TC_DTYPES
    what = "flash_packed_fwd_tc" if tc else "flash_packed_fwd"
    _require(q, k, v, masks, what, max_sk=MAX_SEQ_K)
    if tc:
        require_aligned_rows(what, ("q", q), ("k", k), ("v", v))
    lib, fn = _kernel("flash_packed_tc" if tc else "flash_packed",
                      "paddle_" + what, 8, 9)
    b, sq, sk, h = _shapes(q, k, v)
    o = torch.empty((b, sq, h, HEAD_D), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    _call(lib, fn, what, q, k, q.data_ptr(), k.data_ptr(), v.data_ptr(),
          o.data_ptr(), lse.data_ptr(), *_mask_ptrs(masks), b, h, h, sq, sk,
          HEAD_D, *_strides(q, k, v), float(scale), int(bool(causal)),
          _DTYPE_CODE[q.dtype], *_dropout_args(dropout))
    (flash_packed_fwd_tc if tc else flash_packed_fwd).launches += 1
    return o, lse


def _launch_bwd(q, k, v, do, lse, delta, causal: bool, scale: float,
                masks: Masks, dropout: Optional[AttnDropout] = None,
                tc: Optional[bool] = None):
    """K4b-fused on CUDA tensors: ``(dq, dk, dv)`` in one launch from
    K4a's lse and ``delta`` (both dense ``[B, H, Sq]`` float32), from the
    tensor-core body (``tc``, the default for bf16 and float16:
    ``flash_bwd_tc.cu``, one cluster of ``fused_cluster_size(Sk)`` blocks a
    head, counted by :func:`flash_packed_bwd_tc`) or the CUDA-core body
    (``flash_packed.cu``, float32 and bf16, counted by
    :func:`flash_packed_bwd`). Both sum dq over the key tiles in float32 in
    a fixed order (no atomics), so results repeat bit for bit."""
    tc = q.dtype in TC_DTYPES if tc is None else tc
    what = "flash_packed_bwd_tc" if tc else "flash_packed_bwd"
    _require(q, k, v, masks, what, do, max_sk=MAX_SEQ_K)
    _require_stats(q, lse, delta, what)
    if do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} is not q's shape "
                         f"{tuple(q.shape)}")
    b, sq, sk, h = _shapes(q, k, v)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if tc:
        require_aligned_rows(what, ("q", q), ("k", k), ("v", v), ("do", do))
        lib, fn = _kernel("flash_bwd_tc", "paddle_flash_packed_bwd_fused_tc",
                          12, 12)
        _call(lib, fn, what, q, k, q.data_ptr(), k.data_ptr(),
              v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
              *_mask_ptrs(masks), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
              b, h, h, sq, sk, HEAD_D, *_strides(q, k, v, do), float(scale),
              int(bool(causal)), _DTYPE_CODE[q.dtype],
              *_dropout_args(dropout))
        flash_packed_bwd_tc.launches += 1
        return dq, dk, dv
    if q.dtype == torch.float16:
        raise ValueError("flash_packed_bwd's CUDA-core body takes float32 "
                         "and bfloat16; float16 runs the tensor-core body")
    lib, fn = _kernel("flash_packed", "paddle_flash_packed_bwd", 13, 12)
    # the f32 sum of dq over key tiles; in f32 dq itself holds it
    dq_acc = dq if q.dtype == torch.float32 else \
        torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _call(lib, fn, "flash_packed_bwd", q, k, q.data_ptr(), k.data_ptr(),
          v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
          *_mask_ptrs(masks), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
          dq_acc.data_ptr(), b, h, h, sq, sk, HEAD_D,
          *_strides(q, k, v, do), float(scale), int(bool(causal)),
          _DTYPE_CODE[q.dtype], *_dropout_args(dropout))
    flash_packed_bwd.launches += 1
    return dq, dk, dv


def _launch_fwd_stream(q, k, v, causal: bool, scale: float, masks: Masks,
                       dropout: Optional[AttnDropout] = None):
    """``flash_packed_fwd_stream`` on CUDA tensors: ``(o, lse)``, from the
    body of q's dtype: bf16 and float16 the tensor-core body (K1's,
    ``flash_fwd_tc.cu``, counted by :func:`flash_packed_fwd_stream_tc`),
    float32 the CUDA-core body (``flash_packed_stream.cu``, counted by
    :func:`flash_packed_fwd_stream`)."""
    tc = q.dtype in TC_DTYPES
    what = "flash_packed_fwd_stream_tc" if tc else "flash_packed_fwd_stream"
    _require(q, k, v, masks, what)
    if tc:
        require_aligned_rows(what, ("q", q), ("k", k), ("v", v))
    lib, fn = _kernel("flash_fwd_tc" if tc else "flash_packed_stream",
                      "paddle_" + what, 8, 9)
    b, sq, sk, h = _shapes(q, k, v)
    o = torch.empty((b, sq, h, HEAD_D), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    _call(lib, fn, what, q, k, q.data_ptr(),
          k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
          *_mask_ptrs(masks), b, h, h, sq, sk, HEAD_D, *_strides(q, k, v),
          float(scale), int(bool(causal)), _DTYPE_CODE[q.dtype],
          *_dropout_args(dropout))
    (flash_packed_fwd_stream_tc if tc else
     flash_packed_fwd_stream).launches += 1
    return o, lse


def _launch_bwd_split(which: str, q, k, v, do, lse, delta, causal: bool,
                      scale: float, masks: Masks,
                      dropout: Optional[AttnDropout] = None,
                      tc: Optional[bool] = None):
    """One of the streamed backward kernels on CUDA tensors, from the
    forward's lse and ``delta`` (both dense ``[B, H, Sq]`` float32):
    ``"dq"`` -> dq, ``"dkv"`` or ``"dkv_direct"`` -> ``(dk, dv)``. Each
    runs the body of q's dtype: bf16 and float16 the tensor-core bodies
    (K2's and K3's, ``flash_bwd_tc.cu``, at KV heads = heads, counted by
    :func:`flash_packed_bwd_dq_tc`, :func:`flash_packed_bwd_dkv_tc` and
    :func:`flash_packed_bwd_dkv_direct_tc`: dk/dv-direct is K3's function
    with all the queries in one tile; q, k, v and do rows 16-byte aligned),
    float32 the CUDA-core bodies (``flash_packed_stream.cu``, counted by
    :func:`flash_packed_bwd_dq`, :func:`flash_packed_bwd_dkv` and
    :func:`flash_packed_bwd_dkv_direct`). ``tc=False`` runs dk/dv-direct's
    CUDA-core body in 16 bits too, a yardstick that no path takes (counted
    by :func:`flash_packed_bwd_dkv_direct`). Each block owns its output
    tile and sums in a fixed order (no atomics), so results repeat bit for
    bit."""
    if tc is None:
        tc = q.dtype in TC_DTYPES
    elif not tc and which != "dkv_direct" and q.dtype in TC_DTYPES:
        raise ValueError(f"the streamed {which} has no 16-bit CUDA-core "
                         f"body")
    what = f"flash_packed_bwd_{which}" + ("_tc" if tc else "")
    _require(q, k, v, masks, what, do, max_sq=MAX_SEQ_Q_DIRECT
             if which == "dkv_direct" else None)
    _require_stats(q, lse, delta, what)
    if do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} is not q's shape "
                         f"{tuple(q.shape)}")
    if tc:
        require_aligned_rows(what, ("q", q), ("k", k), ("v", v), ("do", do))
    b, sq, sk, h = _shapes(q, k, v)
    if which == "dq":
        outs = [torch.empty(q.shape, dtype=q.dtype, device=q.device)]
    else:
        outs = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
                for t in (k, v)]
    # dk/dv-direct's tensor-core body is dk/dv's (K3's)
    stem, entry = ("flash_bwd_tc", "paddle_flash_bwd_{}_tc".format(
        "dkv" if which == "dkv_direct" else which)) if tc \
        else ("flash_packed_stream", "paddle_" + what)
    lib, fn = _kernel(stem, entry, 9 + len(outs), 12)
    _call(lib, fn, what, q, k, q.data_ptr(), k.data_ptr(), v.data_ptr(),
          do.data_ptr(), lse.data_ptr(), delta.data_ptr(), *_mask_ptrs(masks),
          *(t.data_ptr() for t in outs), b, h, h, sq, sk, HEAD_D,
          *_strides(q, k, v, do), float(scale), int(bool(causal)),
          _DTYPE_CODE[q.dtype], *_dropout_args(dropout))
    {"flash_packed_bwd_dq": flash_packed_bwd_dq,
     "flash_packed_bwd_dq_tc": flash_packed_bwd_dq_tc,
     "flash_packed_bwd_dkv": flash_packed_bwd_dkv,
     "flash_packed_bwd_dkv_tc": flash_packed_bwd_dkv_tc,
     "flash_packed_bwd_dkv_direct": flash_packed_bwd_dkv_direct,
     "flash_packed_bwd_dkv_direct_tc": flash_packed_bwd_dkv_direct_tc}[
         what].launches += 1
    return outs[0] if which == "dq" else tuple(outs)


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


def _require_16bit(q, what: str, plain: str) -> None:
    if q.dtype not in TC_DTYPES:
        raise ValueError(f"{what} takes bfloat16 or float16, not {q.dtype} "
                         f"({plain} runs float32 on its CUDA-core body)")


def flash_packed_fwd(q, k, v, causal: bool = False,
                     scale: Optional[float] = None,
                     masks: Masks = (None, None, None),
                     dropout: Optional[AttnDropout] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4a-direct: for CUDA tensors the kernel body of their dtype (bf16
    and float16 the tensor-core body, float32 the CUDA-core body), for CPU
    tensors the
    plain version. Not differentiable itself (:func:`flash_attention_packed`
    is). Returns ``(o [B, Sq, H, 64], lse [B, H, Sq] float32)``."""
    dev = _same_device(q, k, v, *masks)
    scale = 1.0 / math.sqrt(HEAD_D) if scale is None else float(scale)
    if dev.type == "cpu":
        return flash_packed_fwd_reference(q, k, v, causal, scale, masks,
                                          dropout)
    return _launch_fwd(q, k, v, causal, scale, masks, dropout)


def flash_packed_fwd_tc(q, k, v, causal: bool = False,
                        scale: Optional[float] = None,
                        masks: Masks = (None, None, None),
                        dropout: Optional[AttnDropout] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4a-direct's tensor-core body (bf16 and float16): the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors.
    :func:`flash_packed_fwd` reaches it for every 16-bit CUDA input."""
    dev = _same_device(q, k, v, *masks)
    scale = 1.0 / math.sqrt(HEAD_D) if scale is None else float(scale)
    if dev.type == "cpu":
        return flash_packed_fwd_reference(q, k, v, causal, scale, masks,
                                          dropout)
    _require_16bit(q, "flash_packed_fwd_tc", "flash_packed_fwd")
    return _launch_fwd(q, k, v, causal, scale, masks, dropout)


def flash_packed_bwd(q, k, v, o, lse, do, causal: bool = False,
                     scale: Optional[float] = None,
                     masks: Masks = (None, None, None),
                     dropout: Optional[AttnDropout] = None
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
                                          scale, masks, dropout)
    return _launch_bwd(q, k, v, do, lse.float().contiguous(), _delta(o, do),
                       causal, scale, masks, dropout)


def flash_packed_bwd_tc(q, k, v, o, lse, do, causal: bool = False,
                        scale: Optional[float] = None,
                        masks: Masks = (None, None, None),
                        dropout: Optional[AttnDropout] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4b-fused's tensor-core body (bf16 and float16), arguments as
    :func:`flash_packed_bwd`: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. :func:`flash_packed_bwd` reaches it for every
    16-bit CUDA input."""
    if q.device.type != "cpu":
        _require_16bit(q, "flash_packed_bwd_tc", "flash_packed_bwd")
    return flash_packed_bwd(q, k, v, o, lse, do, causal, scale, masks,
                            dropout)


def flash_packed_fwd_stream(q, k, v, causal: bool = False,
                            scale: Optional[float] = None,
                            masks: Masks = (None, None, None),
                            dropout: Optional[AttnDropout] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The streamed forward (``_fwd_kernel``): the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. Returns ``(o [B, Sq, H,
    64], lse [B, H, Sq] float32)``."""
    dev = _same_device(q, k, v, *masks)
    scale = 1.0 / math.sqrt(HEAD_D) if scale is None else float(scale)
    if dev.type == "cpu":
        return flash_packed_fwd_stream_reference(q, k, v, causal, scale,
                                                 masks, dropout)
    return _launch_fwd_stream(q, k, v, causal, scale, masks, dropout)


def flash_packed_fwd_stream_tc(q, k, v, causal: bool = False,
                               scale: Optional[float] = None,
                               masks: Masks = (None, None, None),
                               dropout: Optional[AttnDropout] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The streamed forward's tensor-core body (bf16 and float16; K1's body
    at head dim 64): the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. :func:`flash_packed_fwd_stream` reaches it for every 16-bit
    CUDA input."""
    dev = _same_device(q, k, v, *masks)
    scale = 1.0 / math.sqrt(HEAD_D) if scale is None else float(scale)
    if dev.type == "cpu":
        return flash_packed_fwd_stream_reference(q, k, v, causal, scale,
                                                 masks, dropout)
    _require_16bit(q, "flash_packed_fwd_stream_tc", "flash_packed_fwd_stream")
    return _launch_fwd_stream(q, k, v, causal, scale, masks, dropout)


def _bwd_inputs(q, k, v, do, lse, delta, masks):
    dev = _same_device(q, k, v, do, lse, delta, *masks)
    if do.shape != q.shape:
        raise ValueError(f"do must have q's shape {tuple(q.shape)}; got "
                         f"{tuple(do.shape)}")
    return dev


def flash_packed_bwd_dq(q, k, v, do, lse, delta, causal: bool = False,
                        scale: Optional[float] = None,
                        masks: Masks = (None, None, None),
                        dropout: Optional[AttnDropout] = None
                        ) -> torch.Tensor:
    """The streamed dq (``_bwd_dq_kernel``) from the forward's ``lse`` and
    ``delta = rowsum(do * o)`` (``[B, H, Sq]`` float32): for CUDA tensors
    the kernel body of their dtype (bf16 and float16 the tensor-core body,
    float32 the CUDA-core body), for CPU tensors the plain version."""
    dev = _bwd_inputs(q, k, v, do, lse, delta, masks)
    scale = 1.0 / math.sqrt(HEAD_D) if scale is None else float(scale)
    if dev.type == "cpu":
        return flash_packed_bwd_dq_reference(q, k, v, do, lse, delta, causal,
                                             scale, masks, dropout)
    return _launch_bwd_split("dq", q, k, v, do, lse, delta, causal, scale,
                             masks, dropout)


def flash_packed_bwd_dq_tc(q, k, v, do, lse, delta, causal: bool = False,
                           scale: Optional[float] = None,
                           masks: Masks = (None, None, None),
                           dropout: Optional[AttnDropout] = None
                           ) -> torch.Tensor:
    """The streamed dq's tensor-core body (bf16 and float16), arguments as
    :func:`flash_packed_bwd_dq`: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. :func:`flash_packed_bwd_dq` reaches it for
    every 16-bit CUDA input."""
    dev = _bwd_inputs(q, k, v, do, lse, delta, masks)
    scale = 1.0 / math.sqrt(HEAD_D) if scale is None else float(scale)
    if dev.type == "cpu":
        return flash_packed_bwd_dq_reference(q, k, v, do, lse, delta, causal,
                                             scale, masks, dropout)
    _require_16bit(q, "flash_packed_bwd_dq_tc", "flash_packed_bwd_dq")
    return _launch_bwd_split("dq", q, k, v, do, lse, delta, causal, scale,
                             masks, dropout)


def flash_packed_bwd_dkv(q, k, v, do, lse, delta, causal: bool = False,
                         scale: Optional[float] = None,
                         masks: Masks = (None, None, None),
                         dropout: Optional[AttnDropout] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The streamed dk/dv (``_bwd_dkv_kernel``), arguments as
    :func:`flash_packed_bwd_dq` (and the body chosen as it chooses).
    Returns ``(dk, dv)``."""
    dev = _bwd_inputs(q, k, v, do, lse, delta, masks)
    scale = 1.0 / math.sqrt(HEAD_D) if scale is None else float(scale)
    if dev.type == "cpu":
        return flash_packed_bwd_dkv_reference(q, k, v, do, lse, delta,
                                              causal, scale, masks, dropout)
    return _launch_bwd_split("dkv", q, k, v, do, lse, delta, causal, scale,
                             masks, dropout)


def flash_packed_bwd_dkv_tc(q, k, v, do, lse, delta, causal: bool = False,
                            scale: Optional[float] = None,
                            masks: Masks = (None, None, None),
                            dropout: Optional[AttnDropout] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The streamed dk/dv's tensor-core body (bf16 and float16), arguments
    as
    :func:`flash_packed_bwd_dq`: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. :func:`flash_packed_bwd_dkv` reaches it for
    every 16-bit CUDA input. Returns ``(dk, dv)``."""
    dev = _bwd_inputs(q, k, v, do, lse, delta, masks)
    scale = 1.0 / math.sqrt(HEAD_D) if scale is None else float(scale)
    if dev.type == "cpu":
        return flash_packed_bwd_dkv_reference(q, k, v, do, lse, delta,
                                              causal, scale, masks, dropout)
    _require_16bit(q, "flash_packed_bwd_dkv_tc", "flash_packed_bwd_dkv")
    return _launch_bwd_split("dkv", q, k, v, do, lse, delta, causal, scale,
                             masks, dropout)


def flash_packed_bwd_dkv_direct(q, k, v, do, lse, delta,
                                causal: bool = False,
                                scale: Optional[float] = None,
                                masks: Masks = (None, None, None),
                                dropout: Optional[AttnDropout] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk/dv with all the queries in one tile (``_bwd_dkv_kernel_direct``;
    the kernel takes Sq <= 512), arguments as :func:`flash_packed_bwd_dq`
    (and the body chosen as it chooses). Returns ``(dk, dv)``."""
    dev = _bwd_inputs(q, k, v, do, lse, delta, masks)
    scale = 1.0 / math.sqrt(HEAD_D) if scale is None else float(scale)
    if dev.type == "cpu":
        return flash_packed_bwd_dkv_direct_reference(q, k, v, do, lse, delta,
                                                     causal, scale, masks,
                                                     dropout)
    return _launch_bwd_split("dkv_direct", q, k, v, do, lse, delta, causal,
                             scale, masks, dropout)


def flash_packed_bwd_dkv_direct_tc(q, k, v, do, lse, delta,
                                   causal: bool = False,
                                   scale: Optional[float] = None,
                                   masks: Masks = (None, None, None),
                                   dropout: Optional[AttnDropout] = None
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk/dv-direct's tensor-core body (bf16 and float16; K3's), arguments
    as :func:`flash_packed_bwd_dq`: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. :func:`flash_packed_bwd_dkv_direct`
    reaches it for every 16-bit CUDA input. Returns ``(dk, dv)``."""
    dev = _bwd_inputs(q, k, v, do, lse, delta, masks)
    scale = 1.0 / math.sqrt(HEAD_D) if scale is None else float(scale)
    if dev.type == "cpu":
        return flash_packed_bwd_dkv_direct_reference(q, k, v, do, lse, delta,
                                                     causal, scale, masks,
                                                     dropout)
    _require_16bit(q, "flash_packed_bwd_dkv_direct_tc",
                   "flash_packed_bwd_dkv_direct")
    return _launch_bwd_split("dkv_direct", q, k, v, do, lse, delta, causal,
                             scale, masks, dropout)


@torch.library.custom_op("paddle_tpu_torch::flash_packed_fwd",
                         mutates_args=())
def flash_packed_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        seg_q: Optional[torch.Tensor],
                        seg_k: Optional[torch.Tensor],
                        bias: Optional[torch.Tensor], causal: bool,
                        scale: float, stream: bool, rate: float, seed: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's forward as one operator, ``torch.ops.paddle_tpu_torch.
    flash_packed_fwd``: K4a-direct (``stream`` False) or the streamed
    forward, the kernel on CUDA tensors and the plain version on CPU
    tensors; dropout as ``(rate, seed)``, off at rate 0. Built as K1's
    ``flash_fwd`` operator is: the ctypes launch is invisible to the
    dispatcher, the operator is seen, so an activation-recompute policy can
    keep ``(o, lse)`` from the forward instead of launching K4's forward
    again in the backward (the JAX kernel names them ``flash_out`` and
    ``flash_lse`` for its policies). Not differentiable itself:
    :func:`flash_attention_packed` wraps it."""
    dropout = AttnDropout(rate, seed) if rate > 0.0 else None
    fwd = flash_packed_fwd_stream if stream else flash_packed_fwd
    return fwd(q, k, v, causal, scale, (seg_q, seg_k, bias), dropout)


class _FlashPacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_k, bias, causal, scale, forms,
                dropout):
        masks = (seg_q, seg_k, bias)
        rate, seed = (0.0, 0) if dropout is None else dropout
        o, lse = torch.ops.paddle_tpu_torch.flash_packed_fwd(
            q, k, v, seg_q, seg_k, bias, causal, scale,
            forms.fwd == "stream", float(rate), int(seed))
        ctx.save_for_backward(q, k, v, o, lse, *(
            torch.empty(0) if t is None else t for t in masks))
        ctx.has_mask = tuple(t is not None for t in masks)
        ctx.causal, ctx.scale, ctx.forms = causal, scale, forms
        ctx.dropout = dropout   # the seed and rate regenerate the mask
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, *saved = ctx.saved_tensors
        masks = tuple(t if has else None
                      for t, has in zip(saved, ctx.has_mask))
        if do.stride(-1) != 1:   # e.g. the expanded ones of out.sum()
            do = do.contiguous()
        forms, drop = ctx.forms, ctx.dropout
        if forms.bwd == "fused":
            dq, dk, dv = flash_packed_bwd(q, k, v, o, lse, do, ctx.causal,
                                          ctx.scale, masks, drop)
        else:
            # delta stays a torch op, as _bwd computes it (:531-533)
            delta, lse = _delta(o, do), lse.float().contiguous()
            dq = flash_packed_bwd_dq(q, k, v, do, lse, delta, ctx.causal,
                                     ctx.scale, masks, drop)
            dkv = flash_packed_bwd_dkv_direct if forms.dkv == "direct" \
                else flash_packed_bwd_dkv
            dk, dv = dkv(q, k, v, do, lse, delta, ctx.causal, ctx.scale,
                         masks, drop)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_attention_packed(query, key, value, causal: bool = False,
                           scale: Optional[float] = None,
                           block_q: Optional[int] = None,
                           block_k: Optional[int] = None, segment_ids=None,
                           segment_ids_k=None, dropout: float = 0.0,
                           dropout_seed=None, key_bias=None) -> torch.Tensor:
    """``[B, S, H, 64]`` flash attention through the K4 forms that JAX's
    ``flash_attention_packed`` runs for the same input (:func:`plan`):
    K4a-direct and K4b-fused when all the keys fit one of its tiles, else
    the streamed forward, dq and dk/dv (dk/dv-direct when all the queries
    fit one). ``block_q``/``block_k`` pin JAX's tiles of both directions,
    as there, and so choose the forms. Equal to ``flash_attention_pallas``
    on d=64 MHA shapes; the JAX package routes those here when
    ``pack_group(H)`` is non-zero. ``segment_ids`` ``[B, Sq]`` (and
    ``segment_ids_k`` ``[B, Sk]``) keep attention within equal ids;
    ``key_bias`` ``[B, Sk]`` is added to every query's scores. ``dropout``
    is attention-prob dropout in the kernels, seeded by ``dropout_seed``
    (an int32; drawn from the next key when None, as ``:792-796`` draws
    it)."""
    b, sq, sk, h = _shapes(query, key, value)
    forms = plan(sq, sk, h, block_q, block_k)
    scale = 1.0 / math.sqrt(HEAD_D) if scale is None else float(scale)
    masks = _masks(b, sq, sk, query.device, segment_ids, segment_ids_k,
                   key_bias)
    return _FlashPacked.apply(query, key, value, *masks, bool(causal), scale,
                              forms, as_dropout(dropout, dropout_seed))


#: kernel launches since each count was last set to 0 (CUDA path only);
#: flash_packed_fwd, flash_packed_bwd, flash_packed_fwd_stream,
#: flash_packed_bwd_dq, flash_packed_bwd_dkv and flash_packed_bwd_dkv_direct
#: count their float32 bodies (flash_packed_bwd and
#: flash_packed_bwd_dkv_direct also their 16-bit yardsticks, ``tc=False``),
#: the ``_tc`` names their 16-bit tensor-core bodies
flash_packed_fwd.launches = 0
flash_packed_fwd_tc.launches = 0
flash_packed_bwd.launches = 0
flash_packed_bwd_tc.launches = 0
flash_packed_fwd_stream.launches = 0
flash_packed_fwd_stream_tc.launches = 0
flash_packed_bwd_dq.launches = 0
flash_packed_bwd_dq_tc.launches = 0
flash_packed_bwd_dkv.launches = 0
flash_packed_bwd_dkv_tc.launches = 0
flash_packed_bwd_dkv_direct.launches = 0
flash_packed_bwd_dkv_direct_tc.launches = 0
