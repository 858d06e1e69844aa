"""K1, the flash-attention forward, on Hopper: wrapper and plain version.

Port of ``paddle_tpu/ops/_pallas/flash_attention.py`` (``_fwd`` driving
``_fwd_kernel``). The kernel is ``csrc/flash_fwd.cu``, built by ``nvcc`` at
first use (:mod:`.build`) and called through ``ctypes``.

``flash_fwd(q, k, v, causal, scale) -> (o, lse)`` takes the public
``[B, S, H, D]`` layout (k/v may have fewer heads, ``HK`` dividing ``H``)
and returns ``o [B, Sq, H, D]`` in the input dtype and ``lse [B, H, Sq]``
in float32 — the JAX kernel's ``[B*H, 1, Sq]`` lse, unflattened.

- On a CUDA tensor it launches the kernel, or raises on anything the
  kernel does not take (head dim outside {64, 128, 256}, a dtype other
  than float32 or bfloat16, a last dimension that is not dense). Each
  launch adds one to ``flash_fwd.launches``.
- On a CPU tensor it runs :func:`flash_fwd_reference`, the plain PyTorch
  version of the same function.

It is an autograd function whose backward raises: the backward kernels
(K2, K3) are not ported yet, and nothing differentiates silently through
the plain version.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

__all__ = ["flash_fwd", "flash_fwd_reference", "kernel_arg_error",
           "NEG_INF", "SUPPORTED_HEAD_DIMS"]

NEG_INF = -1e30  # the TPU kernel's masked score, kept for its lse convention
SUPPORTED_HEAD_DIMS = (64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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


def kernel_arg_error(q, k, v) -> Optional[str]:
    """Why the CUDA kernel cannot take these tensors, or None. Device
    aside, these are the kernel's limits; the plain version has none."""
    b, sq, sk, h, hk, d = _shapes(q, k, v)
    if d not in SUPPORTED_HEAD_DIMS:
        return f"head dim {d} not in {SUPPORTED_HEAD_DIMS}"
    if q.dtype not in _DTYPE_CODE:
        return f"dtype {q.dtype} is not float32 or bfloat16"
    if k.dtype != q.dtype or v.dtype != q.dtype:
        return f"q, k, v dtypes differ ({q.dtype}, {k.dtype}, {v.dtype})"
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            return f"{name}'s last dimension is not dense (stride " \
                   f"{t.stride(3)})"
    if max(sq, sk) >= 2 ** 31 or b * h >= 65536:
        return f"shape {tuple(q.shape)} exceeds the kernel's grid"
    return None


def flash_fwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K1: the same function as the kernel, in float32.

    Bottom-right causal, grouped-query KV by head reshape (no repeat),
    masked scores at ``NEG_INF`` and the kernel's masked-row convention
    (o = 0, lse = NEG_INF + log(1e-30)). Returns ``(o [B, Sq, H, D]`` in
    q's dtype, ``lse [B, H, Sq]`` float32)."""
    b, sq, sk, h, hk, d = _shapes(q, k, v)
    g = h // hk
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    qf = q.float().reshape(b, sq, hk, g, d)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf) * scale   # [B,HK,G,Sq,Sk]
    valid = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        valid = torch.tril(valid, diagonal=sk - sq)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True) if sk else \
        torch.full(s.shape[:-1] + (1,), NEG_INF, device=q.device)
    p = torch.where(s > NEG_INF / 2, torch.exp(s - m), torch.zeros_like(s))
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, vf) / \
        l.permute(0, 3, 1, 2, 4)
    lse = (m + torch.log(l))[..., 0].reshape(b, h, sq)
    return o.reshape(b, sq, h, d).to(q.dtype), lse


def _launch(q, k, v, causal: bool, scale: float):
    from .build import library
    lib = library("flash_fwd")
    fn = lib.paddle_flash_fwd
    if fn.argtypes is None:
        # without argtypes ctypes passes every int as 32 bits and cuts
        # the pointers
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 +
                       [ctypes.c_longlong] * 9 +
                       [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                        ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.paddle_cuda_error_string.argtypes = [ctypes.c_int]
        lib.paddle_cuda_error_string.restype = ctypes.c_char_p
    b, sq, sk, h, hk, d = _shapes(q, k, v)
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), b, h, hk, sq, sk, d,
                 q.stride(0), q.stride(1), q.stride(2),
                 k.stride(0), k.stride(1), k.stride(2),
                 v.stride(0), v.stride(1), v.stride(2),
                 float(scale), int(bool(causal)), _DTYPE_CODE[q.dtype],
                 stream)
    if err != 0:
        msg = lib.paddle_cuda_error_string(err).decode()
        raise RuntimeError(f"flash_fwd kernel launch failed: {msg} "
                           f"(cudaError {err}) for q {tuple(q.shape)} "
                           f"{q.dtype}, k {tuple(k.shape)}")
    flash_fwd.launches += 1
    return o, lse


class _FlashFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        if q.device.type == "cpu":
            o, lse = flash_fwd_reference(q, k, v, causal, scale)
        else:
            o, lse = _launch(q, k, v, causal, scale)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        raise NotImplementedError("K2/K3 not yet ported")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False, scale: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 forward: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. Returns ``(o [B, Sq, H, D], lse [B, H, Sq] float32)``."""
    _shapes(q, k, v)
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"q, k, v on different devices: {devices}")
    if q.device.type == "cuda":
        why = kernel_arg_error(q, k, v)
        if why is not None:
            raise ValueError(f"flash_fwd kernel cannot take these inputs: "
                             f"{why}")
    elif q.device.type != "cpu":
        raise ValueError(f"flash_fwd runs on CUDA or the CPU, not "
                         f"{q.device}")
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    return _FlashFwd.apply(q, k, v, bool(causal), scale)


#: kernel launches since the count was last set to 0 (CUDA path only)
flash_fwd.launches = 0
