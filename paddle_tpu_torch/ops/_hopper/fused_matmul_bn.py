"""Fused 1x1-conv (matmul) + BatchNorm apply + ReLU + stats on Hopper: K9.

Port of ``paddle_tpu/ops/_pallas/fused_matmul_bn.py``: ``_fwd`` driving
``_fwd_kernel`` (K9, ``pallas_call`` at ``:76``) and the custom VJP around
it. :func:`fused_matmul_bn_act` keeps the JAX signature::

    y, s, ss = fused_matmul_bn_act(x, w, scale, shift,
                                   prologue="scale_shift_relu", stats=True)

with ``x [M, Cin]`` (bf16, float16 or f32), ``w [Cin, Cout]`` of x's dtype,
``scale``/``shift [Cin]`` and ``prologue`` one of ``"none"``,
``"scale_shift"`` and ``"scale_shift_relu"``: ``y = P(x) @ w`` in x's
dtype, and the f32 per-column ``(sum, sumsq)`` of the f32 product.

The kernel. K9's body computes, one row at a time, what K5's ``_mm_kernel``
computes one pixel at a time: scale and shift rounded to x's type, the
product, the sum, ReLU, the f32 product with w, y rounded, and the stats
from the f32 accumulator. So its Hopper kernel is K5's (``csrc/conv.cu``),
launched through its own C entry ``paddle_fused_matmul_bn_fwd`` on x as the
1x1 conv of a ``[1, 1, M, Cin]`` image: in bf16 and float16 K5's
tensor-core body ``conv1x1_tc_kernel`` on the tiles of ``conv.k5_plan``, in
float32 its CUDA-core body ``conv1x1_kernel``; the prologues map to K5's
as ``none`` -> no scale and shift,
``scale_shift`` -> act ``none``, ``scale_shift_relu`` -> act ``relu``. It
computes every row: the JAX ``_fwd`` takes ``M // block_m`` row blocks and
leaves the rows past the last whole block unwritten, so ``block_m`` is taken
here and changes nothing.

The backward is the JAX one (``:128-157``, jnp there, torch ops here): the
stats cotangents fold into ``dy`` as ``ds + 2 y dss`` with y recomputed in
x's dtype, ``da = dy @ wᵀ``, ``dw = P(x)ᵀ @ dy``, ReLU's mask ``P(x) > 0``,
``dscale = Σ da·x`` and ``dshift = Σ da`` in f32, ``dx = da·scale``; no
scale or shift gradient for ``none``. A stats output that the loss does not
use gets a zero cotangent, as JAX hands its VJP.

On a CUDA tensor the forward launches the kernel, or raises on what it does
not take; each launch adds one to ``fused_matmul_bn_fwd.launches``. On a CPU
tensor :func:`fused_matmul_bn_act_reference`, the plain version, runs.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .conv import (_DTYPE_CODE, _FWD_ROWS, _check, _device, _ptr, _run,
                   _stat_scratch, k5_plan)

__all__ = ["fused_matmul_bn_act", "fused_matmul_bn_act_reference",
           "fused_matmul_bn_fwd", "PROLOGUES"]

PROLOGUES = ("none", "scale_shift", "scale_shift_relu")

Out = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _prologue(x, scale, shift, prologue: str) -> torch.Tensor:
    """``P(x)`` in x's dtype: scale and shift rounded to it (through f32,
    as ``_fwd`` hands them over), the product, the sum, then ReLU."""
    if prologue == "none":
        return x
    xb = x * scale.float().to(x.dtype) + shift.float().to(x.dtype)
    return torch.clamp_min(xb, 0) if prologue == "scale_shift_relu" else xb


def fused_matmul_bn_act_reference(x, w, scale, shift,
                                  prologue: str = "scale_shift_relu",
                                  stats: bool = True) -> Out:
    """Plain K9: ``(y [M, Cout]`` in x's dtype, ``sum``, ``sumsq [Cout]``
    f32 of the f32 product; zeros without ``stats``)."""
    acc = _prologue(x, scale, shift, prologue).float() @ w.float()
    if stats:
        s, ss = acc.sum(0), (acc * acc).sum(0)
    else:
        s = torch.zeros(w.shape[1], dtype=torch.float32, device=x.device)
        ss = s.clone()
    return acc.to(x.dtype), s, ss


_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


def _library():
    from .build import library
    lib = library("conv")
    fn = lib.paddle_fused_matmul_bn_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGS
        fn.restype = ctypes.c_int
        lib.paddle_cuda_error_string.argtypes = [ctypes.c_int]
        lib.paddle_cuda_error_string.restype = ctypes.c_char_p
    return lib


def fused_matmul_bn_fwd(x, w, scale, shift,
                        prologue: str = "scale_shift_relu",
                        stats: bool = True) -> Out:
    """K9's forward: the kernel for CUDA tensors (K5's body through
    ``paddle_fused_matmul_bn_fwd``: ``conv1x1_tc_kernel`` in 16 bits,
    ``conv1x1_kernel`` in float32), the plain version for CPU tensors. Not
    differentiable itself (:func:`fused_matmul_bn_act` is)."""
    if _device(x, w, scale, shift).type == "cpu":
        return fused_matmul_bn_act_reference(x, w, scale, shift, prologue,
                                             stats)
    what = "fused_matmul_bn (K9)"
    m, cin = x.shape
    cout = w.shape[1]
    if prologue == "none":
        scale = shift = None
    else:
        scale = scale.float().contiguous()
        shift = shift.float().contiguous()
    _check(what, x.reshape(1, 1, m, cin), (("x", x), ("w", w)), scale,
           shift)
    y = torch.empty((m, cout), dtype=x.dtype, device=x.device)
    # the row blocks of the body that runs: K5's plan in 16 bits, 128-row
    # blocks in float32
    if x.dtype == torch.float32:
        warps_m = warps_n = stages = 0
        blocks = -(-m // _FWD_ROWS)
    else:
        warps_m, warps_n, _, blocks, _, stages = k5_plan(m, cin, cout)
    partial, tmp, st = _stat_scratch(blocks, cout, x.device) if stats else \
        (None, None, None)
    lib = _library()
    _run(lib, lib.paddle_fused_matmul_bn_fwd, what, x, x.data_ptr(),
         w.data_ptr(), _ptr(scale), _ptr(shift), y.data_ptr(), _ptr(partial),
         _ptr(tmp), _ptr(st), m, cin, cout,
         int(prologue == "scale_shift_relu"), int(stats), warps_m, warps_n,
         stages, _DTYPE_CODE[x.dtype])
    fused_matmul_bn_fwd.launches += 1
    if not stats:
        z = torch.zeros(cout, dtype=torch.float32, device=x.device)
        return y, z, z.clone()
    return y, st[:cout], st[cout:]


class _FusedMatmulBn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, scale, shift, prologue, stats):
        out = fused_matmul_bn_fwd(x, w, scale, shift, prologue, stats)
        ctx.save_for_backward(x, w, scale, shift)
        ctx.prologue, ctx.stats = prologue, stats
        return out

    @staticmethod
    def backward(ctx, dy, ds, dss):
        x, w, scale, shift = ctx.saved_tensors
        prologue = ctx.prologue
        xb = _prologue(x, scale, shift, prologue)
        if ctx.stats:
            # d/dy (s·ds + ss·dss) = ds + 2 y dss, y recomputed in x's dtype
            y = xb @ w
            dy = (dy.float() + ds.float()[None, :] + 2.0 * y.float() *
                  dss.float()[None, :]).to(x.dtype)
        da = dy @ w.T.to(dy.dtype)
        dw = (xb.T @ dy).to(w.dtype)
        if prologue == "none":
            return da.to(x.dtype), dw, None, None, None, None
        if prologue == "scale_shift_relu":
            da = da * (xb > 0)
        daf = da.float()
        dscale = (daf * x.float()).sum(0)
        dshift = daf.sum(0)
        dx = (da * scale.to(da.dtype)).to(x.dtype)
        return dx, dw, dscale, dshift, None, None


def fused_matmul_bn_act(x: torch.Tensor, w: torch.Tensor,
                        scale: Optional[torch.Tensor],
                        shift: Optional[torch.Tensor],
                        prologue: str = "scale_shift_relu",
                        stats: bool = True, block_m: int = 512) -> Out:
    """``P(x) @ w`` with per-column output stats, one pass over x (the JAX
    function's signature; ``block_m`` is the TPU's row tile and changes
    nothing here). Differentiable in x, w, scale and shift. Returns ``(y
    [M, Cout]`` in x's dtype, ``sum [Cout]``, ``sumsq [Cout]`` f32)."""
    if prologue not in PROLOGUES:
        raise ValueError(f"prologue must be one of {PROLOGUES}; got "
                         f"{prologue!r}")
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"fused_matmul_bn_act takes x [M, Cin] and w [Cin, "
                         f"Cout]; got x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")
    if w.dtype != x.dtype:
        raise ValueError(f"x and w dtypes differ ({x.dtype}, {w.dtype})")
    if prologue != "none":
        for name, t in (("scale", scale), ("shift", shift)):
            if t is None or t.shape != (x.shape[1],):
                raise ValueError(f"{name} must be [{x.shape[1]}] for "
                                 f"prologue {prologue!r}")
    if not block_m > 0:
        raise ValueError(f"block_m must be positive; got {block_m}")
    return _FusedMatmulBn.apply(x, w, scale, shift, prologue, bool(stats))


#: kernel launches since the count was last set to 0 (CUDA path only)
fused_matmul_bn_fwd.launches = 0
