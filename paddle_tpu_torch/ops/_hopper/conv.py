"""The conv kernel family on Hopper: K5-K8, with the BN prologue and the
stat epilogue in the kernel.

Port of ``paddle_tpu/ops/_pallas/conv.py``: ``_mm_kernel`` (K5, launched by
``_mm``), ``_mm_wgrad_kernel`` (K6, ``_mm_wgrad``), ``_c3_kernel`` (K7,
``_c3``) and ``_c3_wgrad_kernel`` (K8, ``_c3_wgrad``), as
``csrc/conv.cu``, built by ``nvcc`` at first use and called through
``ctypes`` like K1-K4. Layouts are the JAX package's: NHWC activations,
OIHW weights.

- :func:`mm` (K5): ``y = act(x·scale+shift) @ w2`` over the pixels of ``x``
  (``x[:, ::2, ::2]`` at stride 2, read in place), plus the per-channel
  f32 ``(sum, sumsq)`` of the f32 product; also the 1x1 input gradient. In
  16 bits persistent blocks walk tiles of 256 x 64, 128 x 128 or 64 x 256
  rows x output channels (:func:`k5_plan`), so that x is read and
  prologued about once, fed by a ``cp.async`` ring that runs across tiles;
  :func:`mm_tiles64` is the body it had before (128 x 64 tiles), kept as a
  yardstick that no path runs.
- :func:`mm_wgrad` (K6): ``act(x·scale+shift)ᵀ @ dy`` in f32; in 16 bits
  on tiles of up to 256 x 64 or 128 x 128 channels fed by a ``cp.async``
  ring (:func:`k6_plan`); :func:`mm_wgrad_tiles64` is the body it had
  before (64 x 64 tiles), kept as a yardstick that no path runs.
- :func:`c3` (K7): the NHWC 3x3 conv with zero padding 1 (the prologue
  masked to the image), stride 1 or 2, plus the stats; also the 3x3 input
  gradient at stride 1 (rotated taps). In 16 bits a block walks bands of
  output pixels under one window of x (:func:`c3_bands`);
  :func:`c3_tap_gather` is the body it had before, a yardstick.
- :func:`c3_dgrad_phases` (K7): the 16-bit stride-2 3x3 input gradient by
  output phase, one launch of K7's body with no dilated dy
  (:func:`c3_dgrad_phases_reference` its plain version); float32 keeps
  ``conv2d_dgrad``'s dilated operand on the CUDA-core body.
- :func:`c3_wgrad` (K8): per-tap ``aᵀ @ dy`` as ``[9, C, K]`` f32; in 16
  bits one block holds all nine taps of its channel tile and walks bands of
  output rows (:func:`wgrad_bands`), as ``_c3_wgrad_kernel`` does;
  :func:`c3_wgrad_tap_blocks` is the body it had before (one block a tap),
  kept as a yardstick that no path runs.
- :func:`conv2d_fwd`, :func:`conv2d_dgrad`, :func:`conv2d_wgrad`: the
  host entries, with JAX's signatures (less the TPU's block sizes and
  ``interpret``); :func:`conv2d`, the differentiable conv with no prologue.
- :func:`supports`: whether a conv takes this route; :func:`fwd_weight`
  and :func:`dgrad_operands`, the operands the host entries hand to the
  kernels.

The kernels take float32 (CUDA cores), bf16 and float16 (tensor cores), as
JAX's ``supports`` takes any floating dtype. The prologue rounds where the
TPU kernels round, in x's type: scale and shift to it, then the product,
then the sum, then ReLU. The stats come from the f32
accumulator before y is rounded (the library route takes them from the
rounded y; in float32 the two agree).

**One difference from the JAX routing.** JAX's ``supports`` also applies
the TPU's 16 MB scoped-VMEM rule (``analysis/pallas_check.py``), which at
ResNet-50's B = 256 sends four of its 52 convs to ``lax`` (the 3x3 512 ->
512 at 14^2 stride 2 and at 7^2 twice, the 1024 -> 2048 downsample at 14^2).
The H100 has no such rule: :func:`supports` checks only the shape family,
so all 52 run on the kernels. What a unit computes does not depend on the
route (``nn/fused_conv_bn.py``), so the two packages still compute the same
function.

On a CUDA tensor each wrapper launches its kernel, or raises on anything it
does not take; each launch adds one to the wrapper's ``launches``. On a CPU
tensor the plain PyTorch versions (``*_reference``) run instead. Nothing
falls back from one to the other. The autotune cache is ``autotune.py``;
``tune_conv_shapes`` is not ported yet (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as TF

__all__ = ["conv2d", "conv2d_fwd", "conv2d_dgrad", "conv2d_wgrad",
           "supports", "pallas_conv_enabled", "mm", "mm_reference",
           "mm_wgrad", "mm_wgrad_reference", "c3", "c3_reference",
           "c3_wgrad", "c3_wgrad_reference", "c3_wgrad_tap_blocks",
           "wgrad_bands", "WgradBands", "band_box", "fwd_weight",
           "dgrad_operands", "dgrad_taps", "c3_tap_gather",
           "c3_dgrad_phases", "c3_dgrad_phases_reference", "c3_bands",
           "C3Bands", "c3_item_box", "k7_smem_bytes", "mm_wgrad_tiles64",
           "k6_plan", "K6Plan", "k5_plan", "K5Plan", "k5_smem_bytes",
           "mm_tiles64", "RESNET50_TOP3_SHAPES", "RESNET50_K5_SHAPES",
           "RESNET50_K6_SHAPES", "RESNET50_K7_SHAPES",
           "RESNET50_K8_SHAPES"]

# The JAX package's per-shape A/B shapes (conv.py:72-76): (kind, n, h, w,
# cin, cout, stride)
RESNET50_TOP3_SHAPES = (
    ("conv1x1", 256, 56, 56, 256, 64, 1),
    ("conv1x1", 256, 56, 56, 64, 256, 1),
    ("conv3x3", 256, 56, 56, 64, 64, 1),
)

#: ResNet-50's 3x3 weight gradients at B = 256 (NHWC 224^2 input,
#: space-to-depth stem): (n, h, w, cin, cout, stride, launches a step), 16
#: launches in all, each 5.9e10 FLOPs
RESNET50_K8_SHAPES = (
    (256, 56, 56, 64, 64, 1, 3),
    (256, 56, 56, 128, 128, 2, 1),
    (256, 28, 28, 128, 128, 1, 3),
    (256, 28, 28, 256, 256, 2, 1),
    (256, 14, 14, 256, 256, 1, 5),
    (256, 14, 14, 512, 512, 2, 1),
    (256, 7, 7, 512, 512, 1, 2),
)

#: ResNet-50's 3x3 convs, whose forwards and input gradients K7 runs (16 +
#: 16 launches a step): the same 16 convs as K8's
RESNET50_K7_SHAPES = RESNET50_K8_SHAPES

#: ResNet-50's 1x1 weight gradients at B = 256 (K6): (n, h, w, cin, cout,
#: stride, launches a step), h the input's size; 36 launches in 15 shapes:
#: each bottleneck's conv1 and conv3 and each stage's strided downsample
RESNET50_K6_SHAPES = (
    (256, 56, 56, 64, 64, 1, 1),
    (256, 56, 56, 64, 256, 1, 4),
    (256, 56, 56, 256, 64, 1, 2),
    (256, 56, 56, 256, 128, 1, 1),
    (256, 28, 28, 128, 512, 1, 4),
    (256, 28, 28, 512, 128, 1, 3),
    (256, 56, 56, 256, 512, 2, 1),
    (256, 28, 28, 512, 256, 1, 1),
    (256, 14, 14, 256, 1024, 1, 6),
    (256, 14, 14, 1024, 256, 1, 5),
    (256, 28, 28, 512, 1024, 2, 1),
    (256, 14, 14, 1024, 512, 1, 1),
    (256, 7, 7, 512, 2048, 1, 3),
    (256, 7, 7, 2048, 512, 1, 2),
    (256, 14, 14, 1024, 2048, 2, 1),
)

#: ResNet-50's 1x1 convs at B = 256, whose forwards and input gradients K5
#: runs (36 + 36 launches a step): the same 15 convs as K6's
RESNET50_K5_SHAPES = RESNET50_K6_SHAPES

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_FWD_ROWS = 128        # rows of an f32 K5/K7 block (kBM in csrc/conv.cu)
_REDUCE_CHUNK = 256    # rows one reduce pass sums (kReduceChunk)
_WGRAD_STEP = 32       # rows a K6/K8 split is a multiple of (kTK)
_WGRAD_BLOCKS = 1024   # about this many K6/K8 blocks, by splitting M
_WGRAD_MIN_ROWS = 512  # but no split shorter than this
# K8's 16-bit body (conv3x3_wgrad_tc_kernel): a block's channel tile, the
# output pixels a band may hold, the widest band, the shared memory kept
# for two band buffers, and the blocks it aims at (at most two waves of 132
# SMs at one block an SM: a third, mostly idle wave cost the 512-channel
# shapes a fifth)
_K8_TILE = 64
_K8_MAX_PIX = 256
_K8_MAX_BAND_W = 64
_K8_SMEM = 200 * 1024
_K8_BLOCKS = 2 * 132
# the shared memory a block may take (the H100's per-block limit)
_BLOCK_SMEM = 232448
# K7's 16-bit body (conv3x3_tc_kernel): the output pixels a band may hold,
# the widest band, a block's output channels
_K7_MAX_PIX = 256
_K7_MAX_BAND_W = 64
_K7_TILE = 64
# K6's 16-bit body (conv1x1_wgrad_tc_kernel): the warp layouts of a block
# (warps_c x warps_k, each warp 64 input x 32 output channels), the warps
# resident on an SM, the SMs, and no split shorter than this many rows
_K6_LAYOUTS = ((4, 2), (2, 4), (1, 8), (2, 2), (1, 4), (4, 1), (2, 1),
               (1, 2), (1, 1))
_K6_SM_WARPS = 16
_SMS = 132
_K6_MIN_ROWS = 128
# K5's 16-bit body (conv1x1_tc_kernel): the warp layouts of a block (warps_m
# x warps_n, each warp 64 rows x 32 output channels, at most 128 registers a
# thread, so two blocks of 8 warps an SM), its stages of 32 input channels,
# the ring's depths, the bytes of shared memory an SM holds and each
# block's reserve
_K5_LAYOUTS = ((4, 2), (2, 4), (1, 8))
_K5_STAGE = 32
_K5_RINGS = (4, 3)
_SM_SMEM = 233472
_BLOCK_RESERVE = 1024


def pallas_conv_enabled() -> bool:
    """``FLAGS_pallas_conv`` (the JAX name; here it routes to K5-K8)."""
    from ...core import flags
    return bool(flags.flag("pallas_conv"))


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (list, tuple)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


def supports(x_shape, w_shape, stride=(1, 1), padding=(0, 0),
             dilation=(1, 1), groups: int = 1, dtype=torch.float32) -> bool:
    """The shape family of the kernels: NHWC ``x_shape``, OIHW ``w_shape``
    with ``w_shape[1] == x_shape[3]``; 1x1 with padding 0, or 3x3 with
    padding 1; stride 1 or 2 (the same on both axes); no groups or
    dilation; a floating dtype. No memory rule (see the module's
    docstring)."""
    if len(x_shape) != 4 or len(w_shape) != 4:
        return False
    if groups != 1 or _pair(dilation) != (1, 1):
        return False
    kk, cin_w, kh, kw = w_shape
    if kh != kw or kh not in (1, 3) or x_shape[3] != cin_w:
        return False
    s = _pair(stride)
    if s not in ((1, 1), (2, 2)):
        return False
    if _pair(padding) != ((0, 0) if kh == 1 else (1, 1)):
        return False
    if kh == 3 and (x_shape[1] + 2 - 3) // s[0] + 1 < 1:
        return False
    return torch.empty((), dtype=dtype).is_floating_point()


# ---------------------------------------------------------------------------
# Plain PyTorch versions: the same functions as the kernels, in float32 with
# the kernels' rounding points
# ---------------------------------------------------------------------------

def _prologue(x, scale, shift, act: str):
    """``act(x·scale+shift)`` in x's type, scale and shift rounded to it
    first (``:148``); x itself without a prologue."""
    if scale is None:
        return x
    a = x * scale.to(x.dtype) + shift.to(x.dtype)
    return torch.clamp_min(a, 0) if act == "relu" else a


def _stats(acc: torch.Tensor, stats: bool):
    if not stats:
        z = torch.zeros(acc.shape[-1], dtype=torch.float32,
                        device=acc.device)
        return z, z.clone()
    return acc.sum(0), (acc * acc).sum(0)


def mm_reference(x, w2, scale=None, shift=None, act: str = "none",
                 stats: bool = True, stride: int = 1):
    """Plain K5: ``x [N, H, W, C]`` (its ``[:, ::stride, ::stride]``
    pixels), ``w2 [C, K]``. Returns ``(y [N, Ho, Wo, K]`` in x's type,
    ``s [K]``, ``ss [K]`` f32, zeros without ``stats``)."""
    xs = x[:, ::stride, ::stride]
    n, h, w, c = xs.shape
    a = _prologue(xs, scale, shift, act).reshape(-1, c)
    acc = a.float() @ w2.float()
    s, ss = _stats(acc, stats)
    return acc.to(x.dtype).reshape(n, h, w, w2.shape[1]), s, ss


def mm_wgrad_reference(x, dy, scale=None, shift=None, act: str = "none",
                       stride: int = 1):
    """Plain K6: ``act(x·scale+shift)ᵀ @ dy`` as ``[C, K]`` f32."""
    xs = x[:, ::stride, ::stride]
    a = _prologue(xs, scale, shift, act).reshape(-1, xs.shape[3])
    return a.float().T @ dy.reshape(-1, dy.shape[3]).float()


def _padded(x, scale, shift, act, stride, out_hw):
    """The prologued image with zero padding 1 on the top and left and as
    much on the bottom and right as ``out_hw`` rows and columns at
    ``stride`` need (``_c3_prologue``: the border stays 0), in float32."""
    ho, wo = out_hw
    a = _prologue(x, scale, shift, act).float()
    hp, wp = (ho - 1) * stride + 3, (wo - 1) * stride + 3
    ap = TF.pad(a, (0, 0, 1, max(0, wp - 1 - x.shape[2]), 1,
                    max(0, hp - 1 - x.shape[1])))
    return ap[:, :hp, :wp]


def _tap(ap, t: int, stride: int, out_hw):
    dh, dw = divmod(t, 3)
    ho, wo = out_hw
    return ap[:, dh:dh + (ho - 1) * stride + 1:stride,
              dw:dw + (wo - 1) * stride + 1:stride]


def c3_reference(x, wt, scale=None, shift=None, act: str = "none",
                 stats: bool = True, stride: int = 1, out_hw=None):
    """Plain K7: ``x [N, H, W, C]`` zero-padded by 1 (the prologue only
    inside the image), ``wt [9, C, K]`` tap matrices, ``out_hw`` the output
    size (default ``(H + 2 - 3) // stride + 1`` each). One float32 product
    per tap. Returns ``(y [N, Ho, Wo, K]`` in x's type, ``s``, ``ss``)."""
    out_hw = out_hw or tuple((d + 2 - 3) // stride + 1 for d in x.shape[1:3])
    ap = _padded(x, scale, shift, act, stride, out_hw)
    n, c, k = x.shape[0], x.shape[3], wt.shape[2]
    acc = torch.zeros(n * out_hw[0] * out_hw[1], k, dtype=torch.float32,
                      device=x.device)
    for t in range(9):
        acc += _tap(ap, t, stride, out_hw).reshape(-1, c) @ wt[t].float()
    s, ss = _stats(acc, stats)
    return acc.to(x.dtype).reshape(n, *out_hw, k), s, ss


def _phase_taps(ph: int):
    """The taps of dx phase ``ph`` along one axis as (offset in dy, tap
    index): phase 0 meets dy at tap 1 only, phase 1 at taps 0 and 2."""
    return ((0, 1),) if ph == 0 else ((0, 0), (1, 2))


def c3_dgrad_phases_reference(dy, wt, x_hw):
    """Plain K7 stride-2 input gradient by phase: ``dy [N, Ho, Wo, K]``,
    ``wt [9, K, C]`` the rotated taps (:func:`dgrad_taps`), ``x_hw`` the
    input's ``(H, W)`` with ``Ho = ceil(H / 2)``. dx pixel ``(2a + ph, 2b
    + pw)`` sums ``dy[a + jr, b + jc] @ wt[3 dh + dw]`` over its phase's
    taps in the dilated form's order, in float32 (dy past its last row or
    column is the dilated form's zero padding); one rounding to dy's type.
    Returns ``dx [N, H, W, C]``."""
    n, ho, wo, k = dy.shape
    h, w = x_hw
    if (ho, wo) != ((h + 1) // 2, (w + 1) // 2):
        raise ValueError(f"dy {tuple(dy.shape)} is not the stride-2 output "
                         f"of a {h}x{w} input")
    c = wt.shape[2]
    dyp = TF.pad(dy.float(), (0, 0, 0, 1, 0, 1))
    dx = torch.zeros((n, h, w, c), dtype=torch.float32, device=dy.device)
    for ph in (0, 1):
        for pw in (0, 1):
            hp, wp = (h - ph + 1) // 2, (w - pw + 1) // 2
            acc = torch.zeros(n * hp * wp, c, dtype=torch.float32,
                              device=dy.device)
            for jr, dh in _phase_taps(ph):
                for jc, dw in _phase_taps(pw):
                    acc += dyp[:, jr:jr + hp, jc:jc + wp].reshape(-1, k) @ \
                        wt[3 * dh + dw].float()
            dx[:, ph::2, pw::2] = acc.reshape(n, hp, wp, c)
    return dx.to(dy.dtype)


def c3_wgrad_reference(x, dy, scale=None, shift=None, act: str = "none",
                       stride: int = 1):
    """Plain K8: per tap ``aᵀ @ dy`` over all output pixels, ``[9, C, K]``
    f32, the prologue recomputed and masked to the image."""
    out_hw = tuple(dy.shape[1:3])
    ap = _padded(x, scale, shift, act, stride, out_hw)
    c, k = x.shape[3], dy.shape[3]
    dy2 = dy.reshape(-1, k).float()
    return torch.stack([_tap(ap, t, stride, out_hw).reshape(-1, c).T @ dy2
                        for t in range(9)])


# ---------------------------------------------------------------------------
# Kernel launches (CUDA tensors)
# ---------------------------------------------------------------------------

# pointers, then the ints of the C entries, then the stream
_FWD_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
_WGRAD_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 14 + [ctypes.c_void_p]
_WGRAD_TC_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 15 + \
    [ctypes.c_void_p]
_C3_TC_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 15 + [ctypes.c_void_p]
_WGRAD1_TC_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 14 + \
    [ctypes.c_void_p]
_K5_TC_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 14 + [ctypes.c_void_p]


def _library():
    """conv.cu's library with its entries' argtypes set (without them
    ctypes passes every int as 32 bits and cuts the pointers)."""
    from .build import library
    lib = library("conv")
    if lib.paddle_conv_fwd.argtypes is None:
        lib.paddle_conv_fwd.argtypes = _FWD_ARGS
        lib.paddle_conv_fwd.restype = ctypes.c_int
        lib.paddle_conv_wgrad.argtypes = _WGRAD_ARGS
        lib.paddle_conv_wgrad.restype = ctypes.c_int
        lib.paddle_conv3x3_wgrad_tc.argtypes = _WGRAD_TC_ARGS
        lib.paddle_conv3x3_wgrad_tc.restype = ctypes.c_int
        lib.paddle_conv3x3_wgrad_tc_smem.argtypes = [ctypes.c_int] * 4
        lib.paddle_conv3x3_wgrad_tc_smem.restype = ctypes.c_int
        lib.paddle_conv3x3_tc.argtypes = _C3_TC_ARGS
        lib.paddle_conv3x3_tc.restype = ctypes.c_int
        lib.paddle_conv3x3_tc_smem.argtypes = [ctypes.c_int] * 5
        lib.paddle_conv3x3_tc_smem.restype = ctypes.c_int
        lib.paddle_conv1x1_wgrad_tc.argtypes = _WGRAD1_TC_ARGS
        lib.paddle_conv1x1_wgrad_tc.restype = ctypes.c_int
        lib.paddle_conv1x1_tc.argtypes = _K5_TC_ARGS
        lib.paddle_conv1x1_tc.restype = ctypes.c_int
        lib.paddle_conv1x1_tc_smem.argtypes = [ctypes.c_int] * 5
        lib.paddle_conv1x1_tc_smem.restype = ctypes.c_int
        lib.paddle_cuda_error_string.argtypes = [ctypes.c_int]
        lib.paddle_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check(what: str, x, others: Sequence, scale, shift) -> None:
    """Raise unless the kernel can take these tensors: checked before any
    pointer reaches it."""
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"{what}: dtype {x.dtype} is not float32, bfloat16 "
                         f"or float16")
    for name, t in (("x", x), *others):
        if t.dtype != x.dtype or t.device != x.device or \
                not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a dense {x.dtype} "
                             f"tensor on {x.device}; got {t.dtype}, "
                             f"{tuple(t.shape)} on {t.device}")
    if (scale is None) != (shift is None):
        raise ValueError(f"{what}: scale and shift go together")
    if scale is not None:
        c = x.shape[3]
        for name, t in (("scale", scale), ("shift", shift)):
            if t.dtype != torch.float32 or t.shape != (c,) or \
                    t.device != x.device or not t.is_contiguous():
                raise ValueError(f"{what}: {name} must be dense float32 "
                                 f"[{c}] on {x.device}")


def _run(lib, fn, what: str, x, *args) -> None:
    """``fn(*args, stream)`` on x's device; raise on a refused launch (it
    never runs, and a synchronise would not report it)."""
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        msg = lib.paddle_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} (cudaError "
                           f"{err}) for x {tuple(x.shape)} {x.dtype}")


def _stat_scratch(blocks: int, k: int, device):
    """The f32 buffers of K5/K7's stats over ``k`` channels: one partial
    ``(sum, sumsq)`` row for each of the ``blocks`` row blocks (or bands) of
    the plan that launches the body, the reduction's pass buffer, and the
    result ``[2k]``."""
    return (torch.empty((blocks, 2 * k), dtype=torch.float32, device=device),
            torch.empty((-(-blocks // _REDUCE_CHUNK), 2 * k),
                        dtype=torch.float32, device=device),
            torch.empty(2 * k, dtype=torch.float32, device=device))


def _fwd_launch(lib, what, x, wt, scale, shift, act, stats, stride, pad,
                out_hw):
    """K5 (``wt`` [1, C, K]) or K7 (``wt`` [9, C, K]) on x [N, H, W, C]."""
    _check(what, x, (("wt", wt),), scale, shift)
    n, h, w, c = x.shape
    taps, k = wt.shape[0], wt.shape[2]
    if wt.shape[1] != c:
        raise ValueError(f"{what}: wt {tuple(wt.shape)} does not take "
                         f"{c} input channels")
    ho, wo = out_hw
    y = torch.empty((n, ho, wo, k), dtype=x.dtype, device=x.device)
    partial, tmp, st = _stat_scratch(-(-n * ho * wo // _FWD_ROWS), k,
                                     x.device) if stats \
        else (None, None, None)
    _run(lib, lib.paddle_conv_fwd, what, x, x.data_ptr(), wt.data_ptr(),
         _ptr(scale), _ptr(shift), y.data_ptr(), _ptr(partial), _ptr(tmp),
         _ptr(st), n, h, w, c, ho, wo, k, taps, stride, pad,
         int(act == "relu"), int(stats), _DTYPE_CODE[x.dtype])
    if not stats:
        z = torch.zeros(k, dtype=torch.float32, device=x.device)
        return y, z, z.clone()
    return y, st[:k], st[k:]


def wgrad_splits(m: int, tiles: int) -> Tuple[int, int]:
    """``(splits, rows_per_split)`` of K6/K8's split of M rows: about
    ``_WGRAD_BLOCKS`` blocks over ``tiles`` output tiles, each split at
    least ``_WGRAD_MIN_ROWS`` rows, a multiple of the kernel's step."""
    splits = max(1, min(-(-_WGRAD_BLOCKS // tiles), m // _WGRAD_MIN_ROWS,
                        65535))
    rows = -(-m // splits)
    rows = -(-rows // _WGRAD_STEP) * _WGRAD_STEP
    return -(-m // rows), rows


class WgradBands(NamedTuple):
    """K8's cut of the output pixels (16-bit body): bands of ``band_n``
    images x ``band_h`` output rows x ``band_w`` columns (``band_n`` > 1
    only for whole images), ``n_bn`` across the batch, ``n_bh`` down and
    ``n_bw`` across each image, in that order; split z walks bands ``[z *
    per_split, (z + 1) * per_split)`` of the ``bands``, ``splits`` in
    all."""
    band_n: int
    band_h: int
    band_w: int
    n_bn: int
    n_bh: int
    n_bw: int
    bands: int
    per_split: int
    splits: int


def k8_smem_bytes(band_n: int, band_h: int, band_w: int,
                  stride: int) -> int:
    """Shared memory of a K8 block (``band_smem_bytes`` in conv.cu): two
    buffers of the band's x windows and dy rows, 72 16-bit values a pixel,
    and the prologue's scale and shift (f32 and as packed pairs)."""
    win = ((band_h - 1) * stride + 3) * ((band_w - 1) * stride + 3)
    rows = -(-band_n * band_h * band_w // 16) * 16
    return 2 * 2 * (band_n * win + rows) * 72 + 2 * 64 * 4 + 64 * 4


def wgrad_bands(n: int, ho: int, wo: int, c: int, k: int,
                stride: int) -> WgradBands:
    """K8's bands and split for dy ``[n, ho, wo, k]`` of x with ``c``
    channels, a function of the shape only. A band is up to 64 output
    columns and as many whole rows as keep it within 256 pixels (four rows
    at 56², nine at 28²), or as many whole images (five 7² images), fewer
    where the two buffers would pass 200 KB; the split gives about two
    waves of blocks over the channel tiles (no more), each split the same
    number of consecutive bands."""
    band_w = min(wo, _K8_MAX_BAND_W)
    band_h = max(1, min(ho, _K8_MAX_PIX // band_w))

    def fits(bn, bh, bw):
        return k8_smem_bytes(bn, bh, bw, stride) <= _K8_SMEM

    while band_h > 1 and not fits(1, band_h, band_w):
        band_h -= 1
    while band_w > 1 and not fits(1, band_h, band_w):
        band_w -= 1
    band_n = 1
    if band_h == ho and band_w == wo:
        band_n = max(1, min(n, _K8_MAX_PIX // (ho * wo)))
        while band_n > 1 and not fits(band_n, band_h, band_w):
            band_n -= 1
    n_bn, n_bh, n_bw = -(-n // band_n), -(-ho // band_h), -(-wo // band_w)
    bands = n_bn * n_bh * n_bw
    tiles = -(-c // _K8_TILE) * -(-k // _K8_TILE)
    splits = max(1, min(bands, _K8_BLOCKS // tiles, 65535))
    per_split = -(-bands // splits)
    return WgradBands(band_n, band_h, band_w, n_bn, n_bh, n_bw, bands,
                      per_split, -(-bands // per_split))


def band_box(bands: WgradBands, n: int, ho: int, wo: int, band: int):
    """Band ``band``'s output pixels as the kernel finds them (``band_of``
    in conv.cu): ``(first image, images, first row, rows, first column,
    columns)``, walked image by image, then row by row."""
    per_n = bands.n_bh * bands.n_bw
    bn, rem = divmod(band, per_n)
    hb, wb = divmod(rem, bands.n_bw)
    n0, h0, w0 = bn * bands.band_n, hb * bands.band_h, wb * bands.band_w
    return (n0, min(bands.band_n, n - n0), h0, min(bands.band_h, ho - h0),
            w0, min(bands.band_w, wo - w0))


def _wgrad_tc_launch(lib, what, x, dy, scale, shift, act, stride):
    """K8's 16-bit body: ``[9, C, K]`` float32."""
    _check(what, x, (("dy", dy),), scale, shift)
    n, h, w, c = x.shape
    _, ho, wo, k = dy.shape
    if dy.shape[0] != n:
        raise ValueError(f"{what}: dy {tuple(dy.shape)} and x "
                         f"{tuple(x.shape)} differ in batch")
    bd = wgrad_bands(n, ho, wo, c, k, stride)
    dw = torch.empty((9, c, k), dtype=torch.float32, device=x.device)
    partial = tmp = None
    if bd.splits > 1:
        partial = torch.empty((bd.splits, 9 * c * k), dtype=torch.float32,
                              device=x.device)
        tmp = torch.empty((-(-bd.splits // _REDUCE_CHUNK), 9 * c * k),
                          dtype=torch.float32, device=x.device)
    _run(lib, lib.paddle_conv3x3_wgrad_tc, what, x, x.data_ptr(),
         dy.data_ptr(), _ptr(scale), _ptr(shift), dw.data_ptr(),
         _ptr(partial), _ptr(tmp), n, h, w, c, ho, wo, k, stride,
         int(act == "relu"), bd.band_n, bd.band_h, bd.band_w, bd.per_split,
         bd.splits, _DTYPE_CODE[x.dtype])
    return dw


def _wgrad_launch(lib, what, x, dy, scale, shift, act, stride, pad, taps):
    """K6 (taps 1) or K8 (taps 9): ``[taps, C, K]`` float32."""
    _check(what, x, (("dy", dy),), scale, shift)
    n, h, w, c = x.shape
    _, ho, wo, k = dy.shape
    if dy.shape[0] != n:
        raise ValueError(f"{what}: dy {tuple(dy.shape)} and x "
                         f"{tuple(x.shape)} differ in batch")
    m = n * ho * wo
    tiles = taps * -(-c // 64) * -(-k // 64)
    splits, rows = wgrad_splits(m, tiles)
    dw = torch.empty((taps, c, k), dtype=torch.float32, device=x.device)
    partial = tmp = None
    if splits > 1:
        partial = torch.empty((splits, taps * c * k), dtype=torch.float32,
                              device=x.device)
        tmp = torch.empty((-(-splits // _REDUCE_CHUNK), taps * c * k),
                          dtype=torch.float32, device=x.device)
    _run(lib, lib.paddle_conv_wgrad, what, x, x.data_ptr(), dy.data_ptr(),
         _ptr(scale), _ptr(shift), dw.data_ptr(), _ptr(partial), _ptr(tmp),
         n, h, w, c, ho, wo, k, taps, stride, pad, int(act == "relu"),
         splits, rows, _DTYPE_CODE[x.dtype])
    return dw


class C3Bands(NamedTuple):
    """K7's cut of the output pixels (16-bit body): bands of ``band_n``
    images x ``band_h`` rows x ``band_w`` columns (``band_n`` > 1 only for
    whole images) of the band grid (y's size; phase (0, 0)'s for the
    stride-2 input gradient), ``n_bn`` across the batch, ``n_bh`` down and
    ``n_bw`` across, in that order: ``bands`` in all."""
    band_n: int
    band_h: int
    band_w: int
    n_bn: int
    n_bh: int
    n_bw: int
    bands: int


def k7_smem_bytes(band_n: int, band_h: int, band_w: int, stride: int,
                  phases: int = 1) -> int:
    """Shared memory of a K7 block (``win_smem_bytes`` in conv.cu): two
    buffers, each the nine tap slices (32 x 72 16-bit values) and the
    band's windows (40 16-bit values a pixel), then the stats' cross-warp
    sums. A window is ``(band_h - 1) s + 3`` rows by ``(band_w - 1) s + 3``
    columns, or ``band_h + 1`` by ``band_w + 1`` by phases."""
    s, ext = (1, 2) if phases == 4 else (stride, 3)
    win = ((band_h - 1) * s + ext) * ((band_w - 1) * s + ext)
    return 2 * 2 * (9 * 32 * 72 + band_n * win * 40) + 2 * 4 * 64 * 4


def c3_bands(n: int, hg: int, wg: int, stride: int,
             phases: int = 1) -> C3Bands:
    """K7's bands over an ``n x hg x wg`` grid of output pixels, a function
    of the shape only: up to 64 columns and as many whole rows as keep a
    band within 256 pixels (four rows at 56², nine at 28²), or as many
    whole images (five 7² images), fewer where the block's shared memory
    would pass the card's 227 KB (seven rows at stride 2 from 56², four 7²
    images at stride 2 from 14²)."""
    band_w = min(wg, _K7_MAX_BAND_W)
    band_h = max(1, min(hg, _K7_MAX_PIX // band_w))

    def fits(bn, bh, bw):
        return k7_smem_bytes(bn, bh, bw, stride, phases) <= _BLOCK_SMEM

    while band_h > 1 and not fits(1, band_h, band_w):
        band_h -= 1
    while band_w > 1 and not fits(1, band_h, band_w):
        band_w -= 1
    band_n = 1
    if band_h == hg and band_w == wg:
        band_n = max(1, min(n, _K7_MAX_PIX // (hg * wg)))
        while band_n > 1 and not fits(band_n, band_h, band_w):
            band_n -= 1
    n_bn, n_bh, n_bw = -(-n // band_n), -(-hg // band_h), -(-wg // band_w)
    return C3Bands(band_n, band_h, band_w, n_bn, n_bh, n_bw,
                   n_bn * n_bh * n_bw)


def c3_item_box(bands: C3Bands, n: int, hy: int, wy: int, k: int,
                phases: int, item: int):
    """Item ``item`` of K7's walk as the kernel finds it (``win_item`` in
    conv.cu; phase-major with the four-tap phase first, then band, then
    64-channel tile): ``(ph, pw, first output channel, first image,
    images, first row, rows, first column, columns)`` of the band grid,
    clipped to the phase's grid (y itself for ``phases`` 1), or None for an
    empty band."""
    tiles = -(-k // _K7_TILE)
    pi, rem = divmod(item, bands.bands * tiles)
    band, nt = divmod(rem, tiles)
    phase = 3 - pi if phases == 4 else 0
    ph, pw = divmod(phase, 2)
    bn, r2 = divmod(band, bands.n_bh * bands.n_bw)
    hb, wb = divmod(r2, bands.n_bw)
    n0, h0, w0 = bn * bands.band_n, hb * bands.band_h, wb * bands.band_w
    hp = (hy - ph + 1) // 2 if phases == 4 else hy
    wp = (wy - pw + 1) // 2 if phases == 4 else wy
    rows, cols = min(bands.band_h, hp - h0), min(bands.band_w, wp - w0)
    if rows <= 0 or cols <= 0:
        return None
    return (ph, pw, nt * _K7_TILE, n0, min(bands.band_n, n - n0), h0, rows,
            w0, cols)


def _c3_tc_launch(lib, what, x, wt, scale, shift, act, stats, stride,
                  out_hw, phases=1):
    """K7's 16-bit body: the forward (``phases`` 1) or the stride-2 input
    gradient by phase (``phases`` 4, x = dy). Returns ``(y [N, Hy, Wy,
    K]``, ``s``, ``ss``)."""
    _check(what, x, (("wt", wt),), scale, shift)
    n, h, w, c = x.shape
    k = wt.shape[2]
    if tuple(wt.shape[:2]) != (9, c):
        raise ValueError(f"{what}: wt {tuple(wt.shape)} does not take {c} "
                         f"input channels in nine taps")
    hy, wy = out_hw
    hg, wg = ((hy + 1) // 2, (wy + 1) // 2) if phases == 4 else (hy, wy)
    if phases == 4 and (h, w) != (hg, wg):
        raise ValueError(f"{what}: dy {tuple(x.shape)} is not the stride-2 "
                         f"output of a {hy}x{wy} input")
    bd = c3_bands(n, hg, wg, stride, phases)
    y = torch.empty((n, hy, wy, k), dtype=x.dtype, device=x.device)
    partial, tmp, st = _stat_scratch(bd.bands, k, x.device) if stats \
        else (None, None, None)
    _run(lib, lib.paddle_conv3x3_tc, what, x, x.data_ptr(), wt.data_ptr(),
         _ptr(scale), _ptr(shift), y.data_ptr(), _ptr(partial), _ptr(tmp),
         _ptr(st), n, h, w, c, hy, wy, k, stride, phases,
         int(act == "relu"), int(stats), bd.band_n, bd.band_h, bd.band_w,
         _DTYPE_CODE[x.dtype])
    if not stats:
        z = torch.zeros(k, dtype=torch.float32, device=x.device)
        return y, z, z.clone()
    return y, st[:k], st[k:]


class K6Plan(NamedTuple):
    """K6's cut (16-bit body): blocks of ``warps_c`` x ``warps_k`` warps own
    ``64 warps_c`` input x ``32 warps_k`` output channels of dw (``tiles``
    such tiles), and split z sums rows ``[z * rows_per_split, (z + 1) *
    rows_per_split)`` of M, ``splits`` in all."""
    warps_c: int
    warps_k: int
    tiles: int
    splits: int
    rows_per_split: int


def k6_smem_bytes(warps_c: int, warps_k: int) -> int:
    """Shared memory of a K6 block (``w1_smem_bytes`` in conv.cu): a ring
    of four stages of 32 rows of x and dy, each row padded by 8 values."""
    return 4 * 2 * 32 * (64 * warps_c + 8 + 32 * warps_k + 8)


def k6_plan(m: int, c: int, k: int) -> K6Plan:
    """K6's tile and split for ``m`` rows of ``c`` -> ``k`` channels, a
    function of the shape only. The tile wastes least (no padded channels
    where one fits), then has the most warps, then reads least (x once per
    output tile, dy once per input tile): 256 x 64 at 256 -> 64, 128 x 128
    at the wider shapes, 64 x 256 at 64 -> 256. The split gives about one
    wave of the blocks an SM holds at once (two of eight warps), each split
    at least 128 rows, a multiple of the 32-row stage."""
    def cost(lay):
        tc, tk = 64 * lay[0], 32 * lay[1]
        ct, kt = -(-c // tc), -(-k // tk)
        return ct * tc * kt * tk, -lay[0] * lay[1], c * kt + k * ct

    wc, wk = min(_K6_LAYOUTS, key=cost)
    tiles = -(-c // (64 * wc)) * -(-k // (32 * wk))
    per_sm = min(_K6_SM_WARPS // (wc * wk),
                 _BLOCK_SMEM // (k6_smem_bytes(wc, wk) + 1024))
    splits = max(1, min(_SMS * per_sm // tiles, -(-m // _K6_MIN_ROWS),
                        65535))
    rows = -(-m // splits)
    rows = -(-rows // _WGRAD_STEP) * _WGRAD_STEP
    return K6Plan(wc, wk, tiles, -(-m // rows), rows)


def _wgrad1_tc_launch(lib, what, x, dy, scale, shift, act, stride):
    """K6's 16-bit body: ``[C, K]`` float32."""
    _check(what, x, (("dy", dy),), scale, shift)
    n, h, w, c = x.shape
    _, ho, wo, k = dy.shape
    if dy.shape[0] != n:
        raise ValueError(f"{what}: dy {tuple(dy.shape)} and x "
                         f"{tuple(x.shape)} differ in batch")
    pl = k6_plan(n * ho * wo, c, k)
    dw = torch.empty((c, k), dtype=torch.float32, device=x.device)
    partial = tmp = None
    if pl.splits > 1:
        partial = torch.empty((pl.splits, c * k), dtype=torch.float32,
                              device=x.device)
        tmp = torch.empty((-(-pl.splits // _REDUCE_CHUNK), c * k),
                          dtype=torch.float32, device=x.device)
    _run(lib, lib.paddle_conv1x1_wgrad_tc, what, x, x.data_ptr(),
         dy.data_ptr(), _ptr(scale), _ptr(shift), dw.data_ptr(),
         _ptr(partial), _ptr(tmp), n, h, w, c, ho, wo, k, stride,
         int(act == "relu"), pl.warps_c, pl.warps_k, pl.splits,
         pl.rows_per_split, _DTYPE_CODE[x.dtype])
    return dw


class K5Plan(NamedTuple):
    """K5's cut (16-bit body): tiles of ``64 warps_m`` rows x ``32 warps_n``
    output channels of y, ``tiles_m`` x ``tiles_n`` of them (the column
    tiles of a row tile neighbours in the walk), each summed by a block of
    ``warps_m`` x ``warps_n`` warps through a ring of ``stages`` stages;
    ``rows`` is a tile's rows, and ``tiles_m`` the rows of the stats'
    partials."""
    warps_m: int
    warps_n: int
    rows: int
    tiles_m: int
    tiles_n: int
    stages: int


def k5_smem_bytes(warps_m: int, warps_n: int, c: int,
                  prologue: bool = True, stages: int = 4) -> int:
    """Shared memory of a K5 block (``k5_smem_bytes`` in conv.cu): a ring
    of ``stages`` stages of 32 input channels (x rows of 40 values, wt rows
    of ``32 warps_n + 8``), the epilogue's staged y with its stats'
    cross-warp sums, then, with the prologue, scale and shift rounded to
    x's type for C rounded up to a stage."""
    bm, bn = 64 * warps_m, 32 * warps_n
    ring = stages * 2 * (bm * (_K5_STAGE + 8) + _K5_STAGE * (bn + 8))
    epi = 2 * bm * (bn + 8) + 2 * 4 * warps_m * bn
    table = 4 * -(-c // _K5_STAGE) * _K5_STAGE if prologue else 0
    return ring + epi + table


def _k5_blocks_per_sm(warps_m: int, warps_n: int, smem: int) -> int:
    """The blocks an SM holds: 128 registers a thread, and the shared
    memory with each block's reserve."""
    return min(65536 // (128 * 32 * warps_m * warps_n),
               _SM_SMEM // (smem + _BLOCK_RESERVE))


@functools.lru_cache(maxsize=None)
def k5_plan(m: int, c: int, k: int) -> K5Plan:
    """K5's tile for ``m`` rows of ``c`` -> ``k`` channels, a function of
    the shape only: the 8-warp layout that reads x the fewest times (once
    per column tile: ceil(K / 256) times at most), then computes the fewest
    padded outputs, then reads wt the fewest times (once per row tile),
    among those whose shared memory fits a block (with the prologue's
    table, the larger). 256 x 64 where K = 64, 128 x 128 where K = 128, 64
    x 256 where K >= 256. The ring has four stages, or three where that
    lets one more block share an SM (``tools/k5_layouts.py`` times every
    layout and ring)."""
    def cost(lay):
        bm, bn = 64 * lay[0], 32 * lay[1]
        tm, tn = -(-m // bm), -(-k // bn)
        return tn, tm * bm * tn * bn, tm

    fits = [lay for lay in _K5_LAYOUTS
            if k5_smem_bytes(*lay, c, True, min(_K5_RINGS)) <= _BLOCK_SMEM]
    if not fits:
        raise ValueError(f"K5 takes at most "
                         f"{(_BLOCK_SMEM - k5_smem_bytes(1, 2, 0)) // 4} "
                         f"input channels; got {c}")
    wm, wn = min(fits, key=cost)
    stages = max((s for s in _K5_RINGS
                  if k5_smem_bytes(wm, wn, c, True, s) <= _BLOCK_SMEM),
                 key=lambda s: (_k5_blocks_per_sm(
                     wm, wn, k5_smem_bytes(wm, wn, c, True, s)), s))
    return K5Plan(wm, wn, 64 * wm, -(-m // (64 * wm)), -(-k // (32 * wn)),
                  stages)


def _mm_tc_launch(lib, what, x, w2, scale, shift, act, stats, stride):
    """K5's 16-bit body: ``(y [N, Ho, Wo, K]``, ``s``, ``ss``)."""
    _check(what, x, (("w2", w2),), scale, shift)
    n, h, w, c = x.shape
    if w2.dim() != 2 or w2.shape[0] != c:
        raise ValueError(f"{what}: w2 {tuple(w2.shape)} does not take {c} "
                         f"input channels")
    k = w2.shape[1]
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    pl = k5_plan(n * ho * wo, c, k)
    y = torch.empty((n, ho, wo, k), dtype=x.dtype, device=x.device)
    partial, tmp, st = _stat_scratch(pl.tiles_m, k, x.device) if stats \
        else (None, None, None)
    _run(lib, lib.paddle_conv1x1_tc, what, x, x.data_ptr(), w2.data_ptr(),
         _ptr(scale), _ptr(shift), y.data_ptr(), _ptr(partial), _ptr(tmp),
         _ptr(st), n, h, w, c, ho, wo, k, stride, int(act == "relu"),
         int(stats), pl.warps_m, pl.warps_n, pl.stages, _DTYPE_CODE[x.dtype])
    if not stats:
        z = torch.zeros(k, dtype=torch.float32, device=x.device)
        return y, z, z.clone()
    return y, st[:k], st[k:]


def _device(*ts) -> torch.device:
    devices = {t.device for t in ts if t is not None}
    if len(devices) != 1:
        raise ValueError(f"conv kernel inputs on different devices: "
                         f"{devices}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the conv kernels run on CUDA or the CPU, not "
                         f"{dev}")
    return dev


def _act(act: str) -> str:
    if act not in ("none", "relu"):
        raise ValueError(f"act must be 'none' or 'relu'; got {act!r}")
    return act


def mm(x, w2, scale=None, shift=None, act: str = "none", stats: bool = True,
       stride: int = 1):
    """K5 (``_mm``): ``x [N, H, W, C]`` NHWC, ``w2 [C, K]``, optional f32
    ``scale``/``shift [C]``. Returns ``(y [N, Ho, Wo, K]``, ``s [K]``,
    ``ss [K]`` f32; zeros without ``stats``)."""
    act = _act(act)
    if _device(x, w2, scale, shift).type == "cpu":
        return mm_reference(x, w2, scale, shift, act, stats, stride)
    if x.dtype in (torch.bfloat16, torch.float16):
        out = _mm_tc_launch(_library(), "mm (K5)", x, w2, scale, shift, act,
                            stats, stride)
    else:
        _, h, w, _ = x.shape
        out = _fwd_launch(_library(), "mm (K5)", x, w2[None], scale, shift,
                          act, stats, stride, 0,
                          ((h - 1) // stride + 1, (w - 1) // stride + 1))
    mm.launches += 1
    return out


def mm_tiles64(x, w2, scale=None, shift=None, act: str = "none",
               stats: bool = True, stride: int = 1):
    """K5's 16-bit body before the present one (128 x 64 tiles, plain
    shared-memory stores one stage ahead, fragments by 32-bit reads), as a
    yardstick: ``chip_smoke.py`` times it beside :func:`mm`; no path runs
    it, and it counts no launch. Takes CUDA tensors."""
    act = _act(act)
    if _device(x, w2, scale, shift).type != "cuda":
        raise ValueError("mm_tiles64 takes CUDA tensors")
    _, h, w, _ = x.shape
    return _fwd_launch(_library(), "mm_tiles64", x, w2[None], scale, shift,
                       act, stats, stride, 0,
                       ((h - 1) // stride + 1, (w - 1) // stride + 1))


def mm_wgrad(x, dy, scale=None, shift=None, act: str = "none",
             stride: int = 1):
    """K6 (``_mm_wgrad``): ``act(x·scale+shift)[:, ::stride, ::stride]ᵀ @
    dy`` as ``[C, K]`` float32."""
    act = _act(act)
    if _device(x, dy, scale, shift).type == "cpu":
        return mm_wgrad_reference(x, dy, scale, shift, act, stride)
    if x.dtype in (torch.bfloat16, torch.float16):
        dw = _wgrad1_tc_launch(_library(), "mm_wgrad (K6)", x, dy, scale,
                               shift, act, stride)
    else:
        dw = _wgrad_launch(_library(), "mm_wgrad (K6)", x, dy, scale, shift,
                           act, stride, 0, 1)[0]
    mm_wgrad.launches += 1
    return dw


def mm_wgrad_tiles64(x, dy, scale=None, shift=None, act: str = "none",
                     stride: int = 1):
    """K6's 16-bit body before the present one (64 x 64 tiles, transposed
    scalar stores), as a yardstick: ``chip_smoke.py`` times it beside
    :func:`mm_wgrad`; no path runs it, and it counts no launch. Takes CUDA
    tensors."""
    act = _act(act)
    if _device(x, dy, scale, shift).type != "cuda":
        raise ValueError("mm_wgrad_tiles64 takes CUDA tensors")
    return _wgrad_launch(_library(), "mm_wgrad_tiles64", x, dy, scale, shift,
                         act, stride, 0, 1)[0]


def c3(x, wt, scale=None, shift=None, act: str = "none", stats: bool = True,
       stride: int = 1, out_hw=None):
    """K7 (``_c3``): the 3x3 conv of ``x [N, H, W, C]`` zero-padded by 1
    with ``wt [9, C, K]``, at ``stride``, giving ``out_hw`` rows and
    columns (default ``(H + 2 - 3) // stride + 1`` each; more pads the
    bottom and right with zeros, as the dgrad's ``pr_h`` does)."""
    act = _act(act)
    out_hw = tuple(out_hw or ((d + 2 - 3) // stride + 1
                              for d in x.shape[1:3]))
    if _device(x, wt, scale, shift).type == "cpu":
        return c3_reference(x, wt, scale, shift, act, stats, stride, out_hw)
    if x.dtype in (torch.bfloat16, torch.float16):
        out = _c3_tc_launch(_library(), "c3 (K7)", x, wt, scale, shift, act,
                            stats, stride, out_hw)
    else:
        out = _fwd_launch(_library(), "c3 (K7)", x, wt, scale, shift, act,
                          stats, stride, 1, out_hw)
    c3.launches += 1
    return out


def c3_tap_gather(x, wt, scale=None, shift=None, act: str = "none",
                  stats: bool = True, stride: int = 1, out_hw=None):
    """K7's 16-bit body before the present one (each tap gathered from
    device memory and prologued again, 128-row tiles), as a yardstick:
    ``chip_smoke.py`` times it beside :func:`c3`; no path runs it, and it
    counts no launch. Takes CUDA tensors."""
    act = _act(act)
    out_hw = tuple(out_hw or ((d + 2 - 3) // stride + 1
                              for d in x.shape[1:3]))
    if _device(x, wt, scale, shift).type != "cuda":
        raise ValueError("c3_tap_gather takes CUDA tensors")
    return _fwd_launch(_library(), "c3_tap_gather", x, wt, scale, shift, act,
                       stats, stride, 1, out_hw)


def c3_dgrad_phases(dy, wt, x_hw):
    """K7's stride-2 input gradient by phase, in bf16 and float16: ``dy
    [N, Ho, Wo, K]``, ``wt [9, K, C]`` the rotated taps
    (:func:`dgrad_taps`), ``x_hw`` the input's size; the four phases of dx
    in one launch of K7's body, no dilated dy built. Returns ``dx [N, H,
    W, C]``. Counted in ``c3.launches``."""
    if _device(dy, wt).type == "cpu":
        return c3_dgrad_phases_reference(dy, wt, x_hw)
    if dy.dtype not in (torch.bfloat16, torch.float16):
        raise ValueError("c3_dgrad_phases takes bfloat16 or float16; float32 "
                         "runs the dilated operand (conv2d_dgrad)")
    dx, _, _ = _c3_tc_launch(_library(), "c3_dgrad_phases (K7)", dy, wt,
                             None, None, "none", False, 2, tuple(x_hw), 4)
    c3.launches += 1
    return dx


def c3_wgrad(x, dy, scale=None, shift=None, act: str = "none",
             stride: int = 1):
    """K8 (``_c3_wgrad``): ``[9, C, K]`` float32 weight gradient of the 3x3
    conv of x (zero padding 1, the prologue recomputed and masked) giving
    ``dy [N, Ho, Wo, K]``. bf16 and float16 run the nine-tap body on the
    tensor cores (``paddle_conv3x3_wgrad_tc``), float32 the CUDA-core
    body."""
    act = _act(act)
    if _device(x, dy, scale, shift).type == "cpu":
        return c3_wgrad_reference(x, dy, scale, shift, act, stride)
    if x.dtype in (torch.bfloat16, torch.float16):
        dw = _wgrad_tc_launch(_library(), "c3_wgrad (K8)", x, dy, scale,
                              shift, act, stride)
    else:
        dw = _wgrad_launch(_library(), "c3_wgrad (K8)", x, dy, scale, shift,
                           act, stride, 1, 9)
    c3_wgrad.launches += 1
    return dw


def c3_wgrad_tap_blocks(x, dy, scale=None, shift=None, act: str = "none",
                        stride: int = 1):
    """K8's bf16 body before the nine-tap one (a block per tap, split-K over
    rows), as a yardstick: ``chip_smoke.py`` times it beside
    :func:`c3_wgrad`; no path runs it, and it counts no launch. Takes
    CUDA tensors in bfloat16 (and float32, K8's own CUDA-core body)."""
    act = _act(act)
    if _device(x, dy, scale, shift).type != "cuda" or \
            x.dtype == torch.float16:
        raise ValueError("c3_wgrad_tap_blocks takes bfloat16 or float32 "
                         "CUDA tensors")
    return _wgrad_launch(_library(), "c3_wgrad_tap_blocks", x, dy, scale,
                         shift, act, stride, 1, 9)


#: kernel launches since each count was last set to 0 (CUDA path only)
mm.launches = 0
mm_wgrad.launches = 0
c3.launches = 0
c3_wgrad.launches = 0


# ---------------------------------------------------------------------------
# Host entries (not differentiable; the fused units and conv2d below drive
# autograd through dgrad/wgrad)
# ---------------------------------------------------------------------------

def _f32(t):
    return None if t is None else t.float().contiguous()


def fwd_weight(w, dtype):
    """The weight matrix conv2d_fwd hands to K5 or K7: OIHW ``[K, C, k, k]``
    as ``[k·k, C, K]`` tap matrices in ``dtype`` (``_fwd_taps``)."""
    taps = w.shape[2] * w.shape[3]
    return w.permute(2, 3, 1, 0).reshape(taps, w.shape[1], w.shape[0]).to(
        dtype).contiguous()


def conv2d_fwd(x, w, scale=None, shift=None, act: str = "none",
               stride=(1, 1), padding=(0, 0), stats: bool = True):
    """Fused conv forward: ``conv(act(x·scale+shift), w)`` plus the
    per-channel (sum, sumsq) of the output, in one pass.

    x: ``[N, H, W, C]`` NHWC; w: OIHW ``[K, C, k, k]``, k in {1, 3} (1x1
    with padding 0, 3x3 with padding 1). scale/shift: optional ``[C]``
    prologue (None: none); act: ``'none'`` or ``'relu'``. Returns ``(y [N,
    Ho, Wo, K]``, ``s [K]``, ``ss [K]`` float32; zeros when ``stats`` is
    False)."""
    s_ = _pair(stride)[0]
    x = x.contiguous()
    scale, shift = _f32(scale), _f32(shift)
    wt = fwd_weight(w, x.dtype)
    if w.shape[2] == 1:
        return mm(x, wt[0], scale, shift, act, stats, s_)
    return c3(x, wt, scale, shift, act, stats, s_)


def dgrad_taps(w, dtype):
    """The 3x3 input gradient's weight matrices: OIHW ``[K, C, 3, 3]``
    rotated 180 degrees as ``[9, K, C]`` in ``dtype`` (conv.py
    ``:550-551``)."""
    kk, c = w.shape[0], w.shape[1]
    return w.flip(2, 3).permute(2, 3, 0, 1).reshape(9, kk, c).to(
        dtype).contiguous()


def dgrad_operands(dy, w, stride: int):
    """What conv2d_dgrad hands to K5, or to K7 at stride 1 and in float32:
    ``(operand, weight matrix)``. 1x1: dy and w as ``[1, K, C]``. 3x3: dy,
    zero-dilated at stride 2 (``(Ho - 1)·2 + 1`` rows and columns), and the
    rotated taps (:func:`dgrad_taps`; conv.py ``:538-551``). The 16-bit
    stride-2 input gradient takes no dilated operand
    (:func:`c3_dgrad_phases`); chip_smoke.py holds it against
    :func:`c3_reference` on this one."""
    dy = dy.contiguous()
    kk, c = w.shape[0], w.shape[1]
    if w.shape[2] == 1:
        return dy, w.reshape(1, kk, c).to(dy.dtype).contiguous()
    dyd = dy
    if stride != 1:
        n, ho, wo, _ = dy.shape
        dyd = torch.zeros((n, (ho - 1) * stride + 1, (wo - 1) * stride + 1,
                           kk), dtype=dy.dtype, device=dy.device)
        dyd[:, ::stride, ::stride] = dy
    return dyd, dgrad_taps(w, dy.dtype)


def conv2d_dgrad(dy, w, x_shape, stride=(1, 1), padding=(0, 0)):
    """Input gradient through the same kernels: 1x1 through K5 with w as
    ``[K, C]`` (at stride 2 scattered into zeros at ``[:, ::2, ::2]``); 3x3
    through K7 at stride 1 on the rotated taps of dy (of the zero-dilated
    dy in float32 at stride 2, padded to ``H + 2`` rows and ``W + 2``
    columns, conv.py ``:513-556``); in 16 bits at stride 2 through K7 by
    output phase (:func:`c3_dgrad_phases`: the same function, without the
    dilation's zero products)."""
    s_ = _pair(stride)[0]
    if w.shape[2] == 3 and s_ == 2 and dy.dtype in (torch.bfloat16,
                                                    torch.float16):
        return c3_dgrad_phases(dy.contiguous(), dgrad_taps(w, dy.dtype),
                               (x_shape[1], x_shape[2]))
    op, wt = dgrad_operands(dy, w, s_)
    if w.shape[2] == 1:
        da, _, _ = mm(op, wt[0], None, None, "none", False, 1)
        if s_ != 1:
            full = torch.zeros(tuple(x_shape), dtype=da.dtype,
                               device=da.device)
            full[:, ::s_, ::s_] = da
            da = full
        return da
    dx, _, _ = c3(op, wt, None, None, "none", False, 1,
                  (x_shape[1], x_shape[2]))
    return dx


def conv2d_wgrad(x, dy, w_shape, scale=None, shift=None, act: str = "none",
                 stride=(1, 1), padding=(0, 0)):
    """Weight gradient ``aᵀ @ dy`` per tap, ``a = act(x·scale+shift)``
    recomputed in the kernel from the raw input (the unit saves only the
    pre-BN tensor). Returns dw in OIHW, float32."""
    s_ = _pair(stride)[0]
    x, dy = x.contiguous(), dy.contiguous()
    scale, shift = _f32(scale), _f32(shift)
    if w_shape[2] == 1:
        dw2 = mm_wgrad(x, dy, scale, shift, act, s_)
        return dw2.T.reshape(tuple(w_shape)).contiguous()
    dw9 = c3_wgrad(x, dy, scale, shift, act, s_)
    c, kk = x.shape[3], w_shape[0]
    return dw9.reshape(3, 3, c, kk).permute(3, 2, 0, 1).contiguous()


class _Conv2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.padding = stride, padding
        y, _, _ = conv2d_fwd(x, w, stride=stride, padding=padding,
                             stats=False)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = conv2d_dgrad(dy, w, x.shape, ctx.stride, ctx.padding).to(
            x.dtype)
        dw = conv2d_wgrad(x, dy, w.shape, stride=ctx.stride,
                          padding=ctx.padding).to(w.dtype)
        return dx, dw, None, None


def conv2d(x, w, stride=(1, 1), padding=(0, 0)):
    """Differentiable conv on the kernels with no prologue (conv.py
    ``:597-618``): its gradients are :func:`conv2d_dgrad` and
    :func:`conv2d_wgrad`."""
    return _Conv2d.apply(x, w, _pair(stride), _pair(padding))
