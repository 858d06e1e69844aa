"""Detection operators of the port (``paddle_tpu/vision/ops.py``
counterpart), torch ops on the input's device.

- ``roi_align``, ``roi_pool``, ``psroi_pool`` and ``deform_conv2d`` sample
  bilinearly as JAX's ``map_coordinates(order=1, mode="constant",
  cval=0)`` does: the four corners of each sample, in the order (y0, x0),
  (y0, x1), (y1, x0), (y1, x1), each weighted ``wy·wx`` and counted only
  where it lies inside the map, so a sample between -1 and 0 (or n-1 and
  n) keeps its inner corner's share. The corners are gathered
  (``index_select``) from a channels-last copy of the map, so autograd
  gives ``x`` (and, for ``deform_conv2d``, ``offset`` and ``mask``) JAX's
  gradients. Two faults
  of the reference are kept: ``roi_align`` with ``sampling_ratio <= 0``
  takes 2 samples a bin axis, not Paddle's adaptive ``ceil(bin)``, and
  ``roi_pool`` maxes over that 2 x 2 bilinear grid, not over the bin's
  pixels.
- ``nms`` sorts by score as JAX does (stably, so ties keep index order)
  and computes every pair's IoU-above-threshold on the device; the greedy
  sweep then reads that matrix, packed to bits, once on the host (where
  JAX's result also goes) instead of a launch per box.
- ``matrix_nms`` runs each image's classes together on the device: every
  class's ``nms_top_k`` best candidates, their IoU matrix and SOLOv2's
  decay at once; JAX loops over images and classes in numpy.
- ``distribute_fpn_proposals``, ``read_file`` and ``decode_jpeg`` are
  host-side, as in JAX (``decode_jpeg`` decodes with PIL).

Index outputs are int64 where JAX's are int32, as ``core/dtype.py``
states.
"""

from __future__ import annotations

import io as _io
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.device import as_device_tensor as _tensor
from ..core.device import as_host_array
from ..core.device import resolve_device
from ..nn import initializer as I
from ..nn.functional import _pair
from ..nn.layer import Layer as _Layer

__all__ = [
    "RoIAlign", "RoIPool", "psroi_pool", "PSRoIPool", "yolo_loss",
    "generate_proposals", "nms", "roi_align", "roi_pool", "box_coder",
    "prior_box", "yolo_box", "distribute_fpn_proposals", "read_file",
    "decode_jpeg", "deform_conv2d", "DeformConv2D", "matrix_nms"]


def _pairwise_iou(boxes: torch.Tensor, offset: float = 0.0) -> torch.Tensor:
    """``[..., N, 4]`` xyxy to ``[..., N, N]`` IoU (``offset`` 1 for the
    integer-pixel convention of ``normalized=False``)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1 + offset).clamp_min(0) * (y2 - y1 + offset).clamp_min(0)
    ix1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    iy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    ix2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    iy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    inter = (ix2 - ix1 + offset).clamp_min(0) * \
        (iy2 - iy1 + offset).clamp_min(0)
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / union.clamp_min(1e-10)


def _greedy_sweep(over: torch.Tensor) -> np.ndarray:
    """JAX's greedy sweep over score-sorted boxes: box i is kept unless a
    kept box before it overlaps it (``over[j, i]``, j < i). ``over`` is
    packed to bits on the device and read once."""
    n = over.shape[0]
    nb = (n + 7) // 8
    bits = torch.zeros((n, nb * 8), dtype=torch.uint8, device=over.device)
    bits[:, :n] = over.triu(diagonal=1)
    weights = (2 ** torch.arange(8, device=over.device)).to(torch.uint8)
    packed = (bits.view(n, nb, 8) * weights).sum(-1, dtype=torch.uint8)
    packed = packed.cpu().numpy()
    removed = np.zeros(nb, np.uint8)
    keep = []
    for i in range(n):
        if not (removed[i >> 3] >> (i & 7)) & 1:
            keep.append(i)
            removed |= packed[i]
    return np.asarray(keep, np.int64)


def nms(boxes, iou_threshold: float = 0.3, scores=None, category_idxs=None,
        categories: Optional[Sequence[int]] = None,
        top_k: Optional[int] = None):
    """Greedy hard NMS over ``boxes`` ``[N, 4]`` xyxy: the kept indices,
    best score first (input order without ``scores``). With
    ``category_idxs`` each category suppresses only its own boxes (each is
    shifted into a coordinate range of its own); ``top_k`` truncates after
    the sweep."""
    boxes = _tensor(boxes)
    n = boxes.shape[0]
    if scores is None:
        scores_arr = torch.arange(n, 0, -1, dtype=torch.float32,
                                  device=boxes.device)
    else:
        scores_arr = _tensor(scores, torch.float32, like=boxes)
    nms_boxes = boxes
    if category_idxs is not None:
        cat = _tensor(category_idxs, like=boxes)
        span = boxes.max() - boxes.min() + 1.0
        nms_boxes = boxes + (cat.to(boxes.dtype) * span)[:, None]
    if n == 0:
        return torch.zeros((0,), dtype=torch.int64, device=boxes.device)
    order = torch.argsort(-scores_arr, stable=True)
    over = _pairwise_iou(nms_boxes[order]) > iou_threshold
    kept = order[torch.as_tensor(_greedy_sweep(over), device=boxes.device)]
    if top_k is not None:
        kept = kept[:top_k]
    return kept


def _roi_images(boxes_num, num_rois: int, device) -> torch.Tensor:
    """The image of each roi, from the rois an image."""
    if boxes_num is None:
        return torch.zeros((num_rois,), dtype=torch.int64, device=device)
    counts = _tensor(boxes_num, torch.int64).to(device)
    return torch.repeat_interleave(
        torch.arange(counts.shape[0], device=device), counts,
        output_size=num_rois)


def _bilinear(xf, h: int, w: int, base, ys, xs):
    """``map_coordinates(order=1, mode="constant")`` at every ``(ys, xs)``
    of the image rows ``base`` (``img·h·w``) of ``xf`` ``[N·h·w, C]``:
    ``ys``, ``xs`` and ``base`` broadcast to the sample shape ``S``; the
    result is ``[*S, C]``."""
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy1, wx1 = ys - y0, xs - x0
    wy0, wx0 = 1 - wy1, 1 - wx1
    y0, x0 = y0.to(torch.int64), x0.to(torch.int64)
    out = None
    for yi, wy in ((y0, wy0), (y0 + 1, wy1)):
        for xi, wx in ((x0, wx0), (x0 + 1, wx1)):
            valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            flat = base + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
            # index_select: its backward is an index_add (atomic adds on
            # the card), not the sorting accumulate of advanced indexing
            val = xf.index_select(0, flat.reshape(-1)).reshape(
                *flat.shape, xf.shape[1])
            # an outside corner's weight is 0 (x is finite): JAX's
            # where(valid, val, 0) times the weight, one buffer fewer
            term = (wy * wx * valid)[..., None] * val
            out = term if out is None else out + term
    return out


def _roi_sample(x, boxes, boxes_num, output_size, spatial_scale,
                sampling_ratio, aligned, reduce):
    """RoIAlign's and RoIPool's sampler: S x S bilinear samples an output
    bin, averaged (align) or maxed (pool)."""
    if isinstance(output_size, int):
        ph = pw = output_size
    else:
        ph, pw = output_size
    s = sampling_ratio if sampling_ratio and sampling_ratio > 0 else 2
    x = _tensor(x)
    boxes = _tensor(boxes, torch.float32, like=x)
    num_rois = boxes.shape[0]
    n, c, h, w = x.shape
    img = _roi_images(boxes_num, num_rois, x.device)
    off = 0.5 if aligned else 0.0
    x1 = boxes[:, 0] * spatial_scale - off
    y1 = boxes[:, 1] * spatial_scale - off
    x2 = boxes[:, 2] * spatial_scale - off
    y2 = boxes[:, 3] * spatial_scale - off
    if not aligned:  # the legacy rule: rois at least 1 x 1
        x2 = torch.maximum(x2, x1 + 1.0)
        y2 = torch.maximum(y2, y1 + 1.0)
    bin_h = (y2 - y1) / ph
    bin_w = (x2 - x1) / pw
    sy = (torch.arange(ph * s, device=x.device) + 0.5) / s  # in bins
    sx = (torch.arange(pw * s, device=x.device) + 0.5) / s
    ys = y1[:, None] + bin_h[:, None] * sy[None, :]          # [R, ph*S]
    xs = x1[:, None] + bin_w[:, None] * sx[None, :]          # [R, pw*S]
    xf = x.permute(0, 2, 3, 1).reshape(n * h * w, c)
    samples = _bilinear(xf, h, w, (img * h * w)[:, None, None],
                        ys[:, :, None], xs[:, None, :])      # [R, A, B, C]
    samples = samples.reshape(num_rois, ph, s, pw, s, c)
    if reduce == "max":
        out = samples.amax(dim=(2, 4))
    else:
        out = samples.mean(dim=(2, 4))
    return out.permute(0, 3, 1, 2)


def roi_align(x, boxes, boxes_num=None, output_size=1,
              spatial_scale: float = 1.0, sampling_ratio: int = -1,
              aligned: bool = True, name=None):
    """RoIAlign: each output bin the mean of its S x S bilinear samples
    (S = ``sampling_ratio``, 2 when it is not positive). ``x`` ``[N, C, H,
    W]``; ``boxes`` ``[R, 4]`` xyxy in input coordinates; ``boxes_num``
    ``[N]`` rois an image."""
    return _roi_sample(x, boxes, boxes_num, output_size, spatial_scale,
                       sampling_ratio, aligned, "mean")


def roi_pool(x, boxes, boxes_num=None, output_size=1,
             spatial_scale: float = 1.0, name=None):
    """RoIPool as JAX computes it: the max over a 2 x 2 bilinear grid a
    bin (the legacy unaligned boxes)."""
    return _roi_sample(x, boxes, boxes_num, output_size, spatial_scale,
                       2, False, "max")


def box_coder(prior_box, prior_box_var, target_box,
              code_type: str = "encode_center_size",
              box_normalized: bool = True, axis: int = 0, name=None):
    """Encode ``target_box`` ``[M, 4]`` xyxy against the priors as centre
    and size offsets, or decode such offsets back to xyxy boxes."""
    target = _tensor(target_box, torch.float32)
    prior = _tensor(prior_box, torch.float32, like=target)
    var = (_tensor(prior_box_var, torch.float32, like=target)
           if prior_box_var is not None
           else torch.ones((4,), dtype=torch.float32, device=target.device))
    norm = 0.0 if box_normalized else 1.0
    pw = prior[:, 2] - prior[:, 0] + norm
    ph = prior[:, 3] - prior[:, 1] + norm
    pcx = prior[:, 0] + pw * 0.5
    pcy = prior[:, 1] + ph * 0.5
    if code_type == "encode_center_size":
        tw = target[:, 2] - target[:, 0] + norm
        th = target[:, 3] - target[:, 1] + norm
        tcx = target[:, 0] + tw * 0.5
        tcy = target[:, 1] + th * 0.5
        out = torch.stack([(tcx - pcx) / pw, (tcy - pcy) / ph,
                           torch.log((tw / pw).clamp_min(1e-10)),
                           torch.log((th / ph).clamp_min(1e-10))], dim=1)
        return out / var.reshape(-1, 4)
    if code_type == "decode_center_size":
        d = target * var.reshape(-1, 4)
        cx = d[:, 0] * pw + pcx
        cy = d[:, 1] * ph + pcy
        w = torch.exp(d[:, 2]) * pw
        h = torch.exp(d[:, 3]) * ph
        return torch.stack([cx - w * 0.5, cy - h * 0.5,
                            cx + w * 0.5 - norm, cy + h * 0.5 - norm], dim=1)
    raise ValueError(f"code_type must be encode/decode_center_size, got "
                     f"{code_type!r}")


def prior_box(input, image, min_sizes, max_sizes=None,
              aspect_ratios=(1.0,), variance=(0.1, 0.1, 0.2, 0.2),
              flip: bool = False, clip: bool = False, steps=(0.0, 0.0),
              offset: float = 0.5, min_max_aspect_ratios_order: bool = False,
              name=None):
    """SSD's prior boxes for one feature map: ``(boxes [H, W, A, 4]`` xyxy
    normalised by the image, ``variances`` of the same shape), on
    ``input``'s device."""
    fh, fw = input.shape[2], input.shape[3]
    ih, iw = image.shape[2], image.shape[3]
    dev = input.device if isinstance(input, torch.Tensor) \
        else resolve_device(None)
    step_h = steps[1] or ih / fh
    step_w = steps[0] or iw / fw
    ratios = list(aspect_ratios)
    if flip:
        ratios += [1.0 / r for r in aspect_ratios if r != 1.0]
    whs = []
    for i, ms in enumerate(min_sizes):
        per_ms = [(ms * np.sqrt(r), ms / np.sqrt(r)) for r in ratios]
        if max_sizes:
            mx = max_sizes[i]
            max_box = (np.sqrt(ms * mx), np.sqrt(ms * mx))
            if min_max_aspect_ratios_order:
                # [min (ratio 1), max, the other ratios]
                per_ms = per_ms[:1] + [max_box] + per_ms[1:]
            else:
                per_ms = per_ms + [max_box]
        whs.extend(per_ms)
    whs = torch.as_tensor(np.asarray(whs, np.float32), device=dev)  # [A, 2]
    cy = (torch.arange(fh, dtype=torch.float32, device=dev) + offset) \
        * step_h
    cx = (torch.arange(fw, dtype=torch.float32, device=dev) + offset) \
        * step_w
    cxg, cyg = torch.meshgrid(cx, cy, indexing="xy")           # [H, W]
    centers = torch.stack([cxg, cyg], dim=-1)[:, :, None, :]   # [H, W, 1, 2]
    half = whs[None, None, :, :] * 0.5
    size = torch.tensor([iw, ih], dtype=torch.float32, device=dev)
    mins = (centers - half) / size
    maxs = (centers + half) / size
    boxes = torch.cat([mins, maxs], dim=-1)                    # [H, W, A, 4]
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    var = torch.as_tensor(np.asarray(variance, np.float32),
                          device=dev).expand(boxes.shape)
    return boxes, var


def yolo_box(x, img_size, anchors, class_num: int, conf_thresh: float = 0.01,
             downsample_ratio: int = 32, clip_bbox: bool = True,
             scale_x_y: float = 1.0, iou_aware: bool = False,
             iou_aware_factor: float = 0.5, name=None):
    """Decode one YOLOv3 head ``x`` ``[N, A·(5+C), H, W]`` (``img_size``
    ``[N, 2]`` as (h, w)) into ``(boxes [N, H·W·A, 4]`` xyxy in image
    pixels, ``scores [N, H·W·A, C])``, scores below ``conf_thresh`` zeroed.
    ``iou_aware`` reads PP-YOLO's layout, the A IoU channels first."""
    x = _tensor(x, torch.float32)
    n, _, h, w = x.shape
    na = len(anchors) // 2
    an = torch.as_tensor(np.asarray(anchors, np.float32),
                         device=x.device).reshape(na, 2)
    ioup = None
    if iou_aware:
        ioup = torch.sigmoid(x[:, :na].reshape(n, na, h, w))
        x = x[:, na:]
    x = x.reshape(n, na, 5 + class_num, h, w)
    gx = torch.arange(w, dtype=torch.float32, device=x.device)
    gy = torch.arange(h, dtype=torch.float32, device=x.device)
    alpha, beta = scale_x_y, -0.5 * (scale_x_y - 1.0)
    bx = (alpha * torch.sigmoid(x[:, :, 0]) + beta
          + gx[None, None, None, :]) / w                       # [N,A,H,W]
    by = (alpha * torch.sigmoid(x[:, :, 1]) + beta
          + gy[None, None, :, None]) / h
    input_h = downsample_ratio * h
    input_w = downsample_ratio * w
    bw = torch.exp(x[:, :, 2]) * an[None, :, 0, None, None] / input_w
    bh = torch.exp(x[:, :, 3]) * an[None, :, 1, None, None] / input_h
    conf = torch.sigmoid(x[:, :, 4])
    if ioup is not None:
        conf = conf ** (1.0 - iou_aware_factor) * ioup ** iou_aware_factor
    probs = torch.sigmoid(x[:, :, 5:])                        # [N,A,C,H,W]
    scores = conf[:, :, None] * probs
    keep = (conf > conf_thresh)[:, :, None]
    scores = torch.where(keep, scores, torch.zeros((), device=x.device))
    size = _tensor(img_size, torch.float32, like=x)
    sy = size[:, 0][:, None, None, None]
    sx = size[:, 1][:, None, None, None]
    x1 = (bx - bw * 0.5) * sx
    y1 = (by - bh * 0.5) * sy
    x2 = (bx + bw * 0.5) * sx
    y2 = (by + bh * 0.5) * sy
    if clip_bbox:
        zero = torch.zeros((), device=x.device)
        x1 = torch.clamp(x1, zero, sx - 1)
        y1 = torch.clamp(y1, zero, sy - 1)
        x2 = torch.clamp(x2, zero, sx - 1)
        y2 = torch.clamp(y2, zero, sy - 1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)             # [N,A,H,W,4]
    boxes = boxes.permute(0, 2, 3, 1, 4).reshape(n, -1, 4)
    scores = scores.permute(0, 3, 4, 1, 2).reshape(n, -1, class_num)
    return boxes, scores


def distribute_fpn_proposals(fpn_rois, min_level: int, max_level: int,
                             refer_level: int, refer_scale: int,
                             pixel_offset: bool = False, rois_num=None,
                             name=None):
    """Each roi to the FPN level ``refer + floor(log2(sqrt(area) /
    scale))``, clipped to the levels; host-side (the splits' sizes depend
    on the data). Returns (the rois of each level, ``restore_index [R,
    1]``), on ``fpn_rois``' device."""
    dev = fpn_rois.device if isinstance(fpn_rois, torch.Tensor) \
        else resolve_device(None)
    rois = as_host_array(fpn_rois).astype(np.float32)
    off = 1.0 if pixel_offset else 0.0
    ws = rois[:, 2] - rois[:, 0] + off
    hs = rois[:, 3] - rois[:, 1] + off
    scale = np.sqrt(np.maximum(ws * hs, 1e-12))
    lvl = np.floor(np.log2(scale / refer_scale + 1e-8)) + refer_level
    lvl = np.clip(lvl, min_level, max_level).astype(np.int64)
    outs, order = [], []
    for level in range(min_level, max_level + 1):
        idx = np.nonzero(lvl == level)[0]
        outs.append(torch.as_tensor(rois[idx], device=dev))
        order.append(idx)
    order = np.concatenate(order) if order else np.zeros((0,), np.int64)
    restore = np.empty_like(order)
    restore[order] = np.arange(len(order))
    return outs, torch.as_tensor(restore.reshape(-1, 1), device=dev)


def read_file(path: str, name=None):
    """The file's bytes as a uint8 tensor on the host."""
    with open(path, "rb") as f:
        return torch.from_numpy(np.frombuffer(f.read(), np.uint8).copy())


def decode_jpeg(x, mode: str = "unchanged", name=None):
    """A JPEG byte tensor decoded by PIL on the host to ``[C, H, W]``
    uint8, on ``x``'s device; raises ImportError where PIL is absent, as
    JAX's does."""
    from PIL import Image
    img = Image.open(_io.BytesIO(as_host_array(x).tobytes()))
    if mode == "gray":
        img = img.convert("L")
    elif mode == "rgb":
        img = img.convert("RGB")
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[None, :, :]
    else:
        arr = arr.transpose(2, 0, 1)
    dev = x.device if isinstance(x, torch.Tensor) else torch.device("cpu")
    return torch.as_tensor(np.array(arr), device=dev)  # a writable copy


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups: int = 1, groups: int = 1,
                  mask=None, name=None):
    """Deformable convolution, v1, or v2 with ``mask``: ``x`` ``[N, Cin,
    H, W]``; ``offset`` ``[N, 2·dg·kh·kw, Ho, Wo]``, channel 2k the Δy and
    2k+1 the Δx of tap k; ``mask`` ``[N, dg·kh·kw, Ho, Wo]``. Each tap's
    sample is bilinear (see the module docstring), the product in float32
    as JAX's, cast back to ``x``'s dtype."""
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    x = _tensor(x)
    n, cin, h, w = x.shape
    weight = _tensor(weight, like=x)
    cout, cpg, kh, kw = weight.shape
    k = kh * kw
    dg = deformable_groups
    offset = _tensor(offset, torch.float32, like=x)
    ho, wo = offset.shape[2], offset.shape[3]
    if offset.shape[1] != 2 * dg * k:
        raise ValueError(
            f"offset channels {offset.shape[1]} != 2*dg*kh*kw = {2 * dg * k}")
    dev = x.device
    # each tap's base grid [k, Ho, Wo]
    ys = (torch.arange(ho, device=dev) * sh - ph)[None, :, None] + \
        (torch.arange(kh, device=dev) * dh).repeat_interleave(kw)[:, None,
                                                                 None]
    xs = (torch.arange(wo, device=dev) * sw - pw)[None, None, :] + \
        (torch.arange(kw, device=dev) * dw).repeat(kh)[:, None, None]
    off = offset.reshape(n, dg, k, 2, ho, wo)
    py = ys[None, None] + off[:, :, :, 0]          # [N, dg, k, Ho, Wo]
    px = xs[None, None] + off[:, :, :, 1]
    cdg = cin // dg
    # each deformable group's channels last: [N·dg·H·W, Cin/dg]
    xf = x.float().reshape(n, dg, cdg, h * w).permute(0, 1, 3, 2) \
        .reshape(n * dg * h * w, cdg)
    base = (torch.arange(n * dg, device=dev) * (h * w)).reshape(
        n, dg, 1, 1, 1)
    sampled = _bilinear(xf, h, w, base, py, px)   # [N, dg, k, Ho, Wo, cdg]
    if mask is not None:
        m = _tensor(mask, torch.float32, like=x).reshape(n, dg, k, ho, wo)
        sampled = sampled * m[..., None]
    sampled = sampled.permute(0, 1, 5, 2, 3, 4).reshape(n, cin, k, ho, wo)
    wk = weight.reshape(cout, cpg, k).float()
    if groups == 1:
        out = torch.einsum("nckhw,ock->nohw", sampled, wk)
    else:
        cout_g = cout // groups
        out = torch.cat([
            torch.einsum("nckhw,ock->nohw",
                         sampled[:, g * cpg:(g + 1) * cpg],
                         wk[g * cout_g:(g + 1) * cout_g])
            for g in range(groups)], dim=1)
    if bias is not None:
        out = out + _tensor(bias, like=x).reshape(1, -1, 1, 1)
    return out.to(x.dtype)


class DeformConv2D(_Layer):
    """:func:`deform_conv2d` as a layer: weight ``[out, in/groups, kh,
    kw]`` from KaimingUniform over its fan-in, bias from zeros unless
    ``bias_attr=False``; built on ``device`` (None: the thread's,
    ``cuda:0`` by default), as the port's layers are."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None, *, device=None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        device = resolve_device(device)
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.deformable_groups, self.groups = deformable_groups, groups
        fan_in = in_channels // groups * kh * kw
        self.weight = self.create_parameter(
            (out_channels, in_channels // groups, kh, kw),
            attr=weight_attr,
            default_initializer=I.KaimingUniform(fan_in=fan_in),
            device=device)
        self.bias = (None if bias_attr is False else
                     self.create_parameter((out_channels,), attr=bias_attr,
                                           is_bias=True, device=device))

    def forward(self, x, offset, mask=None):
        return deform_conv2d(
            x, offset, self.weight, self.bias, stride=self.stride,
            padding=self.padding, dilation=self.dilation,
            deformable_groups=self.deformable_groups, groups=self.groups,
            mask=mask)


def matrix_nms(bboxes, scores, score_threshold: float, post_threshold: float,
               nms_top_k: int, keep_top_k: int, use_gaussian: bool = False,
               gaussian_sigma: float = 2.0, background_label: int = 0,
               normalized: bool = True, return_index: bool = False,
               return_rois_num: bool = True, name=None):
    """Matrix NMS (SOLOv2): each candidate's score decays by its worst
    overlap with a better one of its class, over its better one's own
    worst overlap; no box is removed outright. ``bboxes`` ``[N, M, 4]``,
    ``scores`` ``[N, C, M]``. Returns (``out [R, 6]`` as (label, score,
    x1, y1, x2, y2), ``index [R, 1]`` into the N·M boxes if
    ``return_index``, ``rois_num [N]`` if ``return_rois_num``); a single
    output is returned alone. Candidates: the scores above
    ``score_threshold``, the first ``nms_top_k`` of each class by score
    (as JAX slices them: a negative ``nms_top_k`` drops that many from
    the end); kept: decayed scores above ``post_threshold``, the image's
    first ``keep_top_k`` by score (all if it is not positive), ties in
    class order."""
    scores_t = _tensor(scores, torch.float32)
    boxes_t = _tensor(bboxes, torch.float32, like=scores_t)
    dev = scores_t.device
    n, c, m = scores_t.shape
    classes = torch.tensor([k for k in range(c) if k != background_label],
                           dtype=torch.int64, device=dev)
    width = m if nms_top_k < 0 else min(nms_top_k, m)
    offset = 0.0 if normalized else 1.0
    outs, idxs, counts = [], [], []
    for b in range(n):
        s = scores_t[b, classes]                                # [C', M]
        n_sel = (s > score_threshold).sum(1)                    # [C']
        limit = n_sel.clamp(max=nms_top_k) if nms_top_k >= 0 \
            else (n_sel + nms_top_k).clamp(min=0)
        order = torch.argsort(-s, dim=1, stable=True)[:, :width]
        rank = torch.arange(width, device=dev)
        cand = rank[None, :] < limit[:, None]                   # [C', K]
        s_k = torch.gather(s, 1, order)
        iou = _pairwise_iou(boxes_t[b][order], offset).triu(diagonal=1)
        iou = iou * (cand[:, :, None] & cand[:, None, :])
        comp = iou.amax(dim=1)                                  # [C', K]
        if use_gaussian:
            f_iou = torch.exp(-(iou ** 2) / gaussian_sigma)
            f_comp = torch.exp(-(comp ** 2) / gaussian_sigma)
        else:
            f_iou, f_comp = 1.0 - iou, 1.0 - comp
        ratio = f_iou / f_comp.clamp_min(1e-12)[:, :, None]
        upper = torch.ones(width, width, dtype=torch.bool,
                           device=dev).triu(diagonal=1)
        ratio = torch.where(upper, ratio, torch.full((), float("inf"),
                                                     device=dev))
        decay = ratio.amin(dim=1).clamp(max=1.0)
        new = s_k * decay
        keep = cand & (new > post_threshold)
        cls_of = classes[:, None].expand(-1, width)[keep]
        sc = new[keep]
        box_idx = order[keep]
        pick = torch.argsort(-sc, stable=True)
        if keep_top_k > 0:
            pick = pick[:keep_top_k]
        outs.append(torch.cat([cls_of[pick, None].float(), sc[pick, None],
                               boxes_t[b][box_idx[pick]]], dim=1))
        idxs.append(b * m + box_idx[pick])
        counts.append(int(pick.shape[0]))
    out = torch.cat(outs) if outs else torch.zeros((0, 6), device=dev)
    result = [out]
    if return_index:
        result.append(torch.cat(idxs).reshape(-1, 1) if idxs else
                      torch.zeros((0, 1), dtype=torch.int64, device=dev))
    if return_rois_num:
        result.append(torch.as_tensor(counts, dtype=torch.int64,
                                      device=dev))
    return tuple(result) if len(result) > 1 else out


class RoIAlign:
    """:func:`roi_align` with its output size and scale fixed."""

    def __init__(self, output_size, spatial_scale: float = 1.0):
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def __call__(self, x, boxes, boxes_num=None):
        return roi_align(x, boxes, boxes_num, self.output_size,
                         self.spatial_scale)


class RoIPool:
    """:func:`roi_pool` with its output size and scale fixed."""

    def __init__(self, output_size, spatial_scale: float = 1.0):
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def __call__(self, x, boxes, boxes_num=None):
        return roi_pool(x, boxes, boxes_num, self.output_size,
                        self.spatial_scale)


def psroi_pool(x, boxes, boxes_num=None, output_size=7,
               spatial_scale: float = 1.0, name=None):
    """Position-sensitive RoI pooling: ``x`` has ``out_c·ph·pw`` channels
    and channel group (i, j) feeds output bin (i, j); ``[R, out_c, ph,
    pw]``. As JAX: RoIAlign on every channel, then each bin's group."""
    x = _tensor(x)
    ph, pw = (output_size, output_size) if isinstance(output_size, int) \
        else tuple(output_size)
    c = x.shape[1]
    if c % (ph * pw):
        raise ValueError(f"channels {c} not divisible by {ph}*{pw}")
    out_c = c // (ph * pw)
    full = roi_align(x, boxes, boxes_num, (ph, pw), spatial_scale)
    r = full.shape[0]
    full = full.reshape(r, out_c, ph, pw, ph, pw)
    ii = torch.arange(ph, device=x.device)
    jj = torch.arange(pw, device=x.device)
    return full[:, :, ii[:, None], jj[None, :], ii[:, None], jj[None, :]]


class PSRoIPool:
    """:func:`psroi_pool` with its output size and scale fixed."""

    def __init__(self, output_size, spatial_scale: float = 1.0):
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def __call__(self, x, boxes, boxes_num=None):
        return psroi_pool(x, boxes, boxes_num, self.output_size,
                          self.spatial_scale)


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth: bool = True, name=None, scale_x_y: float = 1.0):
    """YOLOv3's loss of one head, per image, as JAX computes it: ``x``
    ``[N, mask·(5+cls), H, W]``; ``gt_box`` ``[N, B, 4]`` (cx, cy, w, h,
    normalised); ``gt_label`` ``[N, B]``. Each ground truth takes its
    cell's best anchor by shape IoU (box and class losses there, scaled by
    ``gt_score`` if given); the objectness BCE skips unmatched cells whose
    decoded box overlaps a ground truth above ``ignore_thresh``."""
    x = _tensor(x, torch.float32)
    gt_box = _tensor(gt_box, torch.float32, like=x)
    gt_label = _tensor(gt_label, like=x).to(torch.int64)
    dev = x.device
    n, _, h, w = x.shape
    m = len(anchor_mask)
    x = x.reshape(n, m, 5 + class_num, h, w)
    tx, ty = x[:, :, 0], x[:, :, 1]
    tw, th = x[:, :, 2], x[:, :, 3]
    tobj = x[:, :, 4]
    tcls = x[:, :, 5:]
    masked = [(anchors[2 * i], anchors[2 * i + 1]) for i in anchor_mask]
    aw = torch.tensor([a[0] for a in masked], dtype=torch.float32,
                      device=dev)
    ah = torch.tensor([a[1] for a in masked], dtype=torch.float32,
                      device=dev)
    in_w, in_h = w * downsample_ratio, h * downsample_ratio

    bs = gt_box.shape[1]
    valid = (gt_box[:, :, 2] > 0) & (gt_box[:, :, 3] > 0)
    gi = (gt_box[:, :, 0] * w).to(torch.int64).clamp(0, w - 1)
    gj = (gt_box[:, :, 1] * h).to(torch.int64).clamp(0, h - 1)
    gw = gt_box[:, :, 2] * in_w
    gh = gt_box[:, :, 3] * in_h
    inter = torch.minimum(gw[..., None], aw) * torch.minimum(gh[..., None],
                                                             ah)
    union = gw[..., None] * gh[..., None] + aw * ah - inter
    best_a = torch.argmax(inter / union.clamp_min(1e-9), dim=-1)  # [N, B]

    batch_idx = torch.arange(n, device=dev)[:, None].expand(n, bs)
    sel = (batch_idx, best_a, gj, gi)
    vf = valid.float()
    if gt_score is not None:
        vf = vf * _tensor(gt_score, torch.float32, like=x)
    txy_t_x = gt_box[:, :, 0] * w - gi
    txy_t_y = gt_box[:, :, 1] * h - gj
    twh_t_w = torch.log((gw / aw[best_a]).clamp_min(1e-9))
    twh_t_h = torch.log((gh / ah[best_a]).clamp_min(1e-9))
    sx = torch.sigmoid(tx[sel])
    sy = torch.sigmoid(ty[sel])
    box_l = vf * ((sx - txy_t_x) ** 2 + (sy - txy_t_y) ** 2 +
                  (tw[sel] - twh_t_w) ** 2 + (th[sel] - twh_t_h) ** 2)
    smooth = (1.0 / class_num if use_label_smooth else 0.0)
    # one_hot as jax.nn.one_hot: a label outside [0, class_num) is all 0
    onehot = (gt_label[..., None] == torch.arange(class_num, device=dev))
    cls_t = onehot.float() * (1 - 2 * smooth) + smooth
    cls_logit = torch.movedim(tcls, 2, -1)[sel]                # [N, B, cls]
    cls_l = vf * torch.sum(
        cls_logit.clamp_min(0) - cls_logit * cls_t +
        torch.log1p(torch.exp(-cls_logit.abs())), dim=-1)
    flat = ((batch_idx * m + best_a) * h + gj) * w + gi
    obj_target = torch.zeros(n * m * h * w, device=dev).scatter_reduce(
        0, flat.reshape(-1), vf.reshape(-1), reduce="amax",
        include_self=True).reshape(n, m, h, w)

    # the ignore mask: an unmatched cell whose decoded box overlaps any
    # ground truth above ignore_thresh leaves the negative objectness BCE
    grid_x = torch.arange(w, dtype=torch.float32, device=dev)[None, None,
                                                              None, :]
    grid_y = torch.arange(h, dtype=torch.float32, device=dev)[None, None, :,
                                                              None]
    px = ((grid_x + torch.sigmoid(tx)) / w).detach()
    py = ((grid_y + torch.sigmoid(ty)) / h).detach()
    pw = (aw[None, :, None, None] * torch.exp(tw) / in_w).detach()
    phh = (ah[None, :, None, None] * torch.exp(th) / in_h).detach()
    gx1 = (gt_box[:, :, 0] - gt_box[:, :, 2] / 2)[:, None, None, None, :]
    gy1 = (gt_box[:, :, 1] - gt_box[:, :, 3] / 2)[:, None, None, None, :]
    gx2 = (gt_box[:, :, 0] + gt_box[:, :, 2] / 2)[:, None, None, None, :]
    gy2 = (gt_box[:, :, 1] + gt_box[:, :, 3] / 2)[:, None, None, None, :]
    iw = (torch.minimum((px + pw / 2)[..., None], gx2)
          - torch.maximum((px - pw / 2)[..., None], gx1)).clamp_min(0)
    ih = (torch.minimum((py + phh / 2)[..., None], gy2)
          - torch.maximum((py - phh / 2)[..., None], gy1)).clamp_min(0)
    inter_p = iw * ih
    union_p = (pw * phh)[..., None] + (gt_box[:, :, 2] * gt_box[:, :, 3]
                                       )[:, None, None, None, :] - inter_p
    iou_p = torch.where(valid[:, None, None, None, :],
                        inter_p / union_p.clamp_min(1e-9),
                        torch.zeros((), device=dev))
    best_iou = iou_p.amax(dim=-1)                              # [N, m, h, w]
    obj_weight = torch.where((best_iou > ignore_thresh) & (obj_target <= 0),
                             0.0, 1.0)
    obj_ce = obj_weight * (tobj.clamp_min(0) - tobj * obj_target +
                           torch.log1p(torch.exp(-tobj.abs())))
    return torch.sum(box_l + cls_l, dim=1) + torch.sum(obj_ce, dim=(1, 2, 3))


def generate_proposals(scores, bbox_deltas, img_size, anchors, variances,
                       pre_nms_top_n: int = 6000, post_nms_top_n: int = 1000,
                       nms_thresh: float = 0.5, min_size: float = 0.1,
                       eta: float = 1.0, pixel_offset: bool = False,
                       return_rois_num: bool = False, name=None):
    """RPN proposals, an image at a time: the ``pre_nms_top_n`` best
    anchors decoded by their deltas, clipped to the image, those narrower
    or shorter than ``min_size`` scored -inf, :func:`nms`, its first
    ``post_nms_top_n``, and the -inf ones that survived for want of
    others dropped. Returns (rois, scores[, rois_num])."""
    scores = _tensor(scores, torch.float32)            # [N, A, H, W]
    deltas = _tensor(bbox_deltas, torch.float32, like=scores)  # [N, 4A, H, W]
    anchors_f = _tensor(anchors, torch.float32, like=scores).reshape(-1, 4)
    var = _tensor(variances, torch.float32, like=scores).reshape(-1, 4)
    sizes = as_host_array(img_size).astype(np.float32)
    n = scores.shape[0]
    off = 1.0 if pixel_offset else 0.0
    neg_inf = torch.full((), float("-inf"), device=scores.device)
    all_rois, all_scores, rois_num = [], [], []
    for i in range(n):
        sc = scores[i].permute(1, 2, 0).reshape(-1)
        dl = deltas[i].reshape(-1, 4, scores.shape[2],
                               scores.shape[3]).permute(2, 3, 0, 1)
        dl = dl.reshape(-1, 4)
        k = min(int(pre_nms_top_n), sc.shape[0])
        top = torch.argsort(-sc, stable=True)[:k]
        sc_k, dl_k = sc[top], dl[top]
        an_k = anchors_f[top % anchors_f.shape[0]]
        var_k = var[top % var.shape[0]]
        aw = an_k[:, 2] - an_k[:, 0] + off
        ah = an_k[:, 3] - an_k[:, 1] + off
        acx = an_k[:, 0] + aw / 2
        acy = an_k[:, 1] + ah / 2
        cx = var_k[:, 0] * dl_k[:, 0] * aw + acx
        cy = var_k[:, 1] * dl_k[:, 1] * ah + acy
        bw = aw * torch.exp((var_k[:, 2] * dl_k[:, 2]).clamp(max=10.0))
        bh = ah * torch.exp((var_k[:, 3] * dl_k[:, 3]).clamp(max=10.0))
        hmax, wmax = float(sizes[i][0]), float(sizes[i][1])
        boxes = torch.stack([(cx - bw / 2).clamp(0, wmax),
                             (cy - bh / 2).clamp(0, hmax),
                             (cx + bw / 2).clamp(0, wmax),
                             (cy + bh / 2).clamp(0, hmax)], dim=1)
        keep_sz = ((boxes[:, 2] - boxes[:, 0] >= min_size) &
                   (boxes[:, 3] - boxes[:, 1] >= min_size))
        sc_k = torch.where(keep_sz, sc_k, neg_inf)
        keep = nms(boxes, nms_thresh, scores=sc_k,
                   top_k=int(post_nms_top_n))
        keep = keep[sc_k[keep] > float("-inf")]
        all_rois.append(boxes[keep])
        all_scores.append(sc_k[keep])
        rois_num.append(int(keep.shape[0]))
    rois = torch.cat(all_rois)
    rscores = torch.cat(all_scores)
    if return_rois_num:
        return rois, rscores, torch.as_tensor(rois_num, dtype=torch.int64,
                                              device=scores.device)
    return rois, rscores
