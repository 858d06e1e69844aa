"""Functional image transforms of the port
(``paddle_tpu/vision/transforms/functional.py`` counterpart).

Host-side numpy, as in the JAX package and with its formulas: every
function takes an HWC, CHW (1, 3 or 4 leading channels) or 2-D numpy
array and returns numpy, so a DataLoader's workers run them and its
collate and shared-memory queue carry their output as they carry any
numpy batch. ``resize`` samples half-pixel bilinear (nearest at
``(i + 0.5)·h/oh``; an int ``size`` sets the shorter edge; integer images
round back with ``np.round``); ``rotate`` maps each output pixel back to
its source; ``affine`` and ``perspective`` sample through
:func:`_inverse_sample`; ``adjust_hue`` goes round HSV.
"""

from __future__ import annotations

import numbers

import numpy as np

__all__ = ["to_tensor", "normalize", "resize", "hflip", "vflip", "crop",
           "center_crop", "pad", "rotate", "to_grayscale",
           "adjust_brightness", "adjust_contrast", "adjust_saturation",
           "adjust_hue", "erase"]


def _is_chw(img: np.ndarray) -> bool:
    return img.ndim == 3 and img.shape[0] in (1, 3, 4)


def _as_hwc(img):
    img = np.asarray(img)
    if _is_chw(img):
        return img.transpose(1, 2, 0), True
    if img.ndim == 2:
        return img[..., None], False
    return img, False


def _restore(img, was_chw):
    if was_chw:
        return img.transpose(2, 0, 1)
    return img


def to_tensor(img, data_format: str = "CHW"):
    arr = np.asarray(img)
    # Scale by dtype, not by data-dependent range: a nearly-black uint8
    # image must not skip the /255 (ref functional.to_tensor semantics).
    if arr.dtype == np.uint8:
        img = arr.astype(np.float32) / 255.0
    else:
        img = arr.astype(np.float32)
    if img.ndim == 2:
        img = img[None] if data_format == "CHW" else img[..., None]
    elif data_format == "CHW" and img.shape[-1] in (1, 3, 4):
        img = img.transpose(2, 0, 1)
    return img


def normalize(img, mean, std, data_format: str = "CHW", to_rgb=False):
    img = np.asarray(img, dtype=np.float32)
    mean = np.asarray(mean, dtype=np.float32)
    std = np.asarray(std, dtype=np.float32)
    shape = (-1, 1, 1) if data_format == "CHW" else (1, 1, -1)
    return (img - mean.reshape(shape)) / std.reshape(shape)


def resize(img, size, interpolation: str = "bilinear"):
    """Bilinear/nearest resize in numpy (HWC/CHW/2D)."""
    arr, was_chw = _as_hwc(img)
    h, w = arr.shape[:2]
    if isinstance(size, int):
        # paddle semantics: shorter edge -> size, keep aspect
        if h <= w:
            oh, ow = size, max(1, round(w * size / h))
        else:
            oh, ow = max(1, round(h * size / w)), size
    else:
        oh, ow = size
    if interpolation == "nearest":
        ys = np.clip((np.arange(oh) + 0.5) * h / oh, 0, h - 1).astype(int)
        xs = np.clip((np.arange(ow) + 0.5) * w / ow, 0, w - 1).astype(int)
        out = arr[ys][:, xs]
    else:  # bilinear
        ys = (np.arange(oh) + 0.5) * h / oh - 0.5
        xs = (np.arange(ow) + 0.5) * w / ow - 0.5
        y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
        x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
        y1 = np.clip(y0 + 1, 0, h - 1)
        x1 = np.clip(x0 + 1, 0, w - 1)
        wy = np.clip(ys - y0, 0, 1)[:, None, None]
        wx = np.clip(xs - x0, 0, 1)[None, :, None]
        a = arr.astype(np.float32)
        out = ((a[y0][:, x0] * (1 - wy) * (1 - wx))
               + (a[y0][:, x1] * (1 - wy) * wx)
               + (a[y1][:, x0] * wy * (1 - wx))
               + (a[y1][:, x1] * wy * wx))
        if np.issubdtype(arr.dtype, np.integer):
            out = np.round(out).astype(arr.dtype)
        else:
            out = out.astype(arr.dtype)
    if np.asarray(img).ndim == 2:
        out = out[..., 0]
        return out
    return _restore(out, was_chw)


def hflip(img):
    arr = np.asarray(img)
    return arr[..., ::-1].copy() if _is_chw(arr) or arr.ndim == 2 \
        else arr[:, ::-1].copy()


def vflip(img):
    arr = np.asarray(img)
    if _is_chw(arr):
        return arr[:, ::-1].copy()
    return arr[::-1].copy()


def crop(img, top: int, left: int, height: int, width: int):
    arr = np.asarray(img)
    if _is_chw(arr):
        return arr[:, top:top + height, left:left + width]
    return arr[top:top + height, left:left + width]


def center_crop(img, output_size):
    if isinstance(output_size, numbers.Number):
        output_size = (int(output_size), int(output_size))
    arr = np.asarray(img)
    h, w = arr.shape[1:3] if _is_chw(arr) else arr.shape[:2]
    th, tw = output_size
    return crop(arr, (h - th) // 2, (w - tw) // 2, th, tw)


def pad(img, padding, fill=0, padding_mode: str = "constant"):
    arr = np.asarray(img)
    if isinstance(padding, numbers.Number):
        pl = pr = pt = pb = int(padding)
    elif len(padding) == 2:
        pl, pt = padding
        pr, pb = padding
    else:
        pl, pt, pr, pb = padding
    chw = _is_chw(arr)
    widths = [(0, 0)] * arr.ndim
    if chw:
        widths[1] = (pt, pb)
        widths[2] = (pl, pr)
    else:
        widths[0] = (pt, pb)
        widths[1] = (pl, pr)
    mode = {"constant": "constant", "edge": "edge", "reflect": "reflect",
            "symmetric": "symmetric"}[padding_mode]
    kw = {"constant_values": fill} if padding_mode == "constant" else {}
    return np.pad(arr, widths, mode=mode, **kw)


def rotate(img, angle: float, interpolation: str = "nearest",
           expand: bool = False, center=None, fill=0):
    """Rotate counter-clockwise by `angle` degrees (nearest sampling)."""
    arr, was_chw = _as_hwc(img)
    h, w = arr.shape[:2]
    cy, cx = ((h - 1) / 2, (w - 1) / 2) if center is None else \
        (center[1], center[0])
    rad = np.deg2rad(angle)
    cos, sin = np.cos(rad), np.sin(rad)
    if expand:
        corners = np.array([[-cy, -cx], [-cy, w - 1 - cx],
                            [h - 1 - cy, -cx], [h - 1 - cy, w - 1 - cx]])
        ys = corners[:, 0] * cos - corners[:, 1] * sin
        xs = corners[:, 0] * sin + corners[:, 1] * cos
        oh = int(np.ceil(ys.max() - ys.min() + 1))
        ow = int(np.ceil(xs.max() - xs.min() + 1))
        ocy, ocx = (oh - 1) / 2, (ow - 1) / 2
    else:
        oh, ow, ocy, ocx = h, w, cy, cx
    yy, xx = np.meshgrid(np.arange(oh, dtype=np.float64) - ocy,
                         np.arange(ow, dtype=np.float64) - ocx,
                         indexing="ij")
    # inverse mapping (sample source for each output pixel)
    sy = yy * cos + xx * sin + cy
    sx = -yy * sin + xx * cos + cx
    if interpolation == "bilinear":
        eps = 1e-6  # boundary pixels land exactly on h-1/w-1 up to fp error
        valid = (sy >= -eps) & (sy <= h - 1 + eps) \
            & (sx >= -eps) & (sx <= w - 1 + eps)
        sy = np.clip(sy, 0, h - 1)
        sx = np.clip(sx, 0, w - 1)
        y0 = np.floor(sy).astype(int)
        x0 = np.floor(sx).astype(int)
        wy = (sy - y0)[..., None]
        wx = (sx - x0)[..., None]

        def at(yi, xi):
            return arr[np.clip(yi, 0, h - 1),
                       np.clip(xi, 0, w - 1)].astype(np.float64)

        val = (at(y0, x0) * (1 - wy) * (1 - wx)
               + at(y0, x0 + 1) * (1 - wy) * wx
               + at(y0 + 1, x0) * wy * (1 - wx)
               + at(y0 + 1, x0 + 1) * wy * wx)
        out = np.full((oh, ow, arr.shape[2]), fill, dtype=arr.dtype)
        out[valid] = np.round(val[valid]).astype(arr.dtype) \
            if np.issubdtype(arr.dtype, np.integer) \
            else val[valid].astype(arr.dtype)
    else:  # nearest
        syi = np.round(sy).astype(int)
        sxi = np.round(sx).astype(int)
        valid = (syi >= 0) & (syi < h) & (sxi >= 0) & (sxi < w)
        out = np.full((oh, ow, arr.shape[2]), fill, dtype=arr.dtype)
        out[valid] = arr[syi[valid], sxi[valid]]
    if np.asarray(img).ndim == 2:
        return out[..., 0]
    return _restore(out, was_chw)


def to_grayscale(img, num_output_channels: int = 1):
    arr, was_chw = _as_hwc(img)
    if arr.shape[2] >= 3:
        gray = (0.299 * arr[..., 0] + 0.587 * arr[..., 1]
                + 0.114 * arr[..., 2])
    else:
        gray = arr[..., 0]
    gray = gray.astype(arr.dtype)[..., None]
    out = np.repeat(gray, num_output_channels, axis=2)
    return _restore(out, was_chw)


def _blend(a, b, factor):
    out = a.astype(np.float32) * factor + b.astype(np.float32) * (1 - factor)
    if np.issubdtype(np.asarray(a).dtype, np.integer):
        return np.clip(out, 0, 255).astype(np.asarray(a).dtype)
    return out.astype(np.asarray(a).dtype)


def adjust_brightness(img, brightness_factor: float):
    arr = np.asarray(img)
    return _blend(arr, np.zeros_like(arr), brightness_factor)


def adjust_contrast(img, contrast_factor: float):
    arr, was_chw = _as_hwc(img)
    mean = to_grayscale(arr).mean()
    out = _blend(arr, np.full_like(arr, mean), contrast_factor)
    return _restore(out, was_chw)


def adjust_saturation(img, saturation_factor: float):
    arr, was_chw = _as_hwc(img)
    gray = to_grayscale(arr, arr.shape[2])
    out = _blend(arr, gray, saturation_factor)
    return _restore(out, was_chw)


def adjust_hue(img, hue_factor: float):
    """Shift hue by hue_factor (in [-0.5, 0.5] turns) via HSV roundtrip."""
    assert -0.5 <= hue_factor <= 0.5
    arr, was_chw = _as_hwc(img)
    a = arr.astype(np.float32)
    scale = 255.0 if arr.dtype == np.uint8 or a.max() > 1.0 else 1.0
    a = a[..., :3] / scale  # hue acts on RGB only; alpha re-attached below
    r, g, b = a[..., 0], a[..., 1], a[..., 2]
    maxc = a.max(-1)
    minc = a.min(-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0)
    dz = np.maximum(delta, 1e-12)
    hr = np.where((maxc == r), (g - b) / dz % 6, 0)
    hg = np.where((maxc == g) & (maxc != r), (b - r) / dz + 2, 0)
    hb = np.where((maxc == b) & (maxc != r) & (maxc != g),
                  (r - g) / dz + 4, 0)
    hue = (hr + hg + hb) / 6.0
    hue = (hue + hue_factor) % 1.0
    i = np.floor(hue * 6.0)
    f = hue * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = (i.astype(int) % 6)[..., None]  # broadcast over the channel axis
    out = np.select(
        [i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
        [np.stack([v, t, p], -1), np.stack([q, v, p], -1),
         np.stack([p, v, t], -1), np.stack([p, q, v], -1),
         np.stack([t, p, v], -1), np.stack([v, p, q], -1)])
    out = out * scale
    if arr.dtype == np.uint8:
        out = np.clip(np.round(out), 0, 255).astype(np.uint8)
    else:
        out = out.astype(arr.dtype)
    if arr.shape[2] > 3:  # preserve alpha
        out = np.concatenate([out, arr[..., 3:]], axis=2)
    return _restore(out, was_chw)


def erase(img, i: int, j: int, h: int, w: int, v, inplace: bool = False):
    arr = np.asarray(img) if inplace else np.asarray(img).copy()
    if _is_chw(arr):
        arr[:, i:i + h, j:j + w] = v
    else:
        arr[i:i + h, j:j + w] = v
    return arr


def _inverse_sample(arr, inv_map, interpolation, fill):
    """Sample arr at inverse-mapped coords (shared by affine/perspective)."""
    h, w = arr.shape[:2]
    oh, ow = h, w
    yy, xx = np.meshgrid(np.arange(oh, dtype=np.float64),
                         np.arange(ow, dtype=np.float64), indexing="ij")
    sy, sx = inv_map(yy, xx)
    syi = np.round(sy).astype(int)
    sxi = np.round(sx).astype(int)
    valid = (syi >= 0) & (syi < h) & (sxi >= 0) & (sxi < w)
    out = np.full((oh, ow, arr.shape[2]), fill, dtype=arr.dtype)
    out[valid] = arr[syi[valid], sxi[valid]]
    return out, valid


def affine(img, angle: float, translate, scale: float, shear,
           interpolation: str = "nearest", fill=0, center=None):
    """Affine transform (ref transforms/functional.py affine): rotate +
    translate + scale + shear about the image centre."""
    arr, was_chw = _as_hwc(img)
    h, w = arr.shape[:2]
    cy, cx = ((h - 1) / 2, (w - 1) / 2) if center is None else \
        (center[1], center[0])
    if np.isscalar(shear):
        shear = (float(shear), 0.0)
    rad = np.deg2rad(angle)
    sx_r, sy_r = np.deg2rad(shear[0]), np.deg2rad(shear[1])
    # forward matrix: R @ Shear * scale
    a = np.cos(rad + sy_r) * scale
    b = -np.sin(rad + sy_r) * scale
    c = np.sin(rad + sx_r) * scale
    d = np.cos(rad + sx_r) * scale
    m = np.array([[d, -b], [-c, a]]) / (a * d - b * c)  # inverse

    def inv(yy, xx):
        ty, tx = translate[1], translate[0]
        ry = yy - cy - ty
        rx = xx - cx - tx
        sy = m[0, 0] * ry + m[0, 1] * rx + cy
        sxx = m[1, 0] * ry + m[1, 1] * rx + cx
        return sy, sxx

    out, _ = _inverse_sample(arr, inv, interpolation, fill)
    if np.asarray(img).ndim == 2:
        return out[..., 0]
    return _restore(out, was_chw)


def perspective(img, startpoints, endpoints, interpolation: str = "nearest",
                fill=0):
    """Perspective warp mapping startpoints -> endpoints (ref
    transforms/functional.py perspective): solve the 8-dof homography,
    inverse-sample."""
    arr, was_chw = _as_hwc(img)
    sp = np.asarray(startpoints, np.float64)   # [(x, y)] * 4
    ep = np.asarray(endpoints, np.float64)
    # homography H with ep = H @ sp; build from endpoint->startpoint for
    # inverse sampling
    A = []
    bvec = []
    for (xs, ys), (xe, ye) in zip(sp, ep):
        A.append([xe, ye, 1, 0, 0, 0, -xs * xe, -xs * ye])
        bvec.append(xs)
        A.append([0, 0, 0, xe, ye, 1, -ys * xe, -ys * ye])
        bvec.append(ys)
    coef = np.linalg.solve(np.asarray(A), np.asarray(bvec))
    hmat = np.append(coef, 1.0).reshape(3, 3)

    def inv(yy, xx):
        denom = hmat[2, 0] * xx + hmat[2, 1] * yy + hmat[2, 2]
        sx = (hmat[0, 0] * xx + hmat[0, 1] * yy + hmat[0, 2]) / denom
        sy = (hmat[1, 0] * xx + hmat[1, 1] * yy + hmat[1, 2]) / denom
        return sy, sx

    out, _ = _inverse_sample(arr, inv, interpolation, fill)
    if np.asarray(img).ndim == 2:
        return out[..., 0]
    return _restore(out, was_chw)
