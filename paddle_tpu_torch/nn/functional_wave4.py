"""The rest of ``paddle.nn.functional`` (``paddle_tpu/nn/functional_wave4.py``
counterpart): distances, the channel dropouts, the adaptive max pools and
the 1-D and 3-D unpools, the remaining losses, and the functional forms of
:class:`~.layers.HSigmoidLoss`, :class:`~.layers.RNNTLoss` and the beam
backtrace. Each computes what the JAX function computes; the dropouts
draw their masks from the port's key stream (the bits differ from JAX's).
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch
import torch.nn.functional as TF

from ..core.random import next_key, torch_generator

__all__ = [
    "pairwise_distance", "diag_embed", "dropout2d", "dropout3d",
    "alpha_dropout", "zeropad2d", "bilinear", "max_unpool1d", "max_unpool3d",
    "adaptive_avg_pool3d", "adaptive_max_pool1d", "adaptive_max_pool2d",
    "adaptive_max_pool3d", "hsigmoid_loss", "sigmoid_focal_loss",
    "rnnt_loss", "gather_tree", "sparse_attention",
    "triplet_margin_with_distance_loss", "multi_margin_loss",
    "gaussian_nll_loss",
]


def pairwise_distance(x, y, p: float = 2.0, epsilon: float = 1e-6,
                      keepdim: bool = False, name=None):
    """``||x − y + eps||_p`` along the last axis."""
    d = x - y + epsilon
    if p == float("inf"):
        return torch.amax(torch.abs(d), dim=-1, keepdim=keepdim)
    if p == 1.0:
        return torch.sum(torch.abs(d), dim=-1, keepdim=keepdim)
    return torch.sum(torch.abs(d) ** p, dim=-1, keepdim=keepdim) ** (1.0 / p)


def diag_embed(input, offset: int = 0, dim1: int = -2, dim2: int = -1,
               name=None):
    """Batched vectors as batched diagonal matrices (``offset`` above or
    below the diagonal), the two new axes at ``dim1`` and ``dim2``."""
    return torch.diag_embed(input, offset=offset, dim1=dim1, dim2=dim2)


def _bernoulli(keep: float, shape, device, key=None) -> torch.Tensor:
    gen = torch_generator(next_key() if key is None else key, device)
    return torch.rand(shape, generator=gen, device=device) < keep


def _channel_dropout(x, p, training, spatial_dims):
    if not training or p == 0.0:
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    shape = list(x.shape)
    for d in spatial_dims:
        shape[d] = 1
    keep = _bernoulli(1.0 - p, tuple(shape), x.device)
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x)).to(x.dtype)


def dropout2d(x, p: float = 0.5, training: bool = True,
              data_format: str = "NCHW", name=None):
    """Whole-channel dropout: one draw a ``(sample, channel)``."""
    sp = (2, 3) if data_format == "NCHW" else (1, 2)
    return _channel_dropout(x, p, training, sp)


def dropout3d(x, p: float = 0.5, training: bool = True,
              data_format: str = "NCDHW", name=None):
    sp = (2, 3, 4) if data_format == "NCDHW" else (1, 2, 3)
    return _channel_dropout(x, p, training, sp)


def alpha_dropout(x, p: float = 0.5, training: bool = True, name=None):
    """SELU-preserving dropout: a dropped unit takes ``−scale·alpha``, then
    ``a·out + b`` keeps the mean and variance."""
    if not training or p == 0.0:
        return x
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    keep = _bernoulli(1.0 - p, x.shape, x.device)
    a = ((1.0 - p) * (1 + p * alpha_p ** 2)) ** -0.5
    b = -a * alpha_p * p
    out = torch.where(keep, x, torch.full_like(x, alpha_p))
    return (a * out + b).to(x.dtype)


def zeropad2d(x, padding, data_format: str = "NCHW", name=None):
    from .functional import pad
    return pad(x, padding, mode="constant", value=0.0,
               data_format=data_format)


def bilinear(x1, x2, weight, bias=None, name=None):
    """``y[b, o] = x1[b] · W[o] · x2[b] (+ bias)``, weight ``[out, in1,
    in2]``."""
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out + bias if bias is not None else out


def _unpool(x, indices, kernel_size, stride, padding, output_size, nd):
    """Scatter each value to its flat spatial position."""
    if isinstance(kernel_size, int):
        kernel_size = (kernel_size,) * nd
    stride = stride or kernel_size
    if isinstance(stride, int):
        stride = (stride,) * nd
    if isinstance(padding, int):
        padding = (padding,) * nd
    spatial_in = x.shape[2:]
    if output_size is None:
        output_size = tuple(
            (spatial_in[i] - 1) * stride[i] - 2 * padding[i] + kernel_size[i]
            for i in range(nd))
    else:
        output_size = tuple(output_size)[-nd:]
    n, c = x.shape[0], x.shape[1]
    out = x.new_zeros((n, c, int(np.prod(output_size))))
    out = out.scatter(2, indices.reshape(n, c, -1).long(),
                      x.reshape(n, c, -1))
    return out.reshape((n, c) + tuple(output_size))


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format: str = "NCL", output_size=None, name=None):
    if data_format != "NCL":
        raise NotImplementedError("max_unpool1d supports NCL")
    return _unpool(x, indices, kernel_size, stride, padding, output_size, 1)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format: str = "NCDHW", output_size=None, name=None):
    if data_format != "NCDHW":
        raise NotImplementedError("max_unpool3d supports NCDHW")
    return _unpool(x, indices, kernel_size, stride, padding, output_size, 3)


def _windows(in_sz: int, out_sz: int):
    """Adaptive pooling's windows, ``[floor(i·in/out),
    ceil((i+1)·in/out))``."""
    return [((i * in_sz) // out_sz, -(-((i + 1) * in_sz) // out_sz))
            for i in range(out_sz)]


def _adaptive_pool(x, output_size, nd, op):
    """Adaptive pooling over the trailing ``nd`` axes, one axis at a time;
    a None size keeps the axis."""
    if isinstance(output_size, int):
        output_size = (output_size,) * nd
    output_size = tuple(s if s is not None else x.shape[2 + i]
                        for i, s in enumerate(output_size))
    out = x
    for d in range(nd):
        axis = 2 + d
        out = torch.cat([op(out.narrow(axis, lo, hi - lo), axis)
                         for lo, hi in _windows(out.shape[axis],
                                                output_size[d])], dim=axis)
    return out


def _mean(t, axis):
    return t.mean(dim=axis, keepdim=True)


def _max(t, axis):
    return t.amax(dim=axis, keepdim=True)


def adaptive_avg_pool3d(x, output_size, data_format: str = "NCDHW",
                        name=None):
    if data_format != "NCDHW":
        raise NotImplementedError("adaptive_avg_pool3d supports NCDHW")
    return _adaptive_pool(x, output_size, 3, _mean)


def _adaptive_argmax(x, output_size, nd):
    """The flat spatial index of each window's first maximum (int64; JAX's
    is int32)."""
    if isinstance(output_size, int):
        output_size = (output_size,) * nd
    spatial = tuple(x.shape[2:])
    n, c = x.shape[:2]
    out = torch.zeros((n, c) + tuple(output_size), dtype=torch.long,
                      device=x.device)
    strides = np.cumprod((spatial + (1,))[::-1])[::-1][1:]
    for cell in itertools.product(*(range(s) for s in output_size)):
        bounds = [_windows(spatial[d], output_size[d])[i]
                  for d, i in enumerate(cell)]
        sl = (slice(None), slice(None)) + tuple(slice(lo, hi)
                                                for lo, hi in bounds)
        window = x[sl].reshape(n, c, -1)
        # the first maximum, as jnp.argmax breaks ties
        hit = window == window.amax(-1, keepdim=True)
        pos = torch.arange(window.shape[-1], device=x.device)
        local = torch.where(hit, pos, window.shape[-1]).amin(-1)
        wshape = [hi - lo for lo, hi in bounds]
        gflat = torch.zeros_like(local)
        rem = local
        for d in range(nd):
            inner = int(np.prod(wshape[d + 1:]))
            coord = torch.div(rem, inner, rounding_mode="floor")
            rem = rem - coord * inner
            gflat = gflat + (coord + bounds[d][0]) * int(strides[d])
        out[(slice(None), slice(None)) + cell] = gflat
    return out


def adaptive_max_pool1d(x, output_size, return_mask: bool = False,
                        name=None):
    out = _adaptive_pool(x, output_size, 1, _max)
    if return_mask:
        return out, _adaptive_argmax(x, output_size, 1)
    return out


def adaptive_max_pool2d(x, output_size, return_mask: bool = False,
                        name=None):
    out = _adaptive_pool(x, output_size, 2, _max)
    if return_mask:
        return out, _adaptive_argmax(x, output_size, 2)
    return out


def adaptive_max_pool3d(x, output_size, return_mask: bool = False,
                        name=None):
    out = _adaptive_pool(x, output_size, 3, _max)
    if return_mask:
        return out, _adaptive_argmax(x, output_size, 3)
    return out


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse: bool = False,
                  name=None):
    """:class:`~.layers.HSigmoidLoss` over the caller's ``[num_classes −
    1, feature]`` weight (and bias): the default complete binary tree."""
    from .layers import hsigmoid_paths, hsigmoid_nll
    paths, codes, valid = (t.to(input.device)
                           for t in hsigmoid_paths(num_classes))
    return hsigmoid_nll(input, label, weight, bias, paths, codes, valid)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha: float = 0.25,
                       gamma: float = 2.0, reduction: str = "sum",
                       name=None):
    """RetinaNet's focal loss on sigmoid probabilities, in float32."""
    from .functional import log_sigmoid
    logit, label = logit.float(), label.float()
    p = torch.sigmoid(logit)
    ce = -(label * log_sigmoid(logit) + (1 - label) * log_sigmoid(-logit))
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    loss = a_t * ((1 - p_t) ** gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    if reduction == "sum":
        return loss.sum()
    if reduction == "mean":
        return loss.mean()
    return loss


def rnnt_loss(input, label, input_lengths, label_lengths, blank: int = 0,
              fastemit_lambda: float = 0.001, reduction: str = "mean",
              name=None):
    """:class:`~.layers.RNNTLoss`'s transducer loss."""
    from .layers import RNNTLoss
    return RNNTLoss(blank=blank, fastemit_lambda=fastemit_lambda,
                    reduction=reduction)(input, label, input_lengths,
                                         label_lengths)


def gather_tree(ids, parents):
    """The beam-search backtrace: ``ids``/``parents`` ``[T, B, W]``; from
    the last step back, each step's token of the beam its parent pointers
    lead to."""
    t = ids.shape[0]
    beams = torch.arange(ids.shape[2], device=ids.device).expand(
        ids.shape[1:]).contiguous()
    out = [None] * t
    for i in reversed(range(t)):
        out[i] = torch.gather(ids[i], -1, beams)
        beams = torch.gather(parents[i], -1, beams)
    return torch.stack(out)


def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None, name=None):
    """Attention restricted to each row's CSR column list (JAX's dense
    gather form, ``functional_wave4.py:307-340``): q/k/v ``[B, H, S, D]``,
    offsets ``[B, H, S + 1]``, columns ``[B, H, nnz]``; each row gathers
    its keys, padded to the largest degree, and softmaxes over them.
    ``key_padding_mask`` and ``attn_mask`` are taken and unused, as in
    JAX."""
    off = torch.as_tensor(sparse_csr_offset, device=query.device).long()
    cols = torch.as_tensor(sparse_csr_columns, device=query.device).long()
    b, h, s, d = query.shape
    deg = off[..., 1:] - off[..., :-1]                    # [B, H, S]
    max_deg = max(int(deg.max()) if deg.numel() else 0, 1)
    slot = torch.arange(max_deg, device=query.device)
    idx = off[..., :-1, None] + slot                      # [B, H, S, deg]
    valid = slot < deg[..., None]
    ci = torch.gather(cols, 2, idx.clamp(0, cols.shape[-1] - 1).reshape(
        b, h, -1)).reshape(b, h, s, max_deg)
    kk = torch.gather(key, 2, ci.reshape(b, h, -1, 1).expand(-1, -1, -1, d)
                      ).reshape(b, h, s, max_deg, d)
    vv = torch.gather(value, 2, ci.reshape(b, h, -1, 1).expand(-1, -1, -1, d)
                      ).reshape(b, h, s, max_deg, d)
    sc = torch.einsum("bhsd,bhskd->bhsk", query, kk) / math.sqrt(d)
    sc = torch.where(valid, sc, float("-inf"))
    p = torch.where(valid, torch.softmax(sc, dim=-1), 0.0)
    return torch.einsum("bhsk,bhskd->bhsd", p, vv)


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None,
                                      margin: float = 1.0,
                                      swap: bool = False,
                                      reduction: str = "mean", name=None):
    dist = distance_function or pairwise_distance
    dp, dn = dist(input, positive), dist(input, negative)
    if swap:
        dn = torch.minimum(dn, dist(positive, negative))
    loss = torch.clamp_min(dp - dn + margin, 0.0)
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def multi_margin_loss(input, label, p: int = 1, margin: float = 1.0,
                      weight=None, reduction: str = "mean", name=None):
    """The multi-class hinge: ``sum_{j≠y} max(0, margin − x[y] +
    x[j])^p / C``."""
    n, c = input.shape
    label = label.long()
    correct = torch.gather(input, 1, label[:, None])
    term = torch.clamp_min(margin - correct + input, 0.0) ** p
    if weight is not None:
        term = term * torch.as_tensor(weight, device=input.device)[label][
            :, None]
    mask = TF.one_hot(label, c).to(input.dtype)
    loss = torch.sum(term * (1 - mask), dim=1) / c
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def gaussian_nll_loss(input, label, variance, full: bool = False,
                      epsilon: float = 1e-6, reduction: str = "mean",
                      name=None):
    """``0.5·(log var + (x − y)²/var)`` in float32, ``var`` clipped below
    at ``epsilon``; ``full`` adds ``0.5·log 2π``."""
    x, y = input.float(), label.float()
    var = torch.clamp_min(torch.as_tensor(variance).float(), epsilon)
    loss = 0.5 * (torch.log(var) + (x - y) ** 2 / var)
    if full:
        loss = loss + 0.5 * math.log(2 * math.pi)
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss
