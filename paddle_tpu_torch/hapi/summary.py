"""``paddle.summary`` (``paddle_tpu/hapi/summary.py`` counterpart).

Runs one forward pass in eval mode, with forward hooks on every leaf layer
recording its output shape, then prints the JAX package's layer table
(the same rows, widths and parameter counts) and returns
``{'total_params', 'trainable_params'}``.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["summary"]


def _leaf_layers(model: nn.Module):
    for name, layer in model.named_modules():
        if name and not list(layer.children()):
            yield name, layer


def _n_params(layer: nn.Module):
    total = trainable = 0
    for p in layer.parameters():
        total += p.numel()
        if p.requires_grad:
            trainable += p.numel()
    return total, trainable


def _shapes(out):
    if isinstance(out, torch.Tensor):
        return str(list(out.shape))
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return ", ".join(s for s in (_shapes(o) for o in out) if s)
    return ""


def _dtype(dt) -> torch.dtype:
    return dt if isinstance(dt, torch.dtype) else getattr(torch, str(dt))


def summary(net: nn.Module, input_size=None, dtypes=None, input=None):
    """Print a per-layer table for one forward pass.

    ``input_size``: a tuple (or a list of tuples) with the batch dim, -1
    becoming 1; or pass a ready ``input`` tensor. Inputs are zeros on the
    device of the network's first parameter."""
    if input is None:
        if input_size is None:
            raise ValueError("summary() needs input_size or input")
        sizes = [input_size] if isinstance(input_size[0], int) else \
            list(input_size)
        if dtypes is None:
            dtypes_list = ["float32"] * len(sizes)
        elif isinstance(dtypes, (list, tuple)):
            dtypes_list = list(dtypes)
        else:
            dtypes_list = [dtypes] * len(sizes)
        first = next(net.parameters(), None)
        device = first.device if first is not None else None
        inputs = [torch.zeros([1 if d == -1 else d for d in size],
                              dtype=_dtype(dt), device=device)
                  for size, dt in zip(sizes, dtypes_list)]
    else:
        inputs = [input] if not isinstance(input, (list, tuple)) else \
            list(input)

    rows = []
    handles = []

    def hook(lyr, inp, out, name):
        total, _ = _n_params(lyr)
        rows.append((f"{type(lyr).__name__} ({name})", _shapes(out), total))

    was_training = net.training
    net.eval()
    for name, layer in _leaf_layers(net):
        handles.append(layer.register_forward_hook(
            lambda lyr, inp, out, name=name: hook(lyr, inp, out, name)))
    try:
        with torch.no_grad():
            net(*inputs)
    finally:
        for h in handles:
            h.remove()
        if was_training:
            net.train()

    total_params, trainable_params = _n_params(net)
    w_layer = max([len(r[0]) for r in rows] + [20]) + 2
    w_shape = max([len(r[1]) for r in rows] + [14]) + 2
    header = (f"{'Layer (type)':{w_layer}s}{'Output Shape':{w_shape}s}"
              f"{'Param #':>12s}")
    sep = "-" * len(header)
    lines = [sep, header, sep]
    for name, shape, n in rows:
        lines.append(f"{name:{w_layer}s}{shape:{w_shape}s}{n:>12,d}")
    lines += [sep,
              f"Total params: {total_params:,}",
              f"Trainable params: {trainable_params:,}",
              f"Non-trainable params: {total_params - trainable_params:,}",
              sep]
    print("\n".join(lines))
    return {"total_params": total_params,
            "trainable_params": trainable_params}
