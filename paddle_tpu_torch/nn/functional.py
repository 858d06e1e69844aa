"""Functional ops of the port (``paddle_tpu/nn/functional.py`` counterpart).

So far the loss the GPT training path needs: :func:`cross_entropy` with
hard labels.
"""

from __future__ import annotations

import torch

__all__ = ["cross_entropy"]


def cross_entropy(input: torch.Tensor, label: torch.Tensor, weight=None,
                  ignore_index: int = -100, reduction: str = "mean",
                  soft_label: bool = False, axis: int = -1,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Softmax cross-entropy over ``axis`` with hard integer labels, as
    ``paddle_tpu.nn.functional.cross_entropy`` computes it: log-softmax in
    float32, the label's log-probability picked by a gather (the JAX code
    takes it through a one-hot), 0 where the label is ``ignore_index``.
    ``reduction`` is ``"none"``, ``"sum"`` or ``"mean"``; the mean divides
    by the number of labels that are not ignored (at least 1).

    ``soft_label``, ``weight`` and ``label_smoothing`` are not ported yet
    and raise."""
    if soft_label or weight is not None or label_smoothing:
        raise NotImplementedError(
            "cross_entropy: soft_label, weight and label_smoothing are not "
            "ported yet (hard labels only)")
    if reduction not in ("none", "sum", "mean"):
        raise ValueError(f"reduction must be 'none', 'sum' or 'mean'; got "
                         f"{reduction!r}")
    logp = torch.log_softmax(input.float(), dim=axis).movedim(axis, -1)
    if label.dim() == input.dim() and label.shape[-1] == 1:
        label = label.squeeze(-1)
    label = label.long()
    valid = label != ignore_index
    picked = torch.gather(logp, -1, torch.where(valid, label, 0)[..., None])
    loss = torch.where(valid, -picked[..., 0], 0.0)
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    return loss.sum() / torch.clamp(valid.sum(), min=1)
