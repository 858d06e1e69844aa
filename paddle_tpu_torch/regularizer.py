"""Weight-decay regularizers (``paddle_tpu/regularizer.py`` counterpart).

Coefficient holders that the optimizers read, as in the JAX package:
``L2Decay`` becomes the optimizer's coupled ``weight_decay``, ``L1Decay``
adds ``coeff * sign(param)`` to the float32 gradient before the update.
Called on their own, they add the term to a gradient.
"""

from __future__ import annotations

import torch

__all__ = ["L1Decay", "L2Decay"]


class _Regularizer:
    def __init__(self, coeff: float = 0.0):
        self.coeff = float(coeff)

    def __repr__(self):
        return f"{type(self).__name__}(coeff={self.coeff})"


class L1Decay(_Regularizer):
    """Lasso penalty: adds ``coeff * sign(param)`` to the gradient."""

    def __call__(self, grad, param):
        return grad + self.coeff * torch.sign(param)


class L2Decay(_Regularizer):
    """Ridge penalty: adds ``coeff * param`` to the gradient (coupled
    decay; AdamW's ``weight_decay`` is the decoupled one)."""

    def __call__(self, grad, param):
        return grad + self.coeff * param
