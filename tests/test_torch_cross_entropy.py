"""Port parity: ``cross_entropy`` and ``CrossEntropyLoss`` with soft
labels, class weights, label smoothing, ``ignore_index`` and the three
reductions, against ``paddle_tpu.nn.functional.cross_entropy``: the loss,
and the gradient of its sum with respect to the logits (``jax.grad``
against ``backward``). Float32 on both sides; the class sums run in XLA's
and torch's orders: rtol 1e-5, atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as TF

N, C = 12, 7
TOL = dict(rtol=1e-5, atol=1e-6)


def _data(seed=0, axis=-1):
    rng = np.random.default_rng(seed)
    shape = (N, C) if axis == -1 else (3, C, 4)
    logits = (rng.standard_normal(shape) * 3).astype(np.float32)
    lab_shape = (N,) if axis == -1 else (3, 4)
    labels = rng.integers(0, C, lab_shape).astype(np.int64)
    labels.reshape(-1)[[1, 5]] = -100       # two ignored
    soft = rng.random(shape).astype(np.float32)
    soft /= soft.sum(axis=axis, keepdims=True)
    weight = (rng.random(C) + 0.5).astype(np.float32)
    return logits, labels, soft, weight


CASES = {
    # name: (soft_label, weight, label_smoothing, ignore)
    "hard": (False, False, 0.0, True),
    "hard_smoothed": (False, False, 0.1, True),
    "weighted": (False, True, 0.0, False),
    "weighted_ignored": (False, True, 0.0, True),
    "weighted_smoothed": (False, True, 0.2, False),
    "soft": (True, False, 0.0, False),
    "soft_smoothed": (True, False, 0.1, False),
}


def _args(case, labels, soft, weight):
    soft_label, use_w, ls, ignore = CASES[case]
    lab = soft if soft_label else (
        labels if ignore else np.where(labels < 0, 0, labels))
    return lab, (weight if use_w else None), soft_label, ls


# JAX's hard labels take the class axis last only (its one-hot is put last
# and meets logp on ``axis``): axis 1 is compared with soft labels
AXIS_CASES = [(c, -1) for c in CASES] + [("soft", 1), ("soft_smoothed", 1)]


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("case,axis", AXIS_CASES)
def test_cross_entropy_matches_jax(case, axis, reduction):
    logits, labels, soft, weight = _data(axis=axis)
    lab, w, soft_label, ls = _args(case, labels, soft, weight)
    kw = dict(reduction=reduction, soft_label=soft_label, axis=axis,
              label_smoothing=ls)

    def jloss(x):
        return JF.cross_entropy(x, jnp.asarray(lab), weight=None if w is None
                                else jnp.asarray(w), **kw)

    want = np.asarray(jloss(jnp.asarray(logits)))
    x = torch.from_numpy(logits).requires_grad_()
    got = TF.cross_entropy(x, torch.from_numpy(lab), weight=None if w is None
                           else torch.from_numpy(w), **kw)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    got.sum().backward()
    jgrad = np.asarray(jax.grad(lambda x: jloss(x).sum())(
        jnp.asarray(logits)))
    if case == "weighted_ignored":
        # JAX takes the weight of an ignored label (-100) out of bounds
        # (NaN), which its where() hides from the loss but not from the
        # gradient of the ignored rows; the port indexes a safe class there
        # and gives those rows a zero gradient
        ignored = np.broadcast_to((labels == -100)[:, None], logits.shape)
        assert np.all(x.grad.numpy()[ignored] == 0)
        np.testing.assert_allclose(x.grad.numpy()[~ignored],
                                   jgrad[~ignored], **TOL)
        return
    np.testing.assert_allclose(x.grad.numpy(), jgrad, **TOL)


def test_hard_labels_on_axis_1():
    """The port's hard labels on a class axis other than the last: the
    same losses as with the classes moved last."""
    logits, labels, _, weight = _data(axis=1)
    x = torch.from_numpy(logits)
    lab = torch.from_numpy(labels)
    for kw in ({}, {"label_smoothing": 0.1}, {"weight": weight}):
        got = TF.cross_entropy(x, lab, axis=1, reduction="none", **kw)
        want = TF.cross_entropy(x.movedim(1, -1), lab, reduction="none",
                                **kw)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=0)


def test_label_with_trailing_one_and_all_ignored():
    """``[N, 1]`` labels squeeze as in JAX; a batch whose every label is
    ignored gives a mean of 0 (the count is clamped to 1)."""
    logits, labels, _, _ = _data()
    lab = np.where(labels < 0, 0, labels)[:, None]
    want = np.asarray(JF.cross_entropy(jnp.asarray(logits), jnp.asarray(lab)))
    got = TF.cross_entropy(torch.from_numpy(logits), torch.from_numpy(lab))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    none = torch.full((N,), -100)
    assert float(TF.cross_entropy(torch.from_numpy(logits), none)) == 0.0
    with pytest.raises(ValueError):
        TF.cross_entropy(torch.from_numpy(logits), torch.zeros(N, C),
                         weight=torch.ones(C), soft_label=True)


@pytest.mark.parametrize("case", ["hard", "weighted_smoothed", "soft"])
def test_cross_entropy_loss_layer_matches_jax(case):
    logits, labels, soft, weight = _data(seed=1)
    lab, w, soft_label, ls = _args(case, labels, soft, weight)
    jl = jnn.CrossEntropyLoss(weight=None if w is None else jnp.asarray(w),
                              soft_label=soft_label, label_smoothing=ls)
    tl = tnn.CrossEntropyLoss(weight=w, soft_label=soft_label,
                              label_smoothing=ls)
    want = np.asarray(jl(jnp.asarray(logits), jnp.asarray(lab)))
    got = tl(torch.from_numpy(logits), torch.from_numpy(lab))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
