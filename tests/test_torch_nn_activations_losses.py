"""Port parity: ``nn.functional``'s activations and losses against the JAX
package on the CPU.

Every activation (and the in-place aliases) on the same numpy input from
a seed, forward and the gradient of its sum; every loss on the same
inputs in each reduction it takes, and the gradients of the ones a model
trains through; ``ctc_loss`` on unnormalised logits (JAX's contract) with
ragged lengths; ``class_center_sample`` with a seed equal to JAX's draw.
The random draws (``rrelu`` in training, ``gumbel_softmax``) are held to
JAX's shape, dtype, range, determinism under the seed and moments, not to
its bits. float32 throughout: forward within 1e-5 + 1e-5·|ref| (1e-4 where
a loss sums exponentials), gradients within 1e-4 + 1e-4·|ref|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.nn.functional as TF
from _torch_threads import one_torch_thread  # noqa: F401


def _x(shape, seed=0, scale=3.0):
    return (np.random.default_rng(seed).standard_normal(shape) *
            scale).astype(np.float32)


def _close(got, want, tol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


ACTIVATIONS = [
    ("relu", {}), ("relu6", {}), ("gelu", {}), ("gelu", {"approximate": True}),
    ("silu", {}), ("swish", {}), ("sigmoid", {}), ("tanh", {}),
    ("leaky_relu", {}), ("leaky_relu", {"negative_slope": 0.2}),
    ("elu", {}), ("elu", {"alpha": 0.5}), ("selu", {}), ("celu", {}),
    ("celu", {"alpha": 2.0}), ("hardswish", {}), ("hardsigmoid", {}),
    ("hardsigmoid", {"slope": 0.2, "offset": 0.3}), ("hardshrink", {}),
    ("hardtanh", {}), ("hardtanh", {"min": -2.0, "max": 0.5}),
    ("softshrink", {}), ("softshrink", {"threshold": 1.0}), ("softsign", {}),
    ("tanhshrink", {}), ("thresholded_relu", {}), ("log_sigmoid", {}),
    ("mish", {}), ("softplus", {}), ("softplus", {"beta": 2.0,
                                                  "threshold": 3.0}),
    ("glu", {}), ("glu", {"axis": 1}), ("maxout", {"groups": 2}),
    ("softmax", {}), ("softmax", {"axis": 1}), ("log_softmax", {}),
    ("log_softmax", {"axis": 0}), ("rrelu", {"training": False}),
    ("elu_", {}), ("hardtanh_", {}), ("leaky_relu_", {}), ("relu_", {}),
    ("softmax_", {}), ("tanh_", {}), ("thresholded_relu_", {}),
]


def _act_id(case):
    name, kw = case
    return name + "".join(f"-{k}={v}" for k, v in kw.items())


@pytest.mark.parametrize("case", ACTIVATIONS, ids=map(_act_id, ACTIVATIONS))
def test_activation_forward(case):
    name, kw = case
    x = _x((3, 4, 6), seed=1)
    _close(getattr(TF, name)(torch.from_numpy(x), **kw),
           getattr(JF, name)(jnp.asarray(x), **kw))


SMOOTH = [c for c in ACTIVATIONS if c[0] in (
    "gelu", "silu", "sigmoid", "tanh", "elu", "selu", "celu", "softsign",
    "tanhshrink", "log_sigmoid", "mish", "softplus", "glu", "softmax",
    "log_softmax")]


@pytest.mark.parametrize("case", SMOOTH, ids=map(_act_id, SMOOTH))
def test_activation_grad(case):
    name, kw = case
    x = _x((3, 4, 6), seed=2, scale=1.5)
    w = _x((3, 4, 6) if name != "glu" else
           {(): (3, 4, 3), (("axis", 1),): (3, 2, 6)}[tuple(kw.items())],
           seed=3)
    want = jax.grad(lambda a: jnp.sum(getattr(JF, name)(a, **kw) *
                                      jnp.asarray(w)))(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    (getattr(TF, name)(t, **kw) * torch.from_numpy(w)).sum().backward()
    _close(t.grad, want, 1e-4)


def test_prelu_one_hot_label_smooth():
    x = _x((2, 3, 4, 5), seed=4)
    for w in (np.float32(0.25), np.array([0.1, 0.2, 0.3], np.float32)):
        _close(TF.prelu(torch.from_numpy(x), torch.as_tensor(w)),
               JF.prelu(jnp.asarray(x), jnp.asarray(w)))
    xl = np.moveaxis(x, 1, -1).copy()
    w = np.array([0.1, 0.2, 0.3], np.float32)
    _close(TF.prelu(torch.from_numpy(xl), torch.from_numpy(w), "NHWC"),
           JF.prelu(jnp.asarray(xl), jnp.asarray(w), "NHWC"))
    ids = np.array([[0, 3, 4], [2, -1, 5]], np.int32)   # -1, 5: zero rows
    got = TF.one_hot(torch.from_numpy(ids), 5)
    want = JF.one_hot(jnp.asarray(ids), 5)
    assert got.dtype == torch.float32
    _close(got, want, 0)
    lab = np.eye(4, dtype=np.float32)[[0, 2, 3]]
    _close(TF.label_smooth(torch.from_numpy(lab)),
           JF.label_smooth(jnp.asarray(lab)))
    prior = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    _close(TF.label_smooth(torch.from_numpy(lab), torch.from_numpy(prior),
                           epsilon=0.2),
           JF.label_smooth(jnp.asarray(lab), jnp.asarray(prior),
                           epsilon=0.2))


def test_jax_formulas_where_torch_defaults_differ():
    """``hardsigmoid``'s slope 1/6 and ``softplus``'s threshold on beta·x
    (JAX :110, :118-120), where torch's defaults would differ."""
    x = np.array([-4.0, -1.0, 0.5, 2.9, 3.1, 10.0], np.float32)
    _close(TF.hardsigmoid(torch.from_numpy(x)),
           np.clip(x / 6 + 0.5, 0, 1))
    # beta = 2, threshold 3: x itself where 2x > 3 (x = 2.9 here)
    got = TF.softplus(torch.from_numpy(x), beta=2.0, threshold=3.0)
    _close(got, JF.softplus(jnp.asarray(x), beta=2.0, threshold=3.0))
    assert float(got[3]) == pytest.approx(2.9)


def test_rrelu_and_gumbel_softmax_draws():
    """Held to shape, dtype, range, determinism under the seed and the
    moments of JAX's draw, not its bits."""
    x = -np.abs(_x((64, 64), seed=5)) - 0.1          # all negative
    slopes = {}
    for side, mod, fn in (("port", tpaddle, TF.rrelu),
                          ("jax", jpaddle, JF.rrelu)):
        arr = torch.from_numpy(x) if side == "port" else jnp.asarray(x)
        mod.seed(11)
        a = np.asarray(fn(arr, 0.1, 0.3, training=True))
        mod.seed(11)
        b = np.asarray(fn(arr, 0.1, 0.3, training=True))
        np.testing.assert_array_equal(a, b)
        s = a / x
        assert s.min() >= 0.1 - 1e-6 and s.max() <= 0.3 + 1e-6
        slopes[side] = s
    mod_std = (0.2 / np.sqrt(12))
    for s in slopes.values():
        assert abs(s.mean() - 0.2) < 4 * mod_std / 64
        assert abs(s.std() - mod_std) < 0.05 * mod_std
    tpaddle.seed(3)
    t = TF.rrelu(torch.from_numpy(x), 0.1, 0.3, training=True)
    assert t.dtype == torch.float32 and t.shape == (64, 64)
    assert not np.array_equal(t.numpy(), slopes["port"] * x)

    logits = _x((4096, 5), seed=6, scale=1.0)
    for hard in (False, True):
        tpaddle.seed(7)
        y = TF.gumbel_softmax(torch.from_numpy(logits), 0.5, hard=hard)
        tpaddle.seed(7)
        y2 = TF.gumbel_softmax(torch.from_numpy(logits), 0.5, hard=hard)
        np.testing.assert_array_equal(y.numpy(), y2.numpy())
        jpaddle.seed(7)
        jy = np.asarray(JF.gumbel_softmax(jnp.asarray(logits), 0.5,
                                          hard=hard))
        assert y.shape == jy.shape and y.dtype == torch.float32
        np.testing.assert_allclose(y.sum(-1).numpy(), 1.0, atol=1e-5)
        # both sample the argmax of the logits plus Gumbel noise: the
        # class frequencies agree with each other and the softmax
        p = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        freq_t = np.bincount(y.numpy().argmax(-1), minlength=5) / 4096
        freq_j = np.bincount(jy.argmax(-1), minlength=5) / 4096
        assert np.abs(freq_t - p.mean(0)).max() < 0.03
        assert np.abs(freq_t - freq_j).max() < 0.04
        if hard:
            assert set(np.unique(y.numpy())) <= {0.0, 1.0}
    # straight-through: the hard sample's gradient is the soft one's
    t = torch.from_numpy(logits[:8]).requires_grad_()
    tpaddle.seed(1)
    (TF.gumbel_softmax(t, hard=True) * torch.arange(5.0)).sum().backward()
    assert torch.isfinite(t.grad).all() and t.grad.abs().sum() > 0


# -- losses ----------------------------------------------------------------

def _probs(shape, seed):
    return (1 / (1 + np.exp(-_x(shape, seed, 1.0)))).astype(np.float32)


def _signs(shape, seed):
    return np.where(np.random.default_rng(seed).random(shape) < 0.5, -1.0,
                    1.0).astype(np.float32)


def _labels(n, c, seed, shape=None):
    return np.random.default_rng(seed).integers(
        0, c, shape or (n,)).astype(np.int32)


LOSSES = {
    "mse_loss": lambda: ((_x((4, 5), 10), _x((4, 5), 11)), {}),
    "l1_loss": lambda: ((_x((4, 5), 10), _x((4, 5), 11)), {}),
    "smooth_l1_loss": lambda: ((_x((4, 5), 10), _x((4, 5), 11, 1.0)),
                               {"delta": 0.5}),
    "kl_div": lambda: ((np.log(_probs((4, 5), 12)), _probs((4, 5), 13)),
                       {}),
    "binary_cross_entropy": lambda: ((_probs((4, 5), 14),
                                      _probs((4, 5), 15)), {}),
    "binary_cross_entropy_with_logits": lambda: (
        (_x((4, 5), 16), _probs((4, 5), 17)), {}),
    "margin_ranking_loss": lambda: ((_x((6,), 18), _x((6,), 19),
                                     _signs((6,), 20)), {"margin": 0.3}),
    "soft_margin_loss": lambda: ((_x((4, 5), 21, 1.0), _signs((4, 5), 22)),
                                 {}),
    "triplet_margin_loss": lambda: ((_x((4, 6), 23), _x((4, 6), 24),
                                     _x((4, 6), 25)), {}),
    "cosine_embedding_loss": lambda: ((_x((5, 6), 26), _x((5, 6), 27),
                                       _signs((5,), 28)), {"margin": 0.1}),
    "hinge_embedding_loss": lambda: ((_x((4, 5), 29), _signs((4, 5), 30)),
                                     {}),
    "poisson_nll_loss": lambda: ((_x((4, 5), 31, 0.5),
                                  np.abs(_x((4, 5), 32, 2.0))), {}),
    "multi_label_soft_margin_loss": lambda: (
        (_x((4, 5), 33), (_probs((4, 5), 34) > 0.5).astype(np.float32)),
        {}),
}


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss(name, reduction):
    arrays, kw = LOSSES[name]()
    kw = dict(kw, reduction=reduction)
    _close(getattr(TF, name)(*map(torch.from_numpy, arrays), **kw),
           getattr(JF, name)(*map(jnp.asarray, arrays), **kw), 1e-4)


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_grad(name):
    arrays, kw = LOSSES[name]()
    want = jax.grad(lambda a: getattr(JF, name)(
        a, *map(jnp.asarray, arrays[1:]), **kw))(jnp.asarray(arrays[0]))
    t = torch.from_numpy(arrays[0]).requires_grad_()
    getattr(TF, name)(t, *map(torch.from_numpy, arrays[1:]),
                      **kw).backward()
    _close(t.grad, want, 1e-4)


def test_loss_options():
    """Each loss's other arguments: weights, ``pos_weight``, ``swap``,
    ``p``, ``full``, ``log_input=False``, ``batchmean``, ``log_loss``,
    ``square_error_cost``."""
    a, b = _x((4, 5), 40), _probs((4, 5), 41)
    w = _probs((4, 5), 42)
    pw = np.abs(_x((5,), 43, 1.0))
    cases = [
        ("binary_cross_entropy_with_logits", (a, b),
         dict(weight=w, pos_weight=pw)),
        ("binary_cross_entropy", (_probs((4, 5), 44), b), dict(weight=w)),
        ("multi_label_soft_margin_loss", (a, (b > 0.5).astype(np.float32)),
         dict(weight=w)),
        ("triplet_margin_loss", (_x((4, 6), 45), _x((4, 6), 46),
                                 _x((4, 6), 47)), dict(swap=True, p=1.0,
                                                       margin=2.0)),
        ("poisson_nll_loss", (np.abs(_x((4, 5), 48)) + 0.1,
                              np.abs(_x((4, 5), 49, 2.0))),
         dict(log_input=False, full=True)),
        ("poisson_nll_loss", (_x((4, 5), 48, 0.5),
                              np.abs(_x((4, 5), 49, 2.0))),
         dict(full=True)),
        ("kl_div", (np.log(_probs((4, 5), 50)),
                    np.concatenate([_probs((4, 4), 51),
                                    np.zeros((4, 1), np.float32)], 1)),
         dict(reduction="batchmean")),
        ("log_loss", (_probs((4, 1), 52), (_probs((4, 1), 53) > 0.5).astype(
            np.float32)), dict(epsilon=1e-3)),
        ("square_error_cost", (a, _x((4, 5), 54)), {}),
    ]
    for name, arrays, kw in cases:
        tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        _close(getattr(TF, name)(*map(torch.from_numpy, arrays), **tkw),
               getattr(JF, name)(*map(jnp.asarray, arrays), **jkw), 1e-4)


def test_smooth_l1_and_kl_div_formulas():
    """``0.5·d²/delta`` and ``d − 0.5·delta`` (JAX :671-673); ``kl_div``'s
    log clipped at 1e-12, so a zero label gives 0 and not NaN (:679)."""
    d = np.array([0.2, 0.49, 0.51, 3.0], np.float32)
    got = TF.smooth_l1_loss(torch.from_numpy(d), torch.zeros(4),
                            reduction="none", delta=0.5)
    _close(got, np.where(d < 0.5, 0.5 * d * d / 0.5, d - 0.25))
    got = TF.kl_div(torch.zeros(3), torch.tensor([0.0, 0.5, 1.0]),
                    reduction="none")
    _close(got, np.array([0.0, 0.5 * np.log(0.5), 0.0], np.float32))


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("weighted", [False, True])
def test_nll_loss(reduction, weighted):
    logp = np.log(_probs((6, 5), 60))
    lab = _labels(6, 5, 61)
    lab[2] = -100
    w = np.abs(_x((5,), 62, 1.0)) if weighted else None
    kw = dict(reduction=reduction)
    got = TF.nll_loss(torch.from_numpy(logp), torch.from_numpy(lab),
                      None if w is None else torch.from_numpy(w), **kw)
    want = JF.nll_loss(jnp.asarray(logp), jnp.asarray(lab),
                       None if w is None else jnp.asarray(w), **kw)
    _close(got, want)


@pytest.mark.parametrize("return_softmax", [False, True])
@pytest.mark.parametrize("soft", [False, True])
def test_softmax_with_cross_entropy(soft, return_softmax):
    logits = _x((4, 6), 63, 1.0)
    lab = _probs((4, 6), 64) if soft else _labels(4, 6, 65, (4, 1))
    if soft:
        lab = lab / lab.sum(-1, keepdims=True)
    got = TF.softmax_with_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(lab), soft_label=soft,
        return_softmax=return_softmax)
    want = JF.softmax_with_cross_entropy(
        jnp.asarray(logits), jnp.asarray(lab), soft_label=soft,
        return_softmax=return_softmax)
    if return_softmax:
        _close(got[1], want[1])
        got, want = got[0], want[0]
    _close(got, want)


def test_dice_npair_margin_cross_entropy():
    probs = _probs((4, 3, 5), 70)
    probs = probs / probs.sum(-1, keepdims=True)
    lab = _labels(4, 5, 71, (4, 3, 1))
    _close(TF.dice_loss(torch.from_numpy(probs), torch.from_numpy(lab)),
           JF.dice_loss(jnp.asarray(probs), jnp.asarray(lab)))
    anc, pos = _x((6, 4), 72, 1.0), _x((6, 4), 73, 1.0)
    ids = np.array([0, 1, 0, 2, 1, 3], np.int32)
    _close(TF.npair_loss(torch.from_numpy(anc), torch.from_numpy(pos),
                         torch.from_numpy(ids)),
           JF.npair_loss(jnp.asarray(anc), jnp.asarray(pos),
                         jnp.asarray(ids)), 1e-4)
    cos = np.tanh(_x((4, 6), 74, 1.0))
    lab = _labels(4, 6, 75)
    for kw in ({}, {"margin1": 1.0, "margin2": 0.0, "margin3": 0.35,
                    "scale": 30.0, "reduction": "none"}):
        got = TF.margin_cross_entropy(torch.from_numpy(cos),
                                      torch.from_numpy(lab),
                                      return_softmax=True, **kw)
        want = JF.margin_cross_entropy(jnp.asarray(cos), jnp.asarray(lab),
                                       return_softmax=True, **kw)
        _close(got[0], want[0], 1e-4)
        _close(got[1], want[1], 1e-5)


def test_class_center_sample():
    """With a seed the draw is JAX's, index for index (both
    ``numpy.default_rng(seed)``); without one it follows the port's seed."""
    lab = np.array([3, 7, 3, 12, 0, 7], np.int32)
    got = TF.class_center_sample(torch.from_numpy(lab), 20, 8, seed=5)
    want = JF.class_center_sample(jnp.asarray(lab), 20, 8, seed=5)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    tpaddle.seed(1)
    a = TF.class_center_sample(torch.from_numpy(lab), 20, 8)
    tpaddle.seed(1)
    b = TF.class_center_sample(torch.from_numpy(lab), 20, 8)
    np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())
    assert len(a[1]) == 8 and set(lab) <= set(a[1].tolist())
    remapped = a[0].numpy()
    np.testing.assert_array_equal(a[1].numpy()[remapped], lab)


def _ctc_inputs(t=12, b=3, c=5, n_lab=4, seed=80):
    logits = _x((t, b, c), seed, 1.0)
    labels = np.random.default_rng(seed + 1).integers(
        1, c, (b, n_lab)).astype(np.int32)
    labels[0, 1] = labels[0, 0]             # a repeat needs a blank between
    in_len = np.array([t, t - 3, t - 1], np.int32)[:b]
    lab_len = np.array([n_lab, 2, 0], np.int32)[:b]
    return logits, labels, in_len, lab_len


@pytest.mark.parametrize("norm_by_times", [False, True])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_ctc_loss(reduction, norm_by_times):
    """Unnormalised logits, JAX's contract (``log_softmax`` applied
    first); ragged input and label lengths, a repeated label, an empty
    label."""
    arrays = _ctc_inputs()
    kw = dict(blank=0, reduction=reduction, norm_by_times=norm_by_times)
    got = TF.ctc_loss(*map(torch.from_numpy, arrays), **kw)
    want = JF.ctc_loss(*map(jnp.asarray, arrays), **kw)
    _close(got, want, 1e-4)


def test_ctc_loss_grad_and_layer():
    logits, labels, in_len, lab_len = _ctc_inputs(seed=90)
    want = jax.grad(lambda a: JF.ctc_loss(a, jnp.asarray(labels),
                                          jnp.asarray(in_len),
                                          jnp.asarray(lab_len)))(
        jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_()
    from paddle_tpu_torch import nn as tnn
    tnn.CTCLoss()(t, torch.from_numpy(labels), torch.from_numpy(in_len),
                  torch.from_numpy(lab_len)).backward()
    _close(t.grad, want, 1e-4)
    # against torch's own CTC on the log-softmax (its "mean" divides by the
    # label lengths, so compare per sequence)
    ref = torch.nn.functional.ctc_loss(
        torch.log_softmax(torch.from_numpy(logits), -1),
        torch.from_numpy(labels).long(), torch.from_numpy(in_len).long(),
        torch.from_numpy(lab_len).long(), reduction="none")
    got = TF.ctc_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                      torch.from_numpy(in_len), torch.from_numpy(lab_len),
                      reduction="none")
    _close(got, ref.numpy(), 1e-4)
