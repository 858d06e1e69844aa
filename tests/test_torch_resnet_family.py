"""Port parity: the rest of the ResNet family and the layers around it.

- ResNeXt (grouped 3x3) and Wide ResNet bottlenecks against JAX's, forward
  and gradients, on both fused routes: the kernel route (both conv flags
  on; JAX's Pallas kernels in interpret mode against K5-K8's plain
  versions, the grouped 3x3 on the library conv in both packages, as
  ``supports`` sends it) and the library route (``fused_conv_bn=1``,
  ``pallas_conv=0``);
- the eight ResNeXt and wide factories: the arguments each hands the
  ``ResNet`` constructor, and ``resnext50_32x4d()`` and
  ``wide_resnet50_2()`` built whole with JAX's state_dict names and shapes,
  each converted and run once on a small input against JAX;
- ``max_pool2d_with_index`` (ties, windows of padding only, padding past
  half the kernel), ``avg_pool2d`` exclusive and inclusive, ``pad`` in its
  four modes in both layouts, ``padding="SAME"`` with stride 2 at odd and
  even sizes, ``AvgPool2D``, ``Flatten``, ``Pad2D``, ``BatchNorm1D``,
  ``BatchNorm3D`` and the legacy ``BatchNorm``, and ``Conv2D``'s
  ``padding_mode``.

Inputs are made with numpy from a seed and handed to both sides; weights
go from JAX to the port through ``convert.from_jax_state_dict`` (the full
models the other way, ``to_jax_state_dict``). The JAX sides are jitted.
Each comparison states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.core import flags as jflags
from paddle_tpu.framework.functional import (functional_call, get_buffers,
                                             get_params)
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn import fused_conv_bn  # noqa: F401  (defines the flag)
from paddle_tpu.ops._pallas import conv  # noqa: F401  (defines pallas_conv)
from paddle_tpu.vision.models import resnet as jresnet
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import (from_jax_state_dict,
                                      to_jax_state_dict)
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops._hopper import conv as hc
from paddle_tpu_torch.vision.models import resnet as tresnet
from _torch_threads import one_torch_thread  # noqa: F401

FACTORIES = ("resnext50_32x4d", "resnext50_64x4d", "resnext101_32x4d",
             "resnext101_64x4d", "resnext152_32x4d", "resnext152_64x4d",
             "wide_resnet50_2", "wide_resnet101_2")


class flags_set:
    """Both conv flags of one package set for a block, then restored."""

    def __init__(self, module, fused, pallas):
        self.module, self.want = module, {"fused_conv_bn": fused,
                                          "pallas_conv": pallas}

    def __enter__(self):
        self.prev = self.module.get_flags(list(self.want))
        self.module.set_flags(self.want)

    def __exit__(self, *exc):
        self.module.set_flags(self.prev)


def _carry(jlayer, tlayer):
    tlayer.load_state_dict(from_jax_state_dict(
        {k: np.asarray(v) for k, v in jlayer.state_dict().items()}),
        strict=True)
    return tlayer


def _torch_grad(name, p):
    g = p.grad.detach().float().numpy()
    return g.T if name.endswith("fc.weight") else g


# -- grouped and wide bottlenecks on both fused routes -----------------------

#: (planes, groups, base_width): conv2 is ``width = planes·base_width/64 ·
#: groups`` channels wide; ResNeXt's 32x4d at a sixteenth of its channels,
#: Wide ResNet's doubled width at planes 4
BLOCKS = {"resnext": (16, 4, 8), "wide": (4, 1, 128)}


def _blocks(kind, stride):
    planes, groups, base = BLOCKS[kind]
    paddle.seed(0)
    inplanes = planes * 4
    jds = tds = None
    if stride != 1:
        jds = jnn.Sequential(
            jnn.Conv2D(inplanes, planes * 4, 1, stride=stride,
                       bias_attr=False, data_format="NHWC"),
            jnn.BatchNorm2D(planes * 4, data_format="NHWC"))
        tds = tnn.Sequential(
            tnn.Conv2D(inplanes, planes * 4, 1, stride=stride,
                       bias_attr=False, data_format="NHWC", device="cpu"),
            tnn.BatchNorm2D(planes * 4, data_format="NHWC", device="cpu"))
    jb = jresnet.BottleneckBlock(inplanes, planes, stride=stride,
                                 downsample=jds, groups=groups,
                                 base_width=base, data_format="NHWC")
    tb = tresnet.BottleneckBlock(inplanes, planes, stride=stride,
                                 downsample=tds, groups=groups,
                                 base_width=base, data_format="NHWC",
                                 device="cpu")
    return jb, _carry(jb, tb), inplanes


@pytest.mark.parametrize("pallas", [1, 0], ids=["kernels", "library"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kind", ["resnext", "wide"])
def test_bottleneck_matches_jax_on_both_routes(kind, stride, pallas):
    """One training forward and backward of a grouped (ResNeXt) or wide
    bottleneck (8x8, batch 2, f32, loss sum(out²)) with
    ``fused_conv_bn=1`` in both packages and ``pallas_conv`` on (JAX's
    kernels in interpret mode against the plain versions of K5-K8) or off
    (the library conv in both). On the kernel route every 1x1 conv takes
    the kernels and the grouped 3x3 the library conv (counted), the wide
    3x3 the kernels. Outputs and new buffers within 1e-5 of their scale;
    gradients within 1e-4 of each tensor's largest (BN's closed form
    divides by the batch's std over 128 values); the grouped 3x3's weight
    gradient is the library's grouped ``conv2d_weight``."""
    jb, tb, cin = _blocks(kind, stride)
    x = np.random.default_rng(19).standard_normal((2, 8, 8, cin)).astype(
        np.float32)
    with flags_set(jflags, 1, pallas):
        params, buffers = get_params(jb), get_buffers(jb)

        def loss_fn(p, xx):
            out, nb = functional_call(jb, p, xx, buffers=buffers,
                                      mutable=True, training=True)
            return jnp.sum(out * out), (out, nb)

        (_, (jout, jbuf)), (jgrads, jdx) = jax.jit(jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    calls = {"fwd": 0, "dgrad": 0, "wgrad": 0}
    real = {name: getattr(hc, f"conv2d_{name}") for name in calls}

    def spy(name):
        def counted(*a, **k):
            calls[name] += 1
            return real[name](*a, **k)
        return counted

    tb.train()
    with flags_set(tflags, 1, pallas), pytest.MonkeyPatch.context() as mp:
        for name in calls:
            mp.setattr(hc, f"conv2d_{name}", spy(name))
        tx = torch.from_numpy(x).requires_grad_()
        out = tb(tx)
        (out * out).sum().backward()
    n_kernel = (4 if stride != 1 else 3) - (kind == "resnext")
    assert calls == {k: n_kernel * pallas for k in calls}
    scale = float(np.abs(np.asarray(jout)).max())
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5 * scale)
    want = np.asarray(jdx)
    np.testing.assert_allclose(tx.grad.numpy(), want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))
    for name, p in tb.named_parameters():
        want = np.asarray(jgrads[name])
        np.testing.assert_allclose(_torch_grad(name, p), want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()),
                                   err_msg=name)
    for name, buf in tb.named_buffers():
        np.testing.assert_allclose(buf.numpy(), np.asarray(jbuf[name]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_grouped_unit_gradients_match_autograd():
    """``_conv_grads`` on a grouped 3x3 (the units' library route): the
    input and weight gradients equal torch autograd's through the same
    grouped conv, f64, stride 1 and 2."""
    from paddle_tpu_torch.nn.fused_conv_bn import _conv_grads
    rng = np.random.default_rng(4)
    for s in (1, 2):
        a = torch.from_numpy(rng.standard_normal((2, 7, 6, 8))
                             ).requires_grad_()
        w = torch.from_numpy(rng.standard_normal((12, 2, 3, 3))
                             ).requires_grad_()
        o = TF.conv2d(a, w, None, s, 1, 1, 4, "NHWC")
        do = torch.from_numpy(rng.standard_normal(tuple(o.shape)))
        o.backward(do)
        da, dw = _conv_grads(do, a.detach(), w.detach(), (s, s), (1, 1),
                             (1, 1), 4)
        torch.testing.assert_close(da, a.grad, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(dw, w.grad, rtol=1e-12, atol=1e-12)


# -- the factories -----------------------------------------------------------

def _captured(module, name, monkeypatch):
    seen = {}

    def fake(block, depth, **kw):
        seen.update(block=block.__name__, depth=depth, **kw)

    monkeypatch.setattr(module, "_resnet", fake)
    getattr(module, name)(num_classes=7)
    return seen


@pytest.mark.parametrize("name", FACTORIES)
def test_factory_arguments_match_jax(name, monkeypatch):
    """Each of the eight factories hands ``ResNet`` the block, depth,
    groups and width JAX's does (and passes keywords through)."""
    want = _captured(jresnet, name, monkeypatch)
    assert _captured(tresnet, name, monkeypatch) == want
    assert want["num_classes"] == 7


@pytest.fixture(scope="module")
def full_models():
    """``resnext50_32x4d()`` and ``wide_resnet50_2()`` at full width with
    10 classes: JAX's built under ``jax.eval_shape`` (its names and shapes
    without drawing 94M weights eagerly, which takes JAX 23 s here; the
    global key state is restored after) and the port's with its own
    seeded weights."""
    from paddle_tpu.core import random as jrandom
    out = {}
    for name in ("resnext50_32x4d", "wide_resnet50_2"):
        box = {}

        def build():
            box["m"] = getattr(jresnet, name)(num_classes=10)
            return dict(box["m"].state_dict())

        key_state = jrandom.get_rng_state()
        try:
            abstract = jax.eval_shape(build)
        finally:
            jrandom.set_rng_state(key_state)
        tm = getattr(tresnet, name)(num_classes=10, device="cpu", seed=3)
        out[name] = (box["m"].eval(), tm.eval(),
                     {k: tuple(v.shape) for k, v in abstract.items()})
    return out


@pytest.mark.parametrize("name", ["resnext50_32x4d", "wide_resnet50_2"])
def test_factory_state_dict_matches_jax(full_models, name):
    """Every state_dict key of the full model, BN buffers included, with
    JAX's shape (the ``fc`` weight transposed, ``[out, in]``), and the
    3x3 convs grouped (ResNeXt) or doubled (wide) as in JAX."""
    _, tm, jshapes = full_models[name]
    shapes = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert set(shapes) == set(jshapes)
    for k, shape in shapes.items():
        want = jshapes[k][::-1] if k == "fc.weight" else jshapes[k]
        assert shape == want, k
    width, groups = {"resnext50_32x4d": (128, 32),
                     "wide_resnet50_2": (128, 1)}[name]
    assert shapes["layer1.0.conv2.weight"] == (width, width // groups, 3, 3)
    assert tm.layer1[0].conv2.groups == groups


@pytest.mark.parametrize("name", ["resnext50_32x4d", "wide_resnet50_2"])
def test_factory_forward_matches_jax(full_models, name):
    """The port's weights converted to JAX's layout
    (``convert.to_jax_state_dict``) and one eval forward of both full
    models on a 2 x 3 x 32 x 32 NCHW batch, JAX's jitted: logits within
    1e-4 of their scale (f32, 53 convs summed in other orders)."""
    jm, tm, _ = full_models[name]
    sd = to_jax_state_dict(tm.state_dict())
    pnames = set(get_params(jm))
    params = {k: jnp.asarray(v) for k, v in sd.items() if k in pnames}
    buffers = {k: jnp.asarray(v) for k, v in sd.items() if k not in pnames}
    assert set(buffers) == set(get_buffers(jm))
    x = np.random.default_rng(5).standard_normal((2, 3, 32, 32)).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda p, xx: functional_call(
        jm, p, xx, buffers=buffers, training=False))(params,
                                                       jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))


# -- pooling, padding, SAME with a stride -------------------------------------

def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("k,s,p", [(3, 2, 1), (3, 1, 2), (3, 2, 3),
                                   (2, 1, 1)])
def test_max_pool2d_with_index_matches_jax(k, s, p):
    """Pooled values and flat ``h·w`` argmax indices equal JAX's bit for
    bit, with ties (a 4x4 block of zeros, as ReLU gives, and a row of equal
    values), windows of padding only (padding 3 at kernel 3) and padding
    past half the kernel (2 and 3 at kernel 3), which torch's pool
    refuses; ``max_pool2d(return_mask=True)`` is the same function."""
    x = _x((2, 3, 9, 8))
    x[0, 0, :4, :4] = 0.0
    x[1, 2, 3, :] = 1.25
    jp, jm = jax.jit(JF.max_pool2d_with_index, static_argnums=(1, 2, 3))(
        jnp.asarray(x), k, s, p)
    tp, tm = TF.max_pool2d_with_index(torch.from_numpy(x), k, s, p)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    tp2, tm2 = TF.max_pool2d(torch.from_numpy(x), k, s, p, return_mask=True)
    assert torch.equal(tp2, tp) and torch.equal(tm2, tm)
    np.testing.assert_array_equal(
        TF.max_pool2d(torch.from_numpy(x), k, s, p).numpy(),
        np.asarray(JF.max_pool2d(jnp.asarray(x), k, s, p)))


def test_max_pool2d_mask_ties_take_the_first_window_position():
    """In an all-zero window every index ties: the mask names the window's
    top-left element (row-major first), as ``jnp.argmax`` does."""
    x = torch.zeros(1, 1, 4, 4)
    _, mask = TF.max_pool2d_with_index(x, 2, 2, 0)
    assert mask.tolist() == [[[[0, 2], [8, 10]]]]
    with pytest.raises(ValueError, match="NCHW"):
        TF.max_pool2d(x, 2, 2, 0, return_mask=True, data_format="NHWC")


@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
@pytest.mark.parametrize("k,s,p", [(3, 2, 1), (2, 2, 0), (3, 1, 2),
                                   (3, 2, 3)])
def test_avg_pool2d_and_layer_match_jax(k, s, p, data_format):
    """Exclusive (divide by the real elements; a window of padding only
    gives NaN in both) and inclusive averages within 1e-6, through the
    function and ``AvgPool2D``."""
    x = _x((2, 3, 9, 8) if data_format == "NCHW" else (2, 9, 8, 3), 1)
    for exclusive in (True, False):
        want = np.asarray(JF.avg_pool2d(jnp.asarray(x), k, s, p,
                                        data_format, exclusive))
        got = TF.avg_pool2d(torch.from_numpy(x), k, s, p, data_format,
                            exclusive).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        layer = tnn.AvgPool2D(k, s, p, exclusive, data_format)
        jl = jnn.AvgPool2D(k, s, p, exclusive, data_format)
        np.testing.assert_allclose(
            layer(torch.from_numpy(x)).numpy(),
            np.asarray(jl(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["constant", "reflect", "replicate",
                                  "circular"])
@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
def test_pad_matches_jax(mode, data_format):
    """The flat form (spatial axes, minor-most first, in the layout's
    order) and the per-axis pairs, widths past the axis included, equal
    JAX's ``jnp.pad`` modes bit for bit, through ``pad`` and ``Pad2D``."""
    x = _x((2, 3, 5, 4) if data_format == "NCHW" else (2, 5, 4, 3), 2)
    for widths in ([1, 2, 3, 0], [4, 9, 6, 1],
                   [[0, 0], [1, 2], [7, 1], [2, 9]]):
        want = np.asarray(JF.pad(jnp.asarray(x), widths, mode, 1.5,
                                 data_format))
        got = TF.pad(torch.from_numpy(x), widths, mode, 1.5, data_format)
        np.testing.assert_array_equal(got.numpy(), want)
    layer = tnn.Pad2D([1, 2, 3, 0], mode, 1.5, data_format)
    np.testing.assert_array_equal(
        layer(torch.from_numpy(x)).numpy(),
        np.asarray(jnn.Pad2D([1, 2, 3, 0], mode, 1.5, data_format)(
            jnp.asarray(x))))


@pytest.mark.parametrize("size", [7, 8])
@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
def test_conv2d_same_with_stride_matches_jax(size, data_format):
    """``padding="SAME"`` at stride 2 (odd and even sizes, dilation 1 and
    2, a 3x3 and a 4x4 kernel): lax's ``ceil(in / s)`` outputs and its
    split of the padding, within 1e-5."""
    for kern, dil in ((3, 1), (3, 2), (4, 1)):
        w = _x((4, 3, kern, kern), 3)
        x = _x((2, 3, size, size + 1), 4)
        if data_format == "NHWC":
            x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
        want = np.asarray(JF.conv2d(jnp.asarray(x), jnp.asarray(w),
                                    stride=2, padding="SAME", dilation=dil,
                                    data_format=data_format))
        got = TF.conv2d(torch.from_numpy(x), torch.from_numpy(w), stride=2,
                        padding="SAME", dilation=dil,
                        data_format=data_format).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_flatten_matches_jax():
    x = _x((2, 3, 4, 5), 5)
    for start, stop in ((1, -1), (0, 1), (2, 3), (-3, -2)):
        want = np.asarray(jnn.Flatten(start, stop)(jnp.asarray(x)))
        got = tnn.Flatten(start, stop)(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, want)


# -- the BatchNorm family -----------------------------------------------------

BN_CASES = {
    "BatchNorm1D_NC": (lambda m, **d: m.BatchNorm1D(6, **d), (8, 6)),
    "BatchNorm1D_NCL": (lambda m, **d: m.BatchNorm1D(6, **d), (4, 6, 5)),
    "BatchNorm3D": (lambda m, **d: m.BatchNorm3D(6, **d), (2, 6, 3, 4, 5)),
    "BatchNorm_relu": (lambda m, **d: m.BatchNorm(6, act="relu", **d),
                       (2, 6, 4, 5)),
    "BatchNorm_3d": (lambda m, **d: m.BatchNorm(6, **d), (2, 6, 3, 4)),
}


@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_batch_norm_layers_match_jax(case):
    """A training forward and backward (loss sum(out · r) for a fixed r),
    then an eval forward: outputs within 1e-5, the new ``_mean`` and
    ``_variance`` within 1e-6, the input, weight and bias gradients within
    1e-4 of their largest."""
    make, shape = BN_CASES[case]
    paddle.seed(0)
    jl = make(jnn)
    tl = _carry(jl, make(tnn, device="cpu"))
    assert set(dict(tl.named_buffers())) == {"_mean", "_variance"}
    x = _x(shape, 6) * 2 + 0.5
    r = _x(shape, 7)
    params, buffers = get_params(jl), get_buffers(jl)

    def loss_fn(p, xx):
        out, nb = functional_call(jl, p, xx, buffers=buffers, mutable=True,
                                  training=True)
        return jnp.sum(out * r), (out, nb)

    (_, (jout, jbuf)), (jg, jdx) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    tl.train()
    tx = torch.from_numpy(x).requires_grad_()
    out = tl(tx)
    (out * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    for name, buf in tl.named_buffers():
        np.testing.assert_allclose(buf.numpy(), np.asarray(jbuf[name]),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    for got, want in [(tx.grad, jdx)] + [
            (p.grad, jg[n]) for n, p in tl.named_parameters()]:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()))
    tl.eval()
    new_buffers = {k: jnp.asarray(v) for k, v in jbuf.items()}
    want = functional_call(jl, params, jnp.asarray(x), buffers=new_buffers,
                           training=False)
    with torch.no_grad():
        np.testing.assert_allclose(tl(torch.from_numpy(x)).numpy(),
                                   np.asarray(want), rtol=1e-5, atol=1e-5)


# -- Conv2D's padding_mode ----------------------------------------------------

@pytest.mark.parametrize("mode", ["reflect", "replicate", "circular"])
@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
def test_conv2d_padding_mode(mode, data_format):
    """The port pads by ``padding`` in ``mode`` and convolves with no
    padding, as Paddle means it: the expectation is JAX's own
    ``F.pad(mode=...)`` then ``F.conv2d(padding=0)`` on the layer's
    weights (within 1e-5), stride 1 and 2, padding (1, 2). JAX's
    ``Conv2D`` takes the argument and zero-pads (a reference fault kept
    visible, ROADMAP Queue 3): it equals the zero-padded conv, not the
    expectation."""
    for stride in (1, 2):
        paddle.seed(2)
        jl = jnn.Conv2D(3, 4, 3, stride=stride, padding=(1, 2),
                        padding_mode=mode, data_format=data_format)
        tl = _carry(jl, tnn.Conv2D(3, 4, 3, stride=stride, padding=(1, 2),
                                   padding_mode=mode,
                                   data_format=data_format, device="cpu"))
        x = _x((2, 3, 6, 7) if data_format == "NCHW" else (2, 6, 7, 3), 8)
        xj = jnp.asarray(x)
        padded = JF.pad(xj, [2, 2, 1, 1], mode=mode, data_format=data_format)
        want = np.asarray(JF.conv2d(padded, jl.weight, jl.bias,
                                    stride=stride, padding=0,
                                    data_format=data_format))
        got = tl(torch.from_numpy(x)).detach().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        zero = np.asarray(JF.conv2d(xj, jl.weight, jl.bias, stride=stride,
                                    padding=(1, 2),
                                    data_format=data_format))
        np.testing.assert_allclose(np.asarray(jl(xj)), zero, rtol=1e-6,
                                   atol=1e-6)
        assert np.abs(zero - want).max() > 1e-2
    with pytest.raises(ValueError, match="padding_mode"):
        tnn.Conv2D(3, 4, 3, padding_mode="mirror", device="cpu")
