"""Port parity: the rest of ``nn.functional`` (norms, the 1-D, 3-D and
transposed convolutions, pools, geometry, extension ops),
``nn.functional_wave4`` and the layers of ``nn/layers.py``, against the
JAX package on the CPU.

- The name sets: the port has every public name of JAX's
  ``nn/functional.py``, ``nn/functional_wave4.py``, ``nn/layers.py``,
  ``nn/rnn.py``, ``nn/utils.py`` and ``nn/layer.py``.
- Each function on the same numpy inputs from a seed; ``interpolate`` in
  each mode up and down (``jax.image.resize``), ``upsample`` ignoring
  ``align_corners`` as JAX does.
- Each layer built on both sides with the same arguments, JAX's weights
  (and buffers) carried into the port by ``convert.from_jax_state_dict(...,
  module=)``, the same input through both.
- The random channel dropouts by shape, range, determinism under the seed
  and moments.

float32: within 1e-5 + 1e-5·|ref| (1e-4 for sums over long axes,
convolutions and ``interpolate``'s antialiased kernels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu.nn.functional_wave4 as JW
import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
import paddle_tpu_torch.nn.functional_wave4 as TW
from paddle_tpu_torch.convert import from_jax_state_dict
from paddle_tpu_torch.core.device import device_guard
from _torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def cpu_device():
    with device_guard("cpu"):
        yield


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) *
            scale).astype(np.float32)


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().numpy()
    return np.asarray(v)


def _close(got, want, tol=1e-5):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, tol)
        return
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _jax(fn, *arrays):
    """``fn`` on the arrays, jitted (eager dispatch is slower), or eagerly
    where it reads values on the host."""
    arrays = tuple(map(jnp.asarray, arrays))
    try:
        return jax.jit(fn)(*arrays)
    except (jax.errors.ConcretizationTypeError,
            jax.errors.TracerIntegerConversionError,
            jax.errors.TracerArrayConversionError):
        return fn(*arrays)


def _both(tfn, jfn, arrays, tol=1e-5, **kw):
    """``tfn`` and ``jfn`` on the same arrays (and array keywords)."""
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    _close(tfn(*map(torch.from_numpy, arrays), **tkw),
           _jax(lambda *a: jfn(*a, **jkw), *arrays), tol)


# -- the name sets ----------------------------------------------------------

@pytest.mark.parametrize("module", ["functional", "functional_wave4",
                                    "layers", "rnn", "utils", "layer"])
def test_public_names(module):
    import importlib
    jm = importlib.import_module(f"paddle_tpu.nn.{module}")
    tm = importlib.import_module(f"paddle_tpu_torch.nn.{module}")
    names = getattr(jm, "__all__", None) or [
        n for n in vars(jm) if not n.startswith("_")]
    if module == "layer":
        names = ["Layer", "Parameter", "ParamRef", "ParamAttr",
                 "HookRemoveHelper"]
    missing = [n for n in names if not hasattr(tm, n)]
    assert not missing, missing
    if hasattr(jm, "__all__"):
        assert set(jm.__all__) <= set(tm.__all__)


def test_package_names_and_flash_reexports():
    assert {n for n in vars(jnn) if not n.startswith("_")} <= \
        {n for n in vars(tnn) if not n.startswith("_")}
    from paddle_tpu_torch import ops
    assert TF.flash_attention is ops.flash_attention
    assert TF.flash_attn_unpadded is ops.flash_attn_unpadded


# -- norms ------------------------------------------------------------------

def test_norms():
    x = _x((2, 4, 5, 6), 1, 2.0)
    w, b = _x((4,), 2), _x((4,), 3)
    _both(TF.rms_norm, JF.rms_norm, (x,))
    _both(TF.rms_norm, JF.rms_norm, (x, _x((6,), 4)), epsilon=1e-3)
    _both(lambda a: TF.rms_norm(a, axis=1), lambda a: JF.rms_norm(a, axis=1),
          (x,))
    _both(lambda a, c, d: TF.group_norm(a, 2, c, d),
          lambda a, c, d: JF.group_norm(a, 2, c, d), (x, w, b))
    for shape in ((2, 4, 7), (2, 4, 5, 6), (2, 4, 3, 4, 5)):
        xs = _x(shape, 5, 2.0)
        _both(lambda a, c, d: TF.instance_norm(a, weight=c, bias=d),
              lambda a, c, d: JF.instance_norm(a, weight=c, bias=d),
              (xs, w, b))
    for size in (3, 4, 5):
        _both(TF.local_response_norm, JF.local_response_norm, (x,),
              size=size, alpha=1e-2, beta=0.5, k=2.0)
    for p in (1, 2, 3, float("inf")):
        _both(TF.normalize, JF.normalize, (x,), p=p, axis=1)
    _both(TF.cosine_similarity, JF.cosine_similarity, (x, _x(x.shape, 6)),
          axis=1)
    _both(TF.cosine_similarity, JF.cosine_similarity,
          (x, _x(x.shape, 7)), axis=-1, eps=1e-3)


# -- convolutions ------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(stride=2, padding=1),
                                dict(padding="SAME", stride=2),
                                dict(padding="VALID", dilation=2),
                                dict(groups=2, padding=2)])
def test_conv1d_conv3d(kw):
    x1, w1, b1 = _x((2, 4, 11), 10), _x((6, 4 // kw.get("groups", 1), 3),
                                        11), _x((6,), 12)
    _both(TF.conv1d, JF.conv1d, (x1, w1, b1), 1e-4, **kw)
    x3 = _x((2, 4, 5, 6, 7), 13)
    w3 = _x((6, 4 // kw.get("groups", 1), 3, 3, 3), 14)
    _both(TF.conv3d, JF.conv3d, (x3, w3, b1), 1e-4, **kw)
    # channels-last 3-D
    x3l = np.moveaxis(x3, 1, -1).copy()
    _both(TF.conv3d, JF.conv3d, (x3l, w3, b1), 1e-4, data_format="NDHWC",
          **kw)


@pytest.mark.parametrize("kw", [dict(), dict(stride=2, padding=1,
                                             output_padding=1),
                                dict(stride=2, dilation=2),
                                dict(stride=3, padding=2, groups=2),
                                dict(stride=2, padding=1, output_size=12)])
def test_conv_transposes(kw):
    g = kw.get("groups", 1)
    b = _x((6,), 20)
    x1, w1 = _x((2, 4, 6), 21), _x((4, 6 // g, 3), 22)
    _both(TF.conv1d_transpose, JF.conv1d_transpose, (x1, w1, b), 1e-4, **kw)
    kw2 = dict(kw)
    if "output_size" in kw2:
        kw2["output_size"] = [12, 12]
    x2, w2 = _x((2, 4, 6, 5), 23), _x((4, 6 // g, 3, 3), 24)
    if "output_size" in kw2:
        x2 = _x((2, 4, 6, 6), 23)
    _both(TF.conv2d_transpose, JF.conv2d_transpose, (x2, w2, b), 1e-4,
          **kw2)
    if "output_size" in kw2:
        kw2["output_size"] = [12, 12, 12]
    x3, w3 = _x((1, 4, 6, 6, 6), 25), _x((4, 6 // g, 3, 3, 3), 26)
    _both(TF.conv3d_transpose, JF.conv3d_transpose, (x3, w3, b), 1e-4,
          **kw2)


# -- pools -------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(kernel_size=2), dict(kernel_size=3,
                                                          stride=2,
                                                          padding=1),
                                dict(kernel_size=3, stride=1, padding=2)])
def test_pools_1d_3d(kw):
    x1 = _x((2, 3, 11), 30)
    _both(TF.max_pool1d, JF.max_pool1d, (x1,), **kw)
    _both(TF.avg_pool1d, JF.avg_pool1d, (x1,), **kw)
    _both(TF.avg_pool1d, JF.avg_pool1d, (x1,), exclusive=False, **kw)
    x3 = _x((2, 3, 6, 7, 5), 31)
    _both(TF.max_pool3d, JF.max_pool3d, (x3,), **kw)
    _both(TF.avg_pool3d, JF.avg_pool3d, (x3,), **kw)
    _both(TF.avg_pool3d, JF.avg_pool3d, (x3,), exclusive=False, **kw)


def test_adaptive_pools_and_unpool():
    x1 = _x((2, 3, 11), 32)
    for out in (1, 3, 5, 11):
        _both(TF.adaptive_avg_pool1d, JF.adaptive_avg_pool1d, (x1,),
              output_size=out)
    x = _x((2, 3, 8, 8), 33)
    pooled, idx = TF.max_pool2d(torch.from_numpy(x), 2, 2, return_mask=True)
    jp, ji = JF.max_pool2d(jnp.asarray(x), 2, 2, return_mask=True)
    _close(TF.max_unpool2d(pooled, idx, 2, 2),
           JF.max_unpool2d(jp, ji, 2, 2))
    _close(TF.max_unpool2d(pooled, idx, 2, 2, output_size=(9, 9)),
           JF.max_unpool2d(jp, ji, 2, 2, output_size=(9, 9)))


# -- geometry ----------------------------------------------------------------

@pytest.mark.parametrize("mode", ["nearest", "bilinear", "bicubic"])
@pytest.mark.parametrize("size", [(16, 16), (5, 5), (13, 6), (3, 20)])
def test_interpolate(mode, size):
    """``jax.image.resize``: half-pixel nearest, antialiased linear and
    Keys cubic when downsampling, up and down and mixed."""
    x = _x((1, 2, 8, 8), 40)
    _both(TF.interpolate, JF.interpolate, (x,), 1e-4, size=size, mode=mode)


@pytest.mark.parametrize("mode", ["nearest", "bilinear", "bicubic"])
def test_interpolate_scale_and_upsample(mode):
    x = _x((2, 3, 10, 12), 41)
    _both(TF.interpolate, JF.interpolate, (x,), 1e-4, scale_factor=2,
          mode=mode)
    # a fractional scale: JAX's _pair truncates it to an int (0.5 -> 0, a
    # fault of the reference); the port takes int(h·sf), int(w·sf), held
    # to JAX's resize at that size
    for sf, size in ((0.5, (5, 6)), ((1.5, 0.75), (15, 9))):
        _close(TF.interpolate(torch.from_numpy(x), scale_factor=sf,
                              mode=mode),
               JF.interpolate(jnp.asarray(x), size=size, mode=mode), 1e-4)
    # align_corners is taken and ignored, as JAX's upsample ignores it
    for ac in (False, True):
        _both(TF.upsample, JF.upsample, (x,), 1e-4, size=(7, 17), mode=mode,
              align_corners=ac)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("padding_mode", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("align_corners", [True, False])
def test_grid_sample_affine_grid(mode, padding_mode, align_corners):
    x = _x((2, 3, 6, 7), 42)
    grid = _x((2, 5, 4, 2), 43, 0.8)      # some points outside [-1, 1]
    _both(TF.grid_sample, JF.grid_sample, (x, grid), mode=mode,
          padding_mode=padding_mode, align_corners=align_corners)
    theta = _x((2, 2, 3), 44, 0.5)
    _close(TF.affine_grid(torch.from_numpy(theta), [2, 3, 5, 4],
                          align_corners=align_corners),
           JF.affine_grid(jnp.asarray(theta), [2, 3, 5, 4],
                          align_corners=align_corners))


def test_shuffles_fold_and_extension_ops():
    x = _x((2, 8, 4, 6), 45)
    _both(TF.pixel_shuffle, JF.pixel_shuffle, (x,), upscale_factor=2)
    _both(TF.pixel_unshuffle, JF.pixel_unshuffle, (x,), downscale_factor=2)
    xl = np.moveaxis(x, 1, -1).copy()
    _both(TF.pixel_unshuffle, JF.pixel_unshuffle, (xl,),
          downscale_factor=2, data_format="NHWC")
    _both(TF.channel_shuffle, JF.channel_shuffle, (x,), groups=4)
    for kw in (dict(kernel_sizes=3), dict(kernel_sizes=(2, 3), strides=2,
                                          paddings=1, dilations=(1, 2))):
        _both(TF.unfold, JF.unfold, (x,), **kw)
        cols = TF.unfold(torch.from_numpy(x), **kw).numpy()
        _both(TF.fold, JF.fold, (cols,), output_sizes=(4, 6), **kw)
    lens = np.array([[3, 0], [5, 1]], np.int32)
    for maxlen in (None, 7):
        got = TF.sequence_mask(torch.from_numpy(lens), maxlen)
        want = JF.sequence_mask(jnp.asarray(lens), maxlen)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = TF.sequence_mask(torch.from_numpy(lens), 6, dtype="float32")
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        JF.sequence_mask(jnp.asarray(lens), 6, dtype="float32")))
    xt = _x((6, 8, 3, 2), 46)
    for fmt in ("NCHW", "NHWC"):
        arr = xt if fmt == "NCHW" else np.moveaxis(xt, 1, -1).copy()
        for ratio in (0.25, 0.125):
            _both(TF.temporal_shift, JF.temporal_shift, (arr,), seg_num=3,
                  shift_ratio=ratio, data_format=fmt)


# -- functional_wave4 --------------------------------------------------------

def test_wave4_distances_and_shapes():
    x, y = _x((4, 6), 50), _x((4, 6), 51)
    for p in (1.0, 2.0, 3.0, float("inf")):
        for keep in (False, True):
            _both(TW.pairwise_distance, JW.pairwise_distance, (x, y), p=p,
                  keepdim=keep)
    v = _x((2, 3, 4), 52)
    for kw in (dict(), dict(offset=1), dict(offset=-2),
               dict(dim1=0, dim2=2), dict(offset=1, dim1=-1, dim2=1)):
        _both(TW.diag_embed, JW.diag_embed, (v,), **kw)
    xi = _x((2, 3, 4, 5), 53)
    _both(TW.zeropad2d, JW.zeropad2d, (xi,), padding=[1, 2, 0, 3])
    w, b = _x((5, 6, 3), 54), _x((5,), 55)
    _both(TW.bilinear, JW.bilinear, (x, _x((4, 3), 56), w, b), 1e-4)
    _both(TW.bilinear, JW.bilinear, (x, _x((4, 3), 56), w), 1e-4)


@pytest.mark.parametrize("out", [1, 3, (2, 3, None)])
def test_wave4_adaptive_pools(out):
    x3 = _x((2, 3, 5, 7, 6), 57)
    _both(TW.adaptive_avg_pool3d, JW.adaptive_avg_pool3d, (x3,),
          output_size=out)
    if isinstance(out, tuple):
        return
    for fn, x in ((1, _x((2, 3, 7), 58)), (2, _x((2, 3, 5, 7), 59)),
                  (3, x3)):
        tf = getattr(TW, f"adaptive_max_pool{fn}d")
        jf = getattr(JW, f"adaptive_max_pool{fn}d")
        if out == 1:
            _both(tf, jf, (x,), output_size=out)
            continue
        got = tf(torch.from_numpy(x), out, return_mask=True)
        want = _jax(lambda a: jf(a, out, return_mask=True), x)
        _close(got[0], want[0])
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_wave4_unpools():
    x = _x((2, 3, 8), 60)
    p, i = TF.max_pool2d(torch.from_numpy(x[:, :, None]), (1, 2), (1, 2),
                         return_mask=True)
    p, i = p[:, :, 0], i[:, :, 0]
    _close(TW.max_unpool1d(p, i, 2), JW.max_unpool1d(
        jnp.asarray(p.numpy()), jnp.asarray(i.numpy()), 2))
    _close(tnn.MaxUnPool1D(2)(p, i), jnp.asarray(JW.max_unpool1d(
        jnp.asarray(p.numpy()), jnp.asarray(i.numpy()), 2)))
    v = _x((2, 3, 2, 2, 2), 61)
    idx = np.stack([np.random.default_rng(62 + k).permutation(64)[:8]
                    for k in range(6)]).reshape(2, 3, 2, 2, 2)
    _close(TW.max_unpool3d(torch.from_numpy(v), torch.from_numpy(idx), 2),
           JW.max_unpool3d(jnp.asarray(v), jnp.asarray(idx), 2))
    _close(tnn.MaxUnPool3D(2)(torch.from_numpy(v), torch.from_numpy(idx)),
           jnn.MaxUnPool3D(2)(jnp.asarray(v), jnp.asarray(idx)))


def test_wave4_losses():
    logit, lab = _x((4, 5), 63), (_x((4, 5), 64) > 0).astype(np.float32)
    for red in ("sum", "mean", "none"):
        _both(TW.sigmoid_focal_loss, JW.sigmoid_focal_loss, (logit, lab),
              reduction=red)
    _both(lambda a, b: TW.sigmoid_focal_loss(a, b, torch.tensor(3.0)),
          lambda a, b: JW.sigmoid_focal_loss(a, b, jnp.asarray(3.0)),
          (logit, lab))
    a, p_, n = _x((4, 6), 65), _x((4, 6), 66), _x((4, 6), 67)
    for red in ("mean", "sum", "none"):
        for swap in (False, True):
            _both(TW.triplet_margin_with_distance_loss,
                  JW.triplet_margin_with_distance_loss, (a, p_, n),
                  reduction=red, swap=swap)
    cls = np.array([0, 3, 1, 4], np.int32)
    for kw in (dict(), dict(p=2, margin=0.5), dict(reduction="none")):
        _both(TW.multi_margin_loss, JW.multi_margin_loss, (logit, cls), **kw)
    _both(lambda a, b: TW.multi_margin_loss(a, b, weight=torch.arange(
        1.0, 6.0)), lambda a, b: JW.multi_margin_loss(
        a, b, weight=jnp.arange(1.0, 6.0)), (logit, cls))
    var = np.abs(_x((4, 5), 68)) + 1e-7
    for kw in (dict(), dict(full=True), dict(reduction="sum"),
               dict(reduction="none", epsilon=0.1)):
        _both(TW.gaussian_nll_loss, JW.gaussian_nll_loss,
              (logit, _x((4, 5), 69), var), **kw)


def test_hsigmoid_rnnt_gather_tree():
    x = _x((6, 8), 70)
    w, b = _x((4, 8), 71), _x((4,), 72)
    lab = np.array([0, 4, 2, 3, 1, 4], np.int32)
    _both(TW.hsigmoid_loss, JW.hsigmoid_loss, (x, lab),
          num_classes=5, weight=w, bias=b)
    _close(TW.hsigmoid_loss(torch.from_numpy(x), torch.from_numpy(lab), 5,
                            torch.from_numpy(w)),
           JW.hsigmoid_loss(jnp.asarray(x), jnp.asarray(lab), 5,
                            jnp.asarray(w)))
    acts = _x((2, 5, 4, 6), 73)
    args = (acts, np.array([[1, 2, 3], [4, 1, 2]], np.int32),
            np.array([5, 4], np.int32), np.array([3, 2], np.int32))
    want = np.asarray(_jax(lambda *a: JW.rnnt_loss(*a, reduction="none"),
                           *args))
    for red, ref in (("none", want), ("sum", want.sum()),
                     ("mean", want.mean())):
        _close(TW.rnnt_loss(*map(torch.from_numpy, args), reduction=red),
               ref, 1e-4)
    ids = np.random.default_rng(74).integers(0, 9, (5, 2, 3)).astype(
        np.int32)
    par = np.random.default_rng(75).integers(0, 3, (5, 2, 3)).astype(
        np.int32)
    np.testing.assert_array_equal(
        TW.gather_tree(torch.from_numpy(ids), torch.from_numpy(par)).numpy(),
        np.asarray(JW.gather_tree(jnp.asarray(ids), jnp.asarray(par))))


def test_sparse_attention():
    b, h, s, d = 2, 2, 6, 4
    q, k, v = _x((b, h, s, d), 76), _x((b, h, s, d), 77), _x((b, h, s, d),
                                                              78)
    rng = np.random.default_rng(79)
    offs, cols = [], []
    for _ in range(b * h):
        deg = rng.integers(1, s + 1, s)
        offs.append(np.concatenate([[0], np.cumsum(deg)]))
        cols.append(np.concatenate([np.sort(rng.permutation(s)[:n])
                                    for n in deg]))
    nnz = max(len(c) for c in cols)
    off = np.stack(offs).reshape(b, h, s + 1).astype(np.int32)
    col = np.stack([np.pad(c, (0, nnz - len(c))) for c in cols]).reshape(
        b, h, nnz).astype(np.int32)
    _both(TW.sparse_attention, JW.sparse_attention, (q, k, v, off, col))


def test_channel_dropouts():
    """``dropout2d``/``dropout3d``/``alpha_dropout`` (and their layers):
    the identity in eval mode; in training whole channels dropped at the
    rate, the kept ones scaled by 1/(1−p), the same draw under one seed;
    alpha dropout's mean and variance kept, as JAX's are."""
    x = np.abs(_x((64, 32, 3, 3), 80)) + 1.0
    for fn, layer, shape in ((TW.dropout2d, tnn.Dropout2D, x.shape),
                             (TW.dropout3d, tnn.Dropout3D,
                              (64, 32, 2, 3, 3))):
        xs = np.abs(_x(shape, 81)) + 1.0
        _close(fn(torch.from_numpy(xs), 0.3, training=False), xs, 0)
        lay = layer(0.3)
        lay.eval()
        _close(lay(torch.from_numpy(xs)), xs, 0)
        tpaddle.seed(5)
        a = fn(torch.from_numpy(xs), 0.3).numpy()
        tpaddle.seed(5)
        lay.train()
        b = lay(torch.from_numpy(xs)).numpy()
        np.testing.assert_array_equal(a, b)
        zero = (a == 0).reshape(shape[0], shape[1], -1)
        assert (zero.all(-1) | ~zero.any(-1)).all()    # whole channels
        rate = zero.all(-1).mean()
        jpaddle.seed(5)
        ja = np.asarray(getattr(JW, fn.__name__)(jnp.asarray(xs), 0.3))
        jrate = (ja == 0).reshape(shape[0], shape[1], -1).all(-1).mean()
        assert abs(rate - 0.3) < 0.04 and abs(rate - jrate) < 0.05
        np.testing.assert_allclose(a[a != 0], (xs / 0.7)[a != 0],
                                   rtol=1e-6)
    z = _x((256, 256), 82)
    tpaddle.seed(6)
    out = TW.alpha_dropout(torch.from_numpy(z), 0.2).numpy()
    jpaddle.seed(6)
    jout = np.asarray(JW.alpha_dropout(jnp.asarray(z), 0.2))
    for o in (out, jout):
        assert abs(o.mean()) < 0.02 and abs(o.std() - 1.0) < 0.02
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    a = (0.8 * (1 + 0.2 * alpha_p ** 2)) ** -0.5
    dropped = np.float32(a * alpha_p - a * alpha_p * 0.2)
    assert abs(np.isclose(out, dropped, rtol=0, atol=1e-6).mean() - 0.2) \
        < 0.01
    _close(TW.alpha_dropout(torch.from_numpy(z), 0.2, training=False), z, 0)
    tpaddle.seed(6)
    _close(tnn.AlphaDropout(0.2)(torch.from_numpy(z)), out, 0)


# -- layers ------------------------------------------------------------------

def _carry(jl, tl):
    sd = {k: np.asarray(v) for k, v in jl.state_dict().items()}
    tl.load_state_dict(from_jax_state_dict(sd, module=tl), strict=True)
    return tl


IMG = (2, 4, 5, 6)
LAYERS = [
    ("ReLU6", (), {}, [IMG]), ("GELU", (), {"approximate": True}, [IMG]),
    ("Silu", (), {}, [IMG]), ("Sigmoid", (), {}, [IMG]),
    ("Tanh", (), {}, [IMG]), ("Softmax", (), {"axis": 1}, [IMG]),
    ("LeakyReLU", (0.2,), {}, [IMG]), ("Hardswish", (), {}, [IMG]),
    ("Hardsigmoid", (), {}, [IMG]), ("ELU", (0.7,), {}, [IMG]),
    ("SELU", (), {}, [IMG]), ("CELU", (), {}, [IMG]),
    ("Hardshrink", (), {}, [IMG]), ("Hardtanh", (), {}, [IMG]),
    ("Softshrink", (), {}, [IMG]), ("Softsign", (), {}, [IMG]),
    ("Tanhshrink", (), {}, [IMG]), ("ThresholdedReLU", (0.5,), {}, [IMG]),
    ("LogSigmoid", (), {}, [IMG]), ("Maxout", (2,), {}, [IMG]),
    ("Mish", (), {}, [IMG]), ("Softplus", (), {"beta": 2.0}, [IMG]),
    ("GLU", (), {}, [IMG]), ("LogSoftmax", (), {}, [IMG]),
    ("Swish", (), {}, [IMG]), ("Softmax2D", (), {}, [IMG]),
    ("PReLU", (4,), {}, [IMG]), ("RReLU", (), {}, [IMG]),
    ("RMSNorm", (6,), {}, [IMG]), ("GroupNorm", (2, 4), {}, [IMG]),
    ("InstanceNorm1D", (4,), {}, [(2, 4, 7)]),
    ("InstanceNorm2D", (4,), {}, [IMG]),
    ("InstanceNorm3D", (4,), {}, [(2, 4, 3, 4, 5)]),
    ("LocalResponseNorm", (3,), {}, [IMG]),
    ("SyncBatchNorm", (4,), {}, [IMG]), ("BatchNorm3D", (4,), {},
                                         [(2, 4, 3, 4, 5)]),
    ("Conv1D", (4, 6, 3), {"stride": 2, "padding": 1}, [(2, 4, 9)]),
    ("Conv3D", (4, 6, 3), {"padding": 1, "groups": 2}, [(1, 4, 4, 5, 6)]),
    ("Conv1DTranspose", (4, 6, 3), {"stride": 2}, [(2, 4, 9)]),
    ("Conv2DTranspose", (4, 6, 3), {"stride": 2, "padding": 1,
                                    "output_padding": 1}, [IMG]),
    ("Conv3DTranspose", (4, 2, 3), {"stride": 2}, [(1, 4, 3, 4, 3)]),
    ("MaxPool1D", (3, 2, 1), {}, [(2, 4, 9)]),
    ("AvgPool1D", (3, 2, 1), {}, [(2, 4, 9)]),
    ("MaxPool3D", (2,), {}, [(1, 4, 4, 5, 6)]),
    ("AvgPool3D", (3, 2, 1), {}, [(1, 4, 4, 5, 6)]),
    ("AdaptiveAvgPool1D", (4,), {}, [(2, 4, 9)]),
    ("AdaptiveAvgPool3D", ((2, 3, 2),), {}, [(1, 4, 4, 5, 6)]),
    ("AdaptiveMaxPool1D", (4,), {}, [(2, 4, 9)]),
    ("AdaptiveMaxPool2D", ((2, 4),), {}, [IMG]),
    ("AdaptiveMaxPool3D", (2,), {}, [(1, 4, 4, 5, 6)]),
    ("Upsample", (), {"scale_factor": 2, "mode": "bilinear"}, [IMG]),
    ("UpsamplingNearest2D", (), {"size": (7, 9)}, [IMG]),
    ("UpsamplingBilinear2D", (), {"size": (3, 4)}, [IMG]),
    ("Pad1D", ([1, 2],), {"mode": "reflect"}, [(2, 4, 9)]),
    ("Pad3D", (1,), {"mode": "replicate"}, [(1, 4, 3, 4, 5)]),
    ("ZeroPad2D", ([1, 0, 2, 1],), {}, [IMG]),
    ("Unfold", (3,), {"paddings": 1}, [IMG]),
    ("Fold", ((4, 5), 2), {}, [(2, 8, 12)]),
    ("PixelShuffle", (2,), {}, [(2, 8, 3, 4)]),
    ("PixelUnshuffle", (2,), {}, [(2, 2, 4, 6)]),
    ("ChannelShuffle", (2,), {}, [IMG]),
    ("Unflatten", (1, [2, 2]), {}, [IMG]),
    ("Bilinear", (3, 4, 5), {}, [(6, 3), (6, 4)]),
    ("CosineSimilarity", (), {"axis": 1}, [IMG, IMG]),
    ("PairwiseDistance", (), {"p": 1.0}, [(5, 6), (5, 6)]),
    ("Dropout2D", (0.5,), {}, [IMG]), ("Dropout3D", (0.5,), {},
                                       [(1, 4, 3, 4, 5)]),
    ("AlphaDropout", (0.5,), {}, [IMG]),
    ("MSELoss", (), {}, [IMG, IMG]), ("L1Loss", ("sum",), {}, [IMG, IMG]),
    ("SmoothL1Loss", (), {"delta": 0.5}, [IMG, IMG]),
    ("SoftMarginLoss", ("none",), {}, [IMG, IMG]),
    ("TripletMarginLoss", (), {"swap": True}, [(4, 6)] * 3),
    ("TripletMarginWithDistanceLoss", (), {"margin": 0.5}, [(4, 6)] * 3),
    ("MarginRankingLoss", (0.2,), {}, [(6,)] * 3),
    ("HingeEmbeddingLoss", (), {}, [IMG, IMG]),
    ("PoissonNLLLoss", (), {}, [IMG, IMG]),
    ("GaussianNLLLoss", (), {"full": True}, [IMG, IMG, "pos"]),
    ("MultiLabelSoftMarginLoss", (), {}, [(4, 5), (4, 5)]),
]


@pytest.mark.parametrize("case", LAYERS, ids=[c[0] for c in LAYERS])
def test_layer(case):
    name, args, kw, shapes = case
    jl = getattr(jnn, name)(*args, **kw)
    tl = _carry(jl, getattr(tnn, name)(*args, **kw))
    jl.eval()
    tl.eval()
    arrays = []
    for i, s in enumerate(shapes):
        if s == "pos":
            arrays.append(np.abs(_x(shapes[0], 90 + i)) + 0.1)
        else:
            arrays.append(_x(s, 90 + i, 2.0))
    _close(tl(*map(torch.from_numpy, arrays)), _jax(jl, *arrays), 1e-4)


def test_layers_with_labels_and_state():
    """The loss layers that take labels, BatchNorm-like layers in training
    (the running statistics too), SpectralNorm with JAX's vectors."""
    logp = np.log(np.random.default_rng(1).dirichlet(np.ones(5), 6)).astype(
        np.float32)
    lab = np.array([0, 4, 2, 1, 3, 4], np.int32)
    probs = 1 / (1 + np.exp(-_x((6, 5), 2)))
    for name, args, arrays in (
            ("NLLLoss", (), (logp, lab)),
            ("KLDivLoss", ("batchmean",), (logp, np.exp(logp))),
            ("BCELoss", (), (probs, (probs > 0.5).astype(np.float32))),
            ("BCEWithLogitsLoss", (), (_x((6, 5), 3), probs)),
            ("CosineEmbeddingLoss", (), (_x((6, 5), 4), _x((6, 5), 5),
                                         np.array([1, -1] * 3, np.float32))),
            ("MultiMarginLoss", (2, 0.7), (_x((6, 5), 6), lab))):
        jl, tl = getattr(jnn, name)(*args), getattr(tnn, name)(*args)
        _close(tl(*map(torch.from_numpy, arrays)),
               jl(*map(jnp.asarray, arrays)), 1e-5)
    # training-mode BatchNorm family: outputs and running statistics
    x = _x((3, 4, 5, 6), 7, 2.0)
    jl, tl = jnn.SyncBatchNorm(4), tnn.SyncBatchNorm(4)
    _close(tl(torch.from_numpy(x)), jl(jnp.asarray(x)), 1e-5)
    _close(tl._mean, jl._mean)
    _close(tl._variance, jl._variance)
    # convert_sync_batchnorm keeps the parameters and statistics
    seq = tnn.Sequential(tnn.Conv2D(3, 4, 3), tnn.BatchNorm2D(4))
    seq[1]._mean = torch.full((4,), 0.5)
    conv = tnn.SyncBatchNorm.convert_sync_batchnorm(seq)
    assert type(conv[1]) is tnn.SyncBatchNorm
    assert conv[1].weight is seq[1].weight
    _close(conv[1]._mean, np.full((4,), 0.5, np.float32))
    # SpectralNorm: JAX's random u, v carried as buffers
    w = _x((6, 4, 3), 8)
    for dim, iters in ((0, 1), (1, 3)):
        jl = jnn.SpectralNorm(w.shape, dim=dim, power_iters=iters)
        tl = _carry(jl, tnn.SpectralNorm(w.shape, dim=dim,
                                         power_iters=iters))
        jl.eval()
        tl.eval()
        _close(tl(torch.from_numpy(w)), _jax(jl, w), 1e-5)
        tl.train()
        tl(torch.from_numpy(w))
        # training moves u to the power iteration's estimate (unit norm)
        assert abs(float(tl.weight_u.norm()) - 1.0) < 1e-5
    # HSigmoidLoss with weights carried
    feat = _x((6, 8), 9)
    jl = jnn.HSigmoidLoss(8, 5)
    tl = _carry(jl, tnn.HSigmoidLoss(8, 5))
    _close(tl(torch.from_numpy(feat), torch.from_numpy(lab)),
           jl(jnp.asarray(feat), jnp.asarray(lab)), 1e-5)
    # RNNTLoss with the default lengths (the full lattice)
    acts = _x((2, 4, 3, 5), 10)
    labels = np.array([[1, 2], [3, 4]], np.int32)
    _close(tnn.RNNTLoss()(torch.from_numpy(acts), torch.from_numpy(labels)),
           _jax(jnn.RNNTLoss(), acts, labels), 1e-4)
    # MaxUnPool2D after MaxPool2D's mask
    xi = _x((2, 3, 6, 6), 11)
    p, i = TF.max_pool2d(torch.from_numpy(xi), 2, 2, return_mask=True)
    jp, ji = JF.max_pool2d(jnp.asarray(xi), 2, 2, return_mask=True)
    _close(tnn.MaxUnPool2D(2)(p, i), jnn.MaxUnPool2D(2)(jp, ji))


def test_containers():
    """``ParameterList`` and ``LayerDict``: the JAX containers' behaviour
    and state_dict keys."""
    pl = tnn.ParameterList([tnn.Parameter(torch.ones(2)),
                            tnn.Parameter(torch.zeros(3))])
    pl.append(tnn.Parameter(torch.full((1,), 2.0)))
    jpl = jnn.ParameterList([jnn.Parameter(jnp.ones(2)),
                             jnn.Parameter(jnp.zeros(3))])
    jpl.append(jnn.Parameter(jnp.full((1,), 2.0)))
    assert len(pl) == len(jpl) == 3
    assert list(pl.state_dict()) == list(jpl.state_dict()) == ["0", "1", "2"]
    _close(pl[2], jpl[2])
    assert [tuple(p.shape) for p in pl] == [(2,), (3,), (1,)]
    ld = tnn.LayerDict({"a": tnn.Linear(2, 3), "b": tnn.ReLU()})
    jld = jnn.LayerDict({"a": jnn.Linear(2, 3), "b": jnn.ReLU()})
    ld["c"] = tnn.Linear(3, 1)
    jld["c"] = jnn.Linear(3, 1)
    assert list(ld.keys()) == list(jld.keys()) == ["a", "b", "c"]
    assert "b" in ld and len(ld) == 3
    del ld["b"]
    del jld["b"]
    assert list(ld.state_dict()) == list(jld.state_dict())
    ld.update([("d", tnn.Tanh())])
    assert list(ld) == ["a", "c", "d"]
    assert isinstance(ld["d"], tnn.Tanh)
