"""Port parity: ``vision/ops.py`` (the detection operators) against the
JAX package on the CPU.

- ``nms``: the kept indices equal JAX's exactly, with and without scores,
  with ties (JAX's stable order), ``top_k`` and per-category suppression.
- ``roi_align`` (aligned or not, S = 1, 2, 3 and JAX's S = 2 for
  ``sampling_ratio <= 0``), ``roi_pool`` (JAX's 2 x 2 grid) and
  ``psroi_pool`` with boxes crossing every border of the map, forward and
  the gradient with respect to ``x`` against ``jax.grad`` (JAX jitted).
- ``deform_conv2d`` with offsets that reach past every border, with and
  without the mask, groups and deformable groups: the output and the
  gradients with respect to ``x``, ``offset`` and ``mask``; the
  ``DeformConv2D`` layer on JAX's weights.
- ``box_coder``, ``prior_box``, ``yolo_box``, ``yolo_loss`` (and its
  gradient), ``matrix_nms`` (its index and count outputs exactly),
  ``generate_proposals``, ``distribute_fpn_proposals``, ``read_file`` and
  ``decode_jpeg``; every public name of JAX's ``vision/ops.py``.

float32 values within 1e-5 + 1e-5·|ref| (gradients 1e-5 of the tensor's
largest); indices, counts and integer outputs exactly; int64 where JAX
gives int32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.vision.ops as J
import paddle_tpu_torch.vision.ops as P
from paddle_tpu_torch.core.device import device_guard
from _torch_threads import one_torch_thread  # noqa: F401

T = torch.as_tensor


@pytest.fixture(scope="module", autouse=True)
def cpu_device():
    with device_guard("cpu"):
        yield


def close(ref, got, tol=1e-5):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    assert ref.shape == got.shape
    assert np.all(np.abs(got - ref) <= tol + tol * np.abs(ref)), \
        float(np.abs(got - ref).max())


def grad_close(ref, got, tol=1e-5):
    ref = np.asarray(ref)
    got = got.numpy()
    assert np.abs(got - ref).max() <= tol * max(np.abs(ref).max(), 1.0)


def boxes_xyxy(rng, n, lo, hi, wmin, wmax):
    c = rng.uniform(lo, hi, (n, 2))
    wh = rng.uniform(wmin, wmax, (n, 2))
    return np.concatenate([c, c + wh], 1).astype(np.float32)


NMS = [("plain", {}), ("scores", {"s": 1}), ("top_k", {"s": 1, "top_k": 7}),
       ("categories", {"s": 1, "cat": 4}), ("ties", {"tie": 1}),
       ("categories_top_k", {"s": 1, "cat": 3, "top_k": 11})]


@pytest.mark.parametrize("thresh", [0.3, 0.5, 0.7])
@pytest.mark.parametrize("case,kw", NMS, ids=[c for c, _ in NMS])
def test_nms_indices_exact(case, kw, thresh):
    rng = np.random.default_rng(11)
    boxes = boxes_xyxy(rng, 80, 0, 60, 4, 30)
    args, targs = {}, {}
    if "s" in kw:
        s = rng.random(80).astype(np.float32)
        args["scores"], targs["scores"] = s, T(s)
    if "tie" in kw:
        s = np.round(rng.random(80) * 4).astype(np.float32) / 4
        args["scores"], targs["scores"] = s, T(s)
    if "cat" in kw:
        cat = rng.integers(0, kw["cat"], 80)
        args["category_idxs"], targs["category_idxs"] = cat, T(cat)
        args["categories"] = targs["categories"] = list(range(kw["cat"]))
    if "top_k" in kw:
        args["top_k"] = targs["top_k"] = kw["top_k"]
    want = np.asarray(J.nms(boxes, thresh, **args))
    got = P.nms(T(boxes), thresh, **targs)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)


def test_nms_empty_and_disjoint():
    assert P.nms(torch.zeros((0, 4)), 0.5).shape == (0,)
    far = np.array([[0, 0, 1, 1], [5, 5, 6, 6], [9, 9, 10, 10]], np.float32)
    assert P.nms(T(far), 0.1).tolist() == \
        np.asarray(J.nms(far, 0.1)).tolist() == [0, 1, 2]


def roi_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 3, 9, 11)).astype(np.float32)
    # boxes past every border (in input coordinates at scale 0.9)
    boxes = np.array([[-2, -1, 5, 6], [1, 1, 12.5, 10.5],
                      [3.2, 0.5, 4.1, 8.9], [0, 0, 11, 9],
                      [-3, -3, -0.5, -0.2], [10.3, 8.4, 14, 12]], np.float32)
    return x, boxes, np.array([2, 4])


ROI = [(aligned, sr, size) for aligned in (True, False)
       for sr, size in ((-1, (3, 2)), (0, 2), (1, 4), (2, (2, 3)),
                        (3, 1))]


@pytest.mark.parametrize("aligned,sr,size", ROI)
def test_roi_align_forward_and_grad(aligned, sr, size):
    x, boxes, num = roi_inputs()
    ref_fn = jax.jit(functools.partial(
        J.roi_align, output_size=size, spatial_scale=0.9, sampling_ratio=sr,
        aligned=aligned))
    close(ref_fn(x, boxes, num),
          P.roi_align(T(x), T(boxes), T(num), size, 0.9, sr, aligned))
    g = jax.grad(lambda v: (ref_fn(v, boxes, num) ** 2).sum())(x)
    xt = T(x).clone().requires_grad_(True)
    (P.roi_align(xt, T(boxes), T(num), size, 0.9, sr, aligned) ** 2) \
        .sum().backward()
    grad_close(g, xt.grad)


@pytest.mark.parametrize("size", [1, 3, (2, 4)])
def test_roi_pool_and_psroi_pool(size):
    x, boxes, num = roi_inputs(1)
    ref_fn = jax.jit(functools.partial(J.roi_pool, output_size=size,
                                       spatial_scale=0.9))
    close(ref_fn(x, boxes, num),
          P.roi_pool(T(x), T(boxes), T(num), size, 0.9))
    g = jax.grad(lambda v: (ref_fn(v, boxes, num) ** 2).sum())(x)
    xt = T(x).clone().requires_grad_(True)
    (P.roi_pool(xt, T(boxes), T(num), size, 0.9) ** 2).sum().backward()
    grad_close(g, xt.grad)
    ph, pw = (size, size) if isinstance(size, int) else size
    xx = np.random.default_rng(2).standard_normal(
        (2, 2 * ph * pw, 8, 10)).astype(np.float32)
    ps_ref = jax.jit(functools.partial(J.psroi_pool, output_size=size,
                                       spatial_scale=0.9))
    close(ps_ref(xx, boxes, num),
          P.psroi_pool(T(xx), T(boxes), T(num), size, 0.9))
    # the layer forms (JAX's are the same thin wrappers of its functions)
    align_ref = jax.jit(functools.partial(J.roi_align, output_size=size,
                                          spatial_scale=0.9))
    for ref, tc, a in ((align_ref, P.RoIAlign, x), (ref_fn, P.RoIPool, x),
                       (ps_ref, P.PSRoIPool, xx)):
        close(ref(a, boxes, num), tc(size, 0.9)(T(a), T(boxes), T(num)))
    with pytest.raises(ValueError):
        P.psroi_pool(T(x), T(boxes), T(num), 2)


DEFORM = [
    dict(stride=1, padding=1, dilation=1, dg=1, groups=1, mask=True),
    dict(stride=1, padding=1, dilation=1, dg=1, groups=1, mask=False),
    dict(stride=2, padding=1, dilation=1, dg=2, groups=2, mask=True),
    dict(stride=1, padding=2, dilation=2, dg=2, groups=1, mask=False),
    dict(stride=(1, 2), padding=(0, 1), dilation=1, dg=1, groups=2,
         mask=True),
]


@pytest.mark.parametrize("cfg", DEFORM, ids=[str(i) for i in range(5)])
def test_deform_conv2d_and_grads(cfg):
    rng = np.random.default_rng(3)
    n, cin, h, w, cout, k = 2, 4, 7, 8, 6, 3
    sh, sw = cfg["stride"] if isinstance(cfg["stride"], tuple) \
        else (cfg["stride"],) * 2
    ph, pw = cfg["padding"] if isinstance(cfg["padding"], tuple) \
        else (cfg["padding"],) * 2
    d = cfg["dilation"]
    ho = (h + 2 * ph - d * (k - 1) - 1) // sh + 1
    wo = (w + 2 * pw - d * (k - 1) - 1) // sw + 1
    dg, groups = cfg["dg"], cfg["groups"]
    x = rng.standard_normal((n, cin, h, w)).astype(np.float32)
    wt = rng.standard_normal((cout, cin // groups, k, k)).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    # offsets large enough to reach past every border
    off = (4 * rng.standard_normal((n, 2 * dg * k * k, ho, wo))) \
        .astype(np.float32)
    mask = rng.random((n, dg * k * k, ho, wo)).astype(np.float32) \
        if cfg["mask"] else None
    kw = dict(stride=cfg["stride"], padding=cfg["padding"], dilation=d,
              deformable_groups=dg, groups=groups)
    ref = jax.jit(lambda x, o, m: J.deform_conv2d(
        x, o, jnp.asarray(wt), jnp.asarray(bias), mask=m, **kw))
    args = [x, off] + ([mask] if mask is not None else [])
    ts = [T(a).clone().requires_grad_(True) for a in args]
    got = P.deform_conv2d(ts[0], ts[1], T(wt), T(bias),
                          mask=ts[2] if mask is not None else None, **kw)
    close(ref(x, off, mask), got, 1e-4)
    argnums = tuple(range(len(args)))
    grads = jax.grad(lambda *a: (ref(*(list(a) + [None] * (3 - len(a))))
                                 ** 2).sum(), argnums=argnums)(*args)
    (got ** 2).sum().backward()
    for g, t in zip(grads, ts):
        grad_close(g, t.grad, 1e-5)


def test_deform_conv2d_layer_and_bad_offset():
    rng = np.random.default_rng(4)
    jl = J.DeformConv2D(4, 5, 3, padding=1, deformable_groups=2)
    tl = P.DeformConv2D(4, 5, 3, padding=1, deformable_groups=2,
                        device="cpu")
    assert tuple(tl.weight.shape) == tuple(jl.weight.shape)
    assert not tl.bias.detach().any()
    with torch.no_grad():
        tl.weight.copy_(torch.tensor(np.asarray(jl.weight)))
        tl.bias.copy_(torch.tensor(np.asarray(jl.bias)))
    x = rng.standard_normal((1, 4, 6, 5)).astype(np.float32)
    off = (2 * rng.standard_normal((1, 36, 6, 5))).astype(np.float32)
    m = rng.random((1, 18, 6, 5)).astype(np.float32)
    close(jax.jit(jl.__call__)(x, off, m), tl(T(x), T(off), T(m)), 1e-4)
    with pytest.raises(ValueError):
        P.deform_conv2d(T(x), T(off[:, :10]), tl.weight)


@pytest.mark.parametrize("code", ["encode_center_size",
                                  "decode_center_size"])
@pytest.mark.parametrize("normalized", [True, False])
def test_box_coder(code, normalized):
    rng = np.random.default_rng(5)
    prior = boxes_xyxy(rng, 30, 0, 50, 5, 40)
    target = boxes_xyxy(rng, 30, 0, 50, 5, 40) if code.startswith("enc") \
        else (0.5 * rng.standard_normal((30, 4))).astype(np.float32)
    var = np.array([0.1, 0.1, 0.2, 0.2], np.float32)
    for v in (var, None):
        close(J.box_coder(prior, v, target, code, normalized),
              P.box_coder(T(prior), None if v is None else T(v), T(target),
                          code, normalized))
    with pytest.raises(ValueError):
        P.box_coder(T(prior), T(var), T(target), "center")


PRIOR = [dict(min_sizes=[30.], max_sizes=[60.], aspect_ratios=[2., 3.],
              flip=True, clip=True),
         dict(min_sizes=[20., 40.], max_sizes=[40., 80.], aspect_ratios=[2.],
              flip=True, min_max_aspect_ratios_order=True, steps=(16, 16)),
         dict(min_sizes=[60.], aspect_ratios=[1.], offset=0.3)]


@pytest.mark.parametrize("kw", PRIOR, ids=["ssd", "order", "plain"])
def test_prior_box(kw):
    got = P.prior_box(torch.zeros(1, 8, 5, 6), torch.zeros(1, 3, 300, 320),
                      **kw)
    want = J.prior_box(jnp.zeros((1, 8, 5, 6)), jnp.zeros((1, 3, 300, 320)),
                       **kw)
    for a, b in zip(want, got):
        close(a, b, 1e-6)


@pytest.mark.parametrize("iou_aware", [False, True])
@pytest.mark.parametrize("clip", [True, False])
def test_yolo_box(iou_aware, clip):
    rng = np.random.default_rng(6)
    c = 4
    x = rng.standard_normal((2, 3 * (5 + c + iou_aware), 5, 6)) \
        .astype(np.float32)
    size = np.array([[320, 300], [200, 250]])
    anchors = [10, 13, 16, 30, 33, 23]
    want = jax.jit(lambda v: J.yolo_box(v, size, anchors, c, 0.3, 32, clip,
                                        1.05, iou_aware, 0.4))(x)
    got = P.yolo_box(T(x), T(size), anchors, c, 0.3, 32, clip, 1.05,
                     iou_aware, 0.4)
    close(want[0], got[0], 1e-5)
    close(want[1], got[1], 1e-6)


@pytest.mark.parametrize("smooth,score", [(True, True), (False, False)])
def test_yolo_loss_and_grad(smooth, score):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 3 * 9, 5, 6)).astype(np.float32)
    gt = np.concatenate([rng.uniform(0.05, 0.95, (2, 6, 2)),
                         rng.uniform(0.02, 0.4, (2, 6, 2))], -1) \
        .astype(np.float32)
    gt[0, 4:] = 0                             # padding rows
    label = rng.integers(0, 4, (2, 6))
    gscore = rng.random((2, 6)).astype(np.float32) if score else None
    anchors = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]
    ref = jax.jit(lambda v: J.yolo_loss(
        v, gt, label, anchors, [3, 4, 5], 4, 0.3, 32, gt_score=gscore,
        use_label_smooth=smooth))
    xt = T(x).clone().requires_grad_(True)
    got = P.yolo_loss(xt, T(gt), T(label), anchors, [3, 4, 5], 4, 0.3, 32,
                      gt_score=None if gscore is None else T(gscore),
                      use_label_smooth=smooth)
    close(ref(x), got, 1e-5)
    g = jax.grad(lambda v: ref(v).sum())(x)
    got.sum().backward()
    grad_close(g, xt.grad)


MNMS = [dict(score_threshold=0.3, post_threshold=0.2, nms_top_k=10,
             keep_top_k=15),
        dict(score_threshold=0.1, post_threshold=0.05, nms_top_k=-1,
             keep_top_k=-1, use_gaussian=True, background_label=-1,
             normalized=False),
        dict(score_threshold=0.5, post_threshold=0.6, nms_top_k=100,
             keep_top_k=5, background_label=2),
        dict(score_threshold=0.99, post_threshold=0.5, nms_top_k=10,
             keep_top_k=10)]


@pytest.mark.parametrize("kw", MNMS, ids=["top", "gaussian", "bg", "none"])
def test_matrix_nms(kw):
    rng = np.random.default_rng(8)
    n, m, c = 2, 40, 4
    boxes = np.stack([boxes_xyxy(rng, m, 0, 1, 0.05, 0.4)
                      for _ in range(n)])
    scores = rng.random((n, c, m)).astype(np.float32)
    want = J.matrix_nms(boxes, scores, return_index=True, **kw)
    got = P.matrix_nms(T(boxes), T(scores), return_index=True, **kw)
    close(want[0], got[0], 1e-6)
    assert got[1].dtype == got[2].dtype == torch.int64
    assert np.array_equal(np.asarray(want[1]), got[1].numpy())
    assert np.array_equal(np.asarray(want[2]), got[2].numpy())
    alone = P.matrix_nms(T(boxes), T(scores), return_rois_num=False, **kw)
    assert isinstance(alone, torch.Tensor) and alone.shape == got[0].shape


@pytest.mark.parametrize("offset", [False, True])
def test_generate_proposals(offset):
    rng = np.random.default_rng(9)
    a, h, w = 3, 6, 7
    scores = rng.random((2, a, h, w)).astype(np.float32)
    deltas = (0.3 * rng.standard_normal((2, 4 * a, h, w))).astype(np.float32)
    anchors = boxes_xyxy(rng, h * w * a, 0, 40, 2, 40)
    var = np.ones((h * w * a, 4), np.float32)
    size = np.array([[60, 70], [50, 50]])
    kw = dict(pre_nms_top_n=80, post_nms_top_n=30, nms_thresh=0.5,
              min_size=3.0, pixel_offset=offset, return_rois_num=True)
    want = J.generate_proposals(scores, deltas, size, anchors, var, **kw)
    got = P.generate_proposals(T(scores), T(deltas), size, T(anchors),
                               T(var), **kw)
    close(want[0], got[0], 1e-5)
    close(want[1], got[1], 1e-6)
    assert np.array_equal(np.asarray(want[2]), got[2].numpy())
    assert got[2].dtype == torch.int64
    two = P.generate_proposals(T(scores), T(deltas), size, T(anchors),
                               T(var), **{**kw, "return_rois_num": False})
    assert len(two) == 2


def test_distribute_fpn_proposals():
    rng = np.random.default_rng(10)
    rois = boxes_xyxy(rng, 40, 0, 100, 2, 600)
    for offset in (False, True):
        want = J.distribute_fpn_proposals(rois, 2, 5, 4, 224, offset)
        got = P.distribute_fpn_proposals(T(rois), 2, 5, 4, 224, offset)
        assert len(got[0]) == len(want[0]) == 4
        for a, b in zip(want[0], got[0]):
            close(a, b, 0)
        assert np.array_equal(np.asarray(want[1]), got[1].numpy())


def test_read_file_and_decode_jpeg(tmp_path):
    from PIL import Image
    rng = np.random.default_rng(12)
    path = str(tmp_path / "im.jpg")
    Image.fromarray(rng.integers(0, 256, (12, 10, 3)).astype(np.uint8)) \
        .save(path)
    raw = P.read_file(path)
    assert raw.dtype == torch.uint8 and raw.device.type == "cpu"
    assert np.array_equal(raw.numpy(), np.asarray(J.read_file(path)))
    for mode in ("unchanged", "gray", "rgb"):
        want = np.asarray(J.decode_jpeg(J.read_file(path), mode))
        got = P.decode_jpeg(raw, mode)
        assert np.array_equal(want, got.numpy()) and got.dtype == torch.uint8


def test_every_public_name_is_ported():
    assert sorted(set(J.__all__) - set(P.__all__)) == []
    assert len(J.__all__) == 18
    for name in J.__all__:
        assert callable(getattr(P, name)), name
