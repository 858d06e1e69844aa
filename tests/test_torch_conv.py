"""Port parity: the conv kernel family (K5-K8) and the fused conv+BN units
against the JAX package.

The port's kernel wrappers run their plain PyTorch versions here (CPU
tensors); the JAX side runs ``ops/_pallas/conv.py`` in Pallas interpret
mode, as ``tests/test_pallas_conv.py`` does, at its cases: 8x8 images at
batch 2, and the three ResNet-50 shape classes of ``RESNET50_TOP3_SHAPES``
at batch 2. Inputs are made with numpy from a seed and handed to both
sides. Each JAX result is computed once per module (fixtures), so the file
stays well under two minutes on one core. Tolerances: float32 within 1e-5
relative (sums of up to 576 products per output, and of up to 6,272 rows
for the stats and weight gradients, taken in another order), bfloat16
within 2e-2 (one bf16 rounding of the output, 2^-8 relative, plus the
prologue's rounding in another arithmetic).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import flags as jflags
from paddle_tpu.nn import fused_conv_bn as JFCB
from paddle_tpu.ops._pallas import conv as pconv
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.nn import fused_conv_bn as TFCB
from paddle_tpu_torch.ops._hopper import conv as hc


def rand(*shape, key, scale=1.0):
    return (np.random.default_rng(key).standard_normal(shape) *
            scale).astype(np.float32)


JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}


def _j(a, dt="f32"):
    return jnp.asarray(a, JNP[dt])


def _t(a, dt="f32"):
    return torch.from_numpy(np.asarray(a)).to(TORCH[dt])


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def assert_close(got, want, dt, what, scale=None):
    """f32: within 1e-5 of the value or 1e-5 of the result's scale (its
    largest |value|, or ``scale`` for a sum that cancels); bf16: 2e-2."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    ref = float(np.abs(want).max()) if scale is None else scale
    tol = 1e-5 if dt == "f32" else 2e-2
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(ref, 1e-6),
                               err_msg=what)


# -- the kernels' plain versions against the Pallas kernels ------------------

# (kind, n, h, w, cin, cout, stride, act, stats, dtype); act None means no
# prologue
CASES = [
    (kind, 2, 8, 8, 8, 16, s, act, True, "f32")
    for kind in ("conv1x1", "conv3x3") for s in (1, 2)
    for act in (None, "none", "relu")
] + [
    ("conv1x1", 2, 8, 8, 8, 16, 1, "relu", False, "f32"),
    ("conv3x3", 2, 8, 8, 8, 16, 2, "relu", False, "f32"),
    ("conv1x1", 2, 8, 8, 8, 16, 2, "relu", True, "bf16"),
    ("conv3x3", 2, 8, 8, 8, 16, 1, "relu", True, "bf16"),
    ("conv3x3", 2, 7, 7, 8, 16, 2, "none", True, "f32"),    # odd H, 7 -> 4
] + [
    (kind, 2, h, w, cin, cout, s, "relu", True, "f32")
    for kind, _, h, w, cin, cout, _ in pconv.RESNET50_TOP3_SHAPES
    for s in (1, 2)
]


def _case_id(c):
    kind, n, h, w, cin, cout, s, act, stats, dt = c
    return (f"{kind}-{h}x{w}-{cin}to{cout}-s{s}-{act or 'noprologue'}-"
            f"{'stats' if stats else 'nostats'}-{dt}")


def _inputs(case):
    kind, n, h, w, cin, cout, s, act, stats, dt = case
    k = 1 if kind == "conv1x1" else 3
    ho, wo = (h - 1) // s + 1, (w - 1) // s + 1
    return dict(
        x=rand(n, h, w, cin, key=1), w=rand(cout, cin, k, k, key=2,
                                            scale=0.1),
        scale=None if act is None else rand(cin, key=3),
        shift=None if act is None else rand(cin, key=4),
        dy=rand(n, ho, wo, cout, key=5), k=k, stride=(s, s),
        padding=(0, 0) if k == 1 else (1, 1))


@functools.lru_cache(maxsize=None)
def _jax_results(case):
    """JAX's conv2d_fwd, conv2d_dgrad and conv2d_wgrad in interpret mode."""
    kind, n, h, w, cin, cout, s, act, stats, dt = case
    d = _inputs(case)
    x, wgt, dy = _j(d["x"], dt), _j(d["w"], dt), _j(d["dy"], dt)
    sc = None if act is None else jnp.asarray(d["scale"])
    sh = None if act is None else jnp.asarray(d["shift"])
    a = act or "none"
    y, st, sst = pconv.conv2d_fwd(x, wgt, sc, sh, act=a, stride=d["stride"],
                                  padding=d["padding"], stats=stats)
    dx = pconv.conv2d_dgrad(dy, wgt, x.shape, d["stride"], d["padding"])
    dw = pconv.conv2d_wgrad(x, dy, wgt.shape, sc, sh, a, d["stride"],
                            d["padding"])
    return tuple(_np(t) for t in (y, st, sst, dx, dw))


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_host_entries_match_pallas(case):
    """conv2d_fwd (y and stats), conv2d_dgrad and conv2d_wgrad (prologue
    recomputed) of the port on the CPU, through K5-K8's plain versions,
    against the Pallas kernels in interpret mode."""
    kind, n, h, w, cin, cout, s, act, stats, dt = case
    d = _inputs(case)
    x, wgt, dy = _t(d["x"], dt), _t(d["w"], dt), _t(d["dy"], dt)
    sc = None if act is None else _t(d["scale"])
    sh = None if act is None else _t(d["shift"])
    a = act or "none"
    y, st, sst = hc.conv2d_fwd(x, wgt, sc, sh, act=a, stride=d["stride"],
                               padding=d["padding"], stats=stats)
    dx = hc.conv2d_dgrad(dy, wgt, x.shape, d["stride"], d["padding"])
    dw = hc.conv2d_wgrad(x, dy, wgt.shape, sc, sh, a, d["stride"],
                         d["padding"])
    jy, js, jss, jdx, jdw = _jax_results(case)
    assert y.dtype == TORCH[dt] and dx.dtype == TORCH[dt]
    assert st.dtype == sst.dtype == dw.dtype == torch.float32
    assert_close(y, jy, dt, "y")
    assert_close(dx, jdx, dt, "dgrad")
    # f32 sums: the stats and dw are f32 in both dtypes; in bf16 both sides
    # sum the same exact products of bf16 values, but of prologue values
    # that may round differently, so bf16 cases keep the 2e-2 limit
    m = y.shape[0] * y.shape[1] * y.shape[2]
    # sum(y) cancels: its scale is the bound sqrt(M * sum(y^2)) on sum|y|
    assert_close(st, js, dt, "sum", scale=float(np.sqrt(m * jss.max())))
    assert_close(sst, jss, dt, "sumsq")
    assert_close(dw, jdw, dt, "wgrad")
    if not stats:
        assert float(st.abs().max()) == 0.0 and float(sst.abs().max()) == 0.0


def test_stats_come_from_the_f32_product_not_the_rounded_output():
    """In bf16 the kernel's stats are sums of the f32 accumulator (conv.py
    ``:161-162``), not of the bf16 y: the plain version keeps that."""
    x = _t(rand(2, 8, 8, 16, key=6), "bf16")
    w2 = _t(rand(16, 8, key=7, scale=0.3), "bf16")
    y, s, ss = hc.mm(x, w2)
    acc = x.float().reshape(-1, 16) @ w2.float()
    assert torch.equal(s, acc.sum(0)) and torch.equal(ss, (acc * acc).sum(0))
    assert not torch.equal(s, y.float().reshape(-1, 8).sum(0))


def test_prologue_rounds_in_the_input_dtype():
    """``x·scale+shift`` in bf16 with scale and shift rounded to bf16
    first, then each operation rounded (conv.py ``:148``)."""
    x = _t(rand(1, 2, 2, 4, key=8), "bf16")
    sc = torch.tensor([1.0 + 2 ** -10, 3.3, -0.7, 1e-3])
    sh = torch.tensor([0.1, -2.2, 5.5, 1.0])
    a = hc._prologue(x, sc, sh, "relu")
    want = torch.clamp_min(x * sc.to(torch.bfloat16) + sh.to(torch.bfloat16),
                           0)
    assert a.dtype == torch.bfloat16 and torch.equal(a, want)


def test_padded_border_stays_zero_through_the_prologue():
    """relu(0·scale + shift) is not 0: the 3x3 prologue is masked to the
    image, so a conv of an all-zero input with a positive shift sees the
    shift inside the image only (``_c3_prologue``)."""
    x = torch.zeros(1, 3, 3, 1)
    wt = torch.ones(9, 1, 1)
    y, _, _ = hc.c3(x, wt, torch.ones(1), torch.ones(1), "relu")
    # each output sums the taps that fall inside the 3x3 image
    want = torch.tensor([[4.0, 6.0, 4.0], [6.0, 9.0, 6.0], [4.0, 6.0, 4.0]])
    assert torch.equal(y[0, :, :, 0], want)


def test_conv2d_autograd_matches_pallas_custom_vjp():
    """The differentiable ``conv2d`` (no prologue): values, dx and dw
    against JAX's ``conv2d`` custom_vjp, 3x3 at stride 2, f32."""
    x, w = rand(2, 8, 8, 8, key=9), rand(16, 8, 3, 3, key=10, scale=0.1)
    cot = rand(2, 4, 4, 16, key=11)
    f = lambda x, w: jnp.sum(pconv.conv2d(x, w, (2, 2), (1, 1)) * cot)
    jv = pconv.conv2d(jnp.asarray(x), jnp.asarray(w), (2, 2), (1, 1))
    jdx, jdw = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    tv = hc.conv2d(tx, tw, 2, 1)
    (tv * _t(cot)).sum().backward()
    assert_close(tv, jv, "f32", "y")
    assert_close(tx.grad, jdx, "f32", "dx")
    assert_close(tw.grad, jdw, "f32", "dw")


# -- routing ----------------------------------------------------------------

# ResNet-50 at B = 256: the convs JAX's TPU VMEM rule sends to lax
JAX_REJECTED = [
    ((256, 14, 14, 512), (512, 512, 3, 3), (2, 2), (1, 1)),
    ((256, 14, 14, 1024), (2048, 1024, 1, 1), (2, 2), (0, 0)),
    ((256, 7, 7, 512), (512, 512, 3, 3), (1, 1), (1, 1)),
]


@pytest.mark.parametrize("x_shape,w_shape,stride,padding", JAX_REJECTED)
def test_supports_takes_the_shapes_the_tpu_rule_rejects(x_shape, w_shape,
                                                       stride, padding):
    """The port checks the shape family only (no TPU memory rule), so all
    52 convs of ResNet-50 at B = 256 run on the kernels; JAX sends these
    to lax."""
    assert not pconv.supports(x_shape, w_shape, stride, padding,
                              dtype=jnp.bfloat16)
    assert hc.supports(x_shape, w_shape, stride, padding,
                       dtype=torch.bfloat16)


def test_supports_matrix_matches_jax_shape_family():
    """The shape family, as ``test_pallas_conv.py``'s matrix checks it."""
    for ok in (functools.partial(pconv.supports, (2, 8, 8, 16)),
               functools.partial(hc.supports, (2, 8, 8, 16))):
        assert ok((32, 16, 1, 1))
        assert ok((32, 16, 3, 3), padding=(1, 1))
        assert ok((32, 16, 3, 3), stride=(2, 2), padding=(1, 1))
        assert not ok((32, 16, 3, 3))                    # pad 0 on 3x3
        assert not ok((32, 16, 1, 1), padding=(1, 1))    # pad on 1x1
        assert not ok((32, 16, 5, 5), padding=(2, 2))    # kernel size
        assert not ok((32, 8, 3, 3), padding=(1, 1), groups=2)
        assert not ok((32, 16, 3, 3), padding=(1, 1), dilation=(2, 2))
        assert not ok((32, 16, 3, 3), stride=(3, 3), padding=(1, 1))
    assert not hc.supports((2, 8, 8, 16), (32, 16, 1, 1), dtype=torch.int32)


def test_flags_default_off_and_set_like_jax():
    assert tflags.get_flags(["fused_conv_bn", "pallas_conv"]) == {
        "fused_conv_bn": 0, "pallas_conv": 0}
    assert not hc.pallas_conv_enabled() and not TFCB.fused_conv_bn_enabled()
    prev = tflags.get_flags(["pallas_conv"])
    try:
        tflags.set_flags({"FLAGS_pallas_conv": 1})
        assert hc.pallas_conv_enabled()
    finally:
        tflags.set_flags(prev)
    with pytest.raises(KeyError, match="pallas_conv"):
        tflags.set_flags({"pallas_con": 1})


def test_wrappers_take_cpu_tensors_to_the_plain_version_only():
    """A CPU tensor runs the plain version (no launch counted); a tensor on
    another device raises; a bad activation raises."""
    before = (hc.mm.launches, hc.mm_wgrad.launches, hc.c3.launches,
              hc.c3_wgrad.launches)
    x = torch.randn(1, 4, 4, 8)
    hc.mm(x, torch.randn(8, 4))
    hc.c3_wgrad(x, torch.randn(1, 4, 4, 4))
    assert (hc.mm.launches, hc.mm_wgrad.launches, hc.c3.launches,
            hc.c3_wgrad.launches) == before
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        hc.mm(x.to("meta"), torch.randn(8, 4, device="meta"))
    with pytest.raises(ValueError, match="act"):
        hc.c3(x, torch.randn(9, 8, 4), act="gelu")


def test_wgrad_split_covers_every_row():
    """K6/K8's split of M: every row in one range, ranges a multiple of
    kernel's 32-row step, about 1,024 blocks at ResNet's shapes."""
    for m, tiles in ((802816, 4), (802816, 9), (12544, 576), (98, 1),
                     (1, 1)):
        splits, rows = hc.wgrad_splits(m, tiles)
        assert rows % 32 == 0 and splits * rows >= m > (splits - 1) * rows
    assert hc.wgrad_splits(802816, 9)[0] * 9 >= 1024


# -- the fused units against JAX's, under both routes -------------------------

UNIT_CONVS = [("conv1x1", 1), ("conv1x1", 2), ("conv3x3", 1), ("conv3x3", 2)]


def _unit_inputs(kind, stride):
    k = 1 if kind == "conv1x1" else 3
    u = rand(2, 8, 8, 8, key=20)
    return dict(u=u, x=np.maximum(u, 0), w=rand(16, 8, k, k, key=21,
                                                scale=0.2),
                gamma=1.0 + 0.1 * rand(8, key=22), beta=rand(8, key=23),
                res=rand(2, 8, 8, 8, key=24), stride=(stride, stride),
                padding=(0, 0) if k == 1 else (1, 1),
                cot=rand(2, 8 // stride, 8 // stride, 16, key=25),
                cot8=rand(2, 8, 8, 8, key=26))


def _jax_units(kind, stride, pallas):
    """JAX's units (fused_conv_bn=1) with the Pallas route on or off:
    outputs, stats and the gradients of sum(out * cot)."""
    d = _unit_inputs(kind, stride)
    prev = jflags.get_flags(["fused_conv_bn", "pallas_conv"])
    jflags.set_flags({"fused_conv_bn": 1, "pallas_conv": int(pallas)})
    try:
        u, x, w = (jnp.asarray(d[k]) for k in ("u", "x", "w"))
        g, b, res = (jnp.asarray(d[k]) for k in ("gamma", "beta", "res"))
        cot, cot8 = jnp.asarray(d["cot"]), jnp.asarray(d["cot8"])
        s, ss = JFCB.channel_stats(u)
        st, pd = d["stride"], d["padding"]
        out = {}
        o, so, sso = JFCB.conv_stats(x, w, st, pd)
        out["conv_stats"] = (o, so, sso) + tuple(jax.grad(
            lambda x, w: jnp.sum(JFCB.conv_stats(x, w, st, pd)[0] * cot),
            argnums=(0, 1))(x, w))
        for act in ("relu", "none"):
            fn = lambda u, g, b, w, act=act: JFCB.conv_bn_act(
                u, g, b, s, ss, w, 1e-5, act, st, pd)
            o, so, sso = fn(u, g, b, w)
            out[f"conv_bn_act_{act}"] = (o, so, sso) + tuple(jax.grad(
                lambda *a: jnp.sum(fn(*a)[0] * cot),
                argnums=(0, 1, 2, 3))(u, g, b, w))
        f3 = lambda u, g, b: JFCB.bn_act_from_stats(u, g, b, s, ss, 1e-5,
                                                     "relu")
        out["bn_act_from_stats"] = (f3(u, g, b),) + tuple(jax.grad(
            lambda *a: jnp.sum(f3(*a) * cot8), argnums=(0, 1, 2))(u, g, b))
        f4 = lambda u, g, b, r: JFCB.bn_add_act(u, g, b, s, ss, r, 1e-5)
        out["bn_add_act"] = (f4(u, g, b, res),) + tuple(jax.grad(
            lambda *a: jnp.sum(f4(*a) * cot8),
            argnums=(0, 1, 2, 3))(u, g, b, res))
        return {k: tuple(_np(t) for t in v) for k, v in out.items()}
    finally:
        jflags.set_flags(prev)


@pytest.fixture(scope="module")
def jax_units():
    return {(kind, s, p): _jax_units(kind, s, p)
            for kind, s in UNIT_CONVS for p in (False, True)}


def _torch_units(kind, stride, pallas):
    d = _unit_inputs(kind, stride)
    prev = tflags.get_flags(["fused_conv_bn", "pallas_conv"])
    tflags.set_flags({"fused_conv_bn": 1, "pallas_conv": int(pallas)})
    try:
        def leaf(k):
            return _t(d[k]).requires_grad_()
        s, ss = TFCB.channel_stats(_t(d["u"]))
        st, pd = d["stride"], d["padding"]
        cot, cot8 = _t(d["cot"]), _t(d["cot8"])
        out = {}
        x, w = leaf("x"), leaf("w")
        o, so, sso = TFCB.conv_stats(x, w, st, pd)
        (o * cot).sum().backward()
        out["conv_stats"] = (o, so, sso, x.grad, w.grad)
        for act in ("relu", "none"):
            u, g, b, w = leaf("u"), leaf("gamma"), leaf("beta"), leaf("w")
            o, so, sso = TFCB.conv_bn_act(u, g, b, s, ss, w, 1e-5, act, st,
                                          pd)
            (o * cot).sum().backward()
            out[f"conv_bn_act_{act}"] = (o, so, sso, u.grad, g.grad, b.grad,
                                         w.grad)
        u, g, b = leaf("u"), leaf("gamma"), leaf("beta")
        o = TFCB.bn_act_from_stats(u, g, b, s, ss, 1e-5, "relu")
        (o * cot8).sum().backward()
        out["bn_act_from_stats"] = (o, u.grad, g.grad, b.grad)
        u, g, b, r = leaf("u"), leaf("gamma"), leaf("beta"), leaf("res")
        o = TFCB.bn_add_act(u, g, b, s, ss, r, 1e-5)
        (o * cot8).sum().backward()
        out["bn_add_act"] = (o, u.grad, g.grad, b.grad, r.grad)
        return out
    finally:
        tflags.set_flags(prev)


@pytest.mark.parametrize("pallas", [False, True],
                         ids=["library_route", "kernel_route"])
@pytest.mark.parametrize("kind,stride", UNIT_CONVS)
def test_fused_units_match_jax(jax_units, kind, stride, pallas):
    """conv_stats, conv_bn_act (relu and none), bn_act_from_stats and
    bn_add_act: outputs, stats and every gradient against JAX's units
    with ``pallas_conv`` the same on both sides (f32; 1e-5 of each
    result's scale: BN's closed form divides by the batch's std)."""
    want = jax_units[(kind, stride, pallas)]
    before = hc.mm.launches + hc.c3.launches
    got = _torch_units(kind, stride, pallas)
    assert hc.mm.launches + hc.c3.launches == before   # CPU: no launch
    for unit, ws in want.items():
        gs = got[unit]
        assert len(gs) == len(ws), unit
        for i, (g, w) in enumerate(zip(gs, ws)):
            scale = None
            if unit.startswith("conv") and i == 1:     # sum(o) cancels
                m = int(np.prod(ws[0].shape[:3]))
                scale = float(np.sqrt(m * ws[2].max()))
            assert_close(g, w, "f32", f"{unit}[{i}]", scale=scale)


def test_units_save_only_the_raw_input():
    """conv_bn_act saves u (and the small parameters), never the
    normalised activation, as the JAX custom_vjp does."""
    d = _unit_inputs("conv3x3", 1)
    u = _t(d["u"]).requires_grad_()
    g, b, w = _t(d["gamma"]), _t(d["beta"]), _t(d["w"])
    s, ss = TFCB.channel_stats(u)
    o, _, _ = TFCB.conv_bn_act(u, g, b, s, ss, w, 1e-5, "relu", 1, 1)
    saved = o.grad_fn.saved_tensors
    assert any(t is u or t.data_ptr() == u.data_ptr() for t in saved)
    assert {tuple(t.shape) for t in saved} <= {
        tuple(u.shape), (8,), tuple(w.shape)}
