"""Port parity in float16: the kernels' plain versions (what a CPU tensor
runs) against the JAX package's kernels in Pallas interpret mode, as JAX
runs float16 on a TPU, and the CUDA argument checks, which take float16.

JAX's ``supports`` (conv) and ``supported_shapes`` (attention) do not test
the dtype, and its kernels' dots name an f32 result type, so a float16
input runs the kernels there; the port's wrappers take float16 as they take
bf16. Inputs are made with numpy from a seed and handed to both sides.

Tolerances: bf16's, scaled to float16's ulp (2^-10 against bf16's 2^-7 of
a value, an eighth): outputs within 2.5e-3 + 2.5e-3·|ref| (one float16
rounding apart, and the prologue's in another arithmetic); the f32 sums
over M (the stats and the weight gradients) within 2.5e-3 of their scale;
attention's o and gradients within 2^-10, one float16 ulp of a value in
[1, 2).
"""

import contextlib
import importlib

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

jfmb = importlib.import_module("paddle_tpu.ops._pallas.fused_matmul_bn")
tfmb = importlib.import_module(
    "paddle_tpu_torch.ops._hopper.fused_matmul_bn")
hfa = importlib.import_module("paddle_tpu_torch.ops._hopper.flash_attention")
hfp = importlib.import_module(
    "paddle_tpu_torch.ops._hopper.flash_attention_packed")
tfa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")

TOL = 2.5e-3


def rand(*shape, key, scale=1.0):
    return (np.random.default_rng(key).standard_normal(shape) *
            scale).astype(np.float32)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def close(got, want, what, scale=None):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    if scale is None:
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                   err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale,
                                   err_msg=what)


@contextlib.contextmanager
def interpreted(*modules):
    """The JAX package's Pallas calls in interpret mode on the CPU."""
    import jax.experimental.pallas as pl
    orig = pl.pallas_call

    def call(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    pl.pallas_call = call
    for m in modules:
        m.pl.pallas_call = call
    try:
        yield
    finally:
        pl.pallas_call = orig
        for m in modules:
            m.pl.pallas_call = orig


# -- K5-K8: the host entries at 2x8x8x16 with the prologue on ----------------

@pytest.mark.parametrize("kind,stride", [("conv1x1", 1), ("conv1x1", 2),
                                         ("conv3x3", 1), ("conv3x3", 2)])
def test_conv_entries_in_float16_match_pallas(kind, stride):
    """conv2d_fwd (y in float16, the f32 stats), conv2d_dgrad and
    conv2d_wgrad (the 1x1 and 3x3 weight gradients with the ReLU prologue
    recomputed) against ``ops/_pallas/conv.py`` in interpret mode."""
    k = 1 if kind == "conv1x1" else 3
    pad = (0, 0) if k == 1 else (1, 1)
    st = (stride, stride)
    ho = (8 - 1) // stride + 1
    x, w = rand(2, 8, 8, 16, key=1), rand(16, 16, k, k, key=2, scale=0.1)
    sc, sh, dy = rand(16, key=3), rand(16, key=4), rand(2, ho, ho, 16, key=5)
    assert pconv.supports(x.shape, w.shape, st, pad, dtype=jnp.float16)
    assert hc.supports(x.shape, w.shape, st, pad, dtype=torch.float16)
    jx, jw, jdy = (jnp.asarray(a, jnp.float16) for a in (x, w, dy))
    with interpreted(pconv):
        jy, js, jss = pconv.conv2d_fwd(jx, jw, jnp.asarray(sc),
                                       jnp.asarray(sh), act="relu",
                                       stride=st, padding=pad)
        jdx = pconv.conv2d_dgrad(jdy, jw, jx.shape, st, pad)
        jdw = pconv.conv2d_wgrad(jx, jdy, jw.shape, jnp.asarray(sc),
                                 jnp.asarray(sh), "relu", st, pad)
    tx, tw, tdy = (torch.from_numpy(a).half() for a in (x, w, dy))
    tsc, tsh = torch.from_numpy(sc), torch.from_numpy(sh)
    y, s, ss = hc.conv2d_fwd(tx, tw, tsc, tsh, act="relu", stride=st,
                             padding=pad)
    dx = hc.conv2d_dgrad(tdy, tw, tx.shape, st, pad)
    dw = hc.conv2d_wgrad(tx, tdy, tw.shape, tsc, tsh, "relu", st, pad)
    assert jy.dtype == jnp.float16 and y.dtype == torch.float16
    assert dx.dtype == torch.float16 and dw.dtype == torch.float32
    close(y, jy, "y")
    close(dx, jdx, "dgrad")
    m = 2 * ho * ho
    close(s, js, "sum", scale=float(np.sqrt(m * _np(jss).max())))
    close(ss, jss, "sumsq", scale=float(_np(jss).max()))
    close(dw, jdw, "wgrad", scale=float(np.abs(_np(jdw)).max()))


# -- K9 at M = 77 -------------------------------------------------------------

def test_k9_in_float16_at_ragged_m_matches_jax():
    """``fused_matmul_bn_act`` in float16 at M = 77 (no whole ``block_m``
    block, so JAX's ``_fwd`` is taken as the jnp expression of its
    function, its VJP rules unchanged): y, the stats and the gradients."""
    rng = np.random.default_rng(77)
    m, cin, cout = 77, 24, 32
    x = rng.standard_normal((m, cin)).astype(np.float32)
    w = (rng.standard_normal((cin, cout)) / np.sqrt(cin)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, cin).astype(np.float32)
    shift = rng.uniform(-0.5, 0.5, cin).astype(np.float32)
    dy = rng.standard_normal((m, cout)).astype(np.float32)
    ds = rng.standard_normal(cout).astype(np.float32)
    dss = (0.1 * rng.standard_normal(cout)).astype(np.float32)

    def expr(x, w, scale, shift, prologue, stats, block_m):
        xb = jnp.maximum(x * scale.astype(x.dtype) + shift.astype(x.dtype),
                         0)
        acc = jax.lax.dot_general(xb, w, (((1,), (0,)), ((), ())),
                                  preferred_element_type=jnp.float32)
        return acc.astype(x.dtype), jnp.sum(acc, 0), jnp.sum(acc * acc, 0)

    fn = jax.custom_vjp(expr, nondiff_argnums=(4, 5, 6))
    fn.defvjp(lambda *a: (expr(*a), a[:4]), jfmb._vjp_bwd)
    out, vjp = jax.vjp(lambda *a: fn(*a, "scale_shift_relu", True, 512),
                       jnp.asarray(x, jnp.float16),
                       jnp.asarray(w, jnp.float16), jnp.asarray(scale),
                       jnp.asarray(shift))
    ref = [*out, *vjp((jnp.asarray(dy, jnp.float16), jnp.asarray(ds),
                       jnp.asarray(dss)))]
    tx = torch.tensor(x).half().requires_grad_()
    tw = torch.tensor(w).half().requires_grad_()
    tsc = torch.tensor(scale).requires_grad_()
    tsh = torch.tensor(shift).requires_grad_()
    y, s, ss = tfmb.fused_matmul_bn_act(tx, tw, tsc, tsh,
                                        "scale_shift_relu", True)
    ((y.float() * torch.tensor(dy).half().float()).sum() +
     (s * torch.tensor(ds)).sum() + (ss * torch.tensor(dss)).sum()).backward()
    assert y.dtype == torch.float16
    for name, g, r in zip(("y", "sum", "sumsq", "dx", "dw", "dscale",
                           "dshift"),
                          (y, s, ss, tx.grad, tw.grad, tsc.grad, tsh.grad),
                          ref):
        if name in ("y", "dx"):
            close(g, r, name)
        else:
            close(g, r, name, scale=float(np.abs(_np(r)).max()))


# -- K4 through ops.flash_attention: the direct forward, the fused backward --

def test_k4_in_float16_through_flash_attention_matches_pallas():
    """Float16 at head dim 64, 2 heads of MHA, S = 128, through
    ``ops.flash_attention`` on both sides: JAX's ``flash_attention_pallas``
    sends it to ``flash_attention_packed`` (its direct forward and fused
    backward, ``plan``'s forms), run in interpret mode; the port reaches
    K4a-direct's and K4b-fused's plain versions. o and the gradients of q,
    k and v within 2^-10."""
    from paddle_tpu.ops._pallas import flash_attention as fa
    from paddle_tpu.ops._pallas import flash_attention_packed as fp
    b, s, h, d = 2, 128, 2, 64
    rng = np.random.default_rng(64)
    q, k, v, w = (rng.standard_normal((b, s, h, d)).astype(np.float32)
                  for _ in range(4))
    assert hfp.plan(s, s, h) == ("direct", "fused", None)

    def jloss(q_, k_, v_):
        out = fa.flash_attention_pallas(q_, k_, v_)
        return jnp.sum(out.astype(jnp.float32) * w), out

    with interpreted(fa, fp):
        (_, jout), jgrads = jax.value_and_grad(
            jloss, argnums=(0, 1, 2), has_aux=True)(
                *(jnp.asarray(x, jnp.float16) for x in (q, k, v)))
    tx = [torch.from_numpy(x).half().requires_grad_() for x in (q, k, v)]
    out = tfa.flash_attention(*tx)
    (out.float() * torch.from_numpy(w)).sum().backward()
    assert out.dtype == torch.float16
    np.testing.assert_allclose(_np(out), _np(jout), atol=2 ** -10, rtol=0)
    for name, t, g in zip("qkv", tx, jgrads):
        np.testing.assert_allclose(_np(t.grad), _np(g), atol=2 ** -10,
                                   rtol=0, err_msg=f"d{name}")


# -- a float16 BN-fused ResNet unit -------------------------------------------

def test_conv_bn_act_unit_in_float16_matches_jax():
    """``conv_bn_act`` (the 1x1 conv of BN(u)+ReLU, with its stats) in
    float16 on the kernel route in both packages: forward and the
    gradients of u, gamma, beta and w against JAX's, its Pallas kernels
    in interpret mode."""
    u = rand(2, 8, 8, 16, key=20)
    w = rand(16, 16, 1, 1, key=21, scale=0.1)
    g, bt = 1.0 + 0.1 * rand(16, key=22), rand(16, key=23)
    cot = rand(2, 8, 8, 16, key=25)
    prev = jflags.get_flags(["fused_conv_bn", "pallas_conv"])
    tprev = tflags.get_flags(["fused_conv_bn", "pallas_conv"])
    jflags.set_flags({"fused_conv_bn": 1, "pallas_conv": 1})
    tflags.set_flags({"fused_conv_bn": 1, "pallas_conv": 1})
    try:
        ju, jw = jnp.asarray(u, jnp.float16), jnp.asarray(w, jnp.float16)
        s, ss = JFCB.channel_stats(ju)

        def jfn(u_, g_, b_, w_):
            return JFCB.conv_bn_act(u_, g_, b_, s, ss, w_, 1e-5, "relu",
                                    (1, 1), (0, 0))

        with interpreted(pconv):
            jo, jso, jsso = jfn(ju, jnp.asarray(g), jnp.asarray(bt), jw)
            jgrads = jax.grad(lambda *a: jnp.sum(
                jfn(*a)[0].astype(jnp.float32) * cot), argnums=(0, 1, 2, 3))(
                    ju, jnp.asarray(g), jnp.asarray(bt), jw)
        tu = torch.from_numpy(u).half().requires_grad_()
        tw = torch.from_numpy(w).half().requires_grad_()
        tg = torch.from_numpy(g).requires_grad_()
        tb = torch.from_numpy(bt).requires_grad_()
        ts, tss = TFCB.channel_stats(tu.detach())
        o, so, sso = TFCB.conv_bn_act(tu, tg, tb, ts, tss, tw, 1e-5, "relu",
                                      (1, 1), (0, 0))
        (o.float() * torch.from_numpy(cot)).sum().backward()
    finally:
        jflags.set_flags(prev)
        tflags.set_flags(tprev)
    assert o.dtype == torch.float16
    close(o, jo, "out")
    close(so, jso, "sum", scale=float(np.sqrt(128 * _np(jsso).max())))
    close(sso, jsso, "sumsq", scale=float(_np(jsso).max()))
    for name, t, r in zip(("du", "dgamma", "dbeta", "dw"), (tu, tg, tb, tw),
                          jgrads):
        close(t.grad, r, name, scale=float(np.abs(_np(r)).max()))


# -- the CUDA argument checks -------------------------------------------------

def test_cuda_argument_checks_take_float16_and_refuse_other_types():
    """``kernel_arg_error`` (K1-K3), ``_kernel_arg_error`` (K4) and the conv
    ``_check`` (K5-K9) admit float16 as they admit bf16 and float32, and
    still refuse float64 and integer types, before any launch."""
    q = torch.zeros(1, 16, 2, 64)
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        t = q.to(dt)
        assert hfa.kernel_arg_error(t, t, t) is None
        assert hfp._kernel_arg_error(t, t, t, (None, None, None)) is None
        assert hfp._kernel_arg_error(t, t, t, (None, None, None), t) is None
        hc._check("K5", torch.zeros(1, 2, 2, 8, dtype=dt),
                  (("wt", torch.zeros(1, 8, 4, dtype=dt)),), None, None)
    assert hfa._DTYPE_CODE[torch.float16] == hc._DTYPE_CODE[torch.float16]
    for dt in (torch.float64, torch.int32, torch.int64):
        t = q.to(dt)
        assert "is not float32, bfloat16 or float16" in \
            hfa.kernel_arg_error(t, t, t)
        assert "is not float32, bfloat16 or float16" in \
            hfp._kernel_arg_error(t, t, t, (None, None, None))
        with pytest.raises(ValueError, match="not float32, bfloat16 or "
                                             "float16"):
            hc._check("K5", torch.zeros(1, 2, 2, 8, dtype=dt),
                      (("wt", torch.zeros(1, 8, 4, dtype=dt)),), None, None)
