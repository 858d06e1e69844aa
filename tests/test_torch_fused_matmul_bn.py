"""Port parity: K9, ``fused_matmul_bn_act``, against the JAX package's.

The port's plain version (what a CPU tensor runs) and its backward are held
against ``paddle_tpu.ops._pallas.fused_matmul_bn.fused_matmul_bn_act``
under ``jax.vjp``, on the same numpy inputs and cotangents:

- where the pinned ``block_m`` divides M, with the Pallas kernel run in
  interpret mode on the CPU (every prologue, stats on and off, f32 and
  bf16);
- at every M, M = 600 included, against the jnp expression of the same
  function (the Pallas ``_fwd`` leaves the rows past the last whole
  ``block_m`` block unwritten; the port computes them).

Tolerances: y and dx within 1e-5 + 1e-5·|ref| in f32 and 2e-2 + 2e-2·|ref|
in bf16 (one bf16 rounding apart at most); the sums over M (the stats, dw,
dscale and dshift) within 2e-5·max|ref| in f32 and 2e-2·max|ref| in bf16
(the same terms summed in another order, cancelling in a few entries).
"""

import contextlib
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jfmb = importlib.import_module("paddle_tpu.ops._pallas.fused_matmul_bn")
tfmb = importlib.import_module(
    "paddle_tpu_torch.ops._hopper.fused_matmul_bn")

PROLOGUES = ("none", "scale_shift", "scale_shift_relu")
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@contextlib.contextmanager
def interpreted():
    """The JAX package's Pallas calls in interpret mode on the CPU."""
    pl = jfmb.pl
    orig = pl.pallas_call

    def call(kernel, *args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(kernel, *args, **kwargs)

    pl.pallas_call = call
    try:
        yield
    finally:
        pl.pallas_call = orig


def inputs(m, cin, cout, seed):
    rng = np.random.default_rng(seed)
    return dict(x=rng.standard_normal((m, cin)).astype(np.float32),
                w=(rng.standard_normal((cin, cout)) / np.sqrt(cin)
                   ).astype(np.float32),
                scale=rng.uniform(0.5, 1.5, cin).astype(np.float32),
                shift=rng.uniform(-0.5, 0.5, cin).astype(np.float32),
                dy=rng.standard_normal((m, cout)).astype(np.float32),
                ds=rng.standard_normal(cout).astype(np.float32),
                dss=(0.1 * rng.standard_normal(cout)).astype(np.float32))


def jnp_expression(x, w, scale, shift, prologue, stats, block_m):
    """The function ``_fwd`` computes, in jnp, for every row."""
    xb = x
    if prologue != "none":
        xb = x * scale.astype(x.dtype) + shift.astype(x.dtype)
        if prologue == "scale_shift_relu":
            xb = jnp.maximum(xb, 0)
    acc = jax.lax.dot_general(xb, w, (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.float32)
    return acc.astype(x.dtype), jnp.sum(acc, 0), jnp.sum(acc * acc, 0)


def run_jax(fn, d, dt, prologue, stats, block_m, cts=True):
    """JAX's outputs and its VJP at cotangents (dy, ds, dss), or (dy, 0, 0)
    with ``cts=False``."""
    jdt = DTYPES[dt][0]
    x, w = jnp.asarray(d["x"], jdt), jnp.asarray(d["w"], jdt)
    scale, shift = jnp.asarray(d["scale"]), jnp.asarray(d["shift"])
    out, vjp = jax.vjp(lambda *a: fn(*a, prologue, stats, block_m),
                       x, w, scale, shift)
    dy = jnp.asarray(d["dy"], jdt)
    zeros = jnp.zeros_like(out[1])
    ct = (dy, jnp.asarray(d["ds"]) if cts else zeros,
          jnp.asarray(d["dss"]) if cts else zeros)
    grads = vjp(ct)
    return [np.asarray(jnp.asarray(t, jnp.float32)) for t in (*out, *grads)]


def run_port(d, dt, prologue, stats, block_m, cts=True):
    tdt = DTYPES[dt][1]
    x = torch.tensor(d["x"]).to(tdt).requires_grad_()
    w = torch.tensor(d["w"]).to(tdt).requires_grad_()
    scale = torch.tensor(d["scale"]).requires_grad_()
    shift = torch.tensor(d["shift"]).requires_grad_()
    y, s, ss = tfmb.fused_matmul_bn_act(x, w, scale, shift, prologue, stats,
                                        block_m)
    loss = (y.float() * torch.tensor(d["dy"]).to(tdt).float()).sum()
    if cts:   # the stats' cotangents flow only when asked
        loss = loss + (s * torch.tensor(d["ds"])).sum() + \
            (ss * torch.tensor(d["dss"])).sum()
    loss.backward()

    def f(t):
        return None if t is None else t.detach().float().numpy()
    return [f(y), f(s), f(ss), f(x.grad), f(w.grad), f(scale.grad),
            f(shift.grad)]


NAMES = ("y", "sum", "sumsq", "dx", "dw", "dscale", "dshift")


def hold(got, ref, dt, stats, prologue):
    for name, g, r in zip(NAMES, got, ref):
        if name in ("sum", "sumsq") and not stats:
            continue    # JAX leaves them unwritten; the port gives zeros
        if name in ("dscale", "dshift") and prologue == "none":
            assert g is None, name
            continue
        assert np.isfinite(g).all(), name
        if name in ("sum", "sumsq", "dw", "dscale", "dshift"):
            tol = (2e-5 if dt == "f32" else 2e-2) * np.abs(r).max()
            np.testing.assert_allclose(g, r, rtol=0, atol=tol, err_msg=name)
        else:
            t = 1e-5 if dt == "f32" else 2e-2
            np.testing.assert_allclose(g, r, rtol=t, atol=t, err_msg=name)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("stats", [True, False])
@pytest.mark.parametrize("prologue", PROLOGUES)
def test_plain_k9_and_backward_match_pallas_vjp(prologue, stats, dt):
    """M = 256 at ``block_m = 128``: two whole row blocks, so the Pallas
    kernel writes every row."""
    d = inputs(256, 48, 40, seed=7)
    with interpreted():
        ref = run_jax(jfmb.fused_matmul_bn_act, d, dt, prologue, stats, 128)
    hold(run_port(d, dt, prologue, stats, 128), ref, dt, stats, prologue)


def _jnp_fn():
    """``fused_matmul_bn_act`` with ``_fwd`` replaced by the jnp expression
    of the same function (the JAX VJP rules unchanged)."""
    fn = jax.custom_vjp(jnp_expression, nondiff_argnums=(4, 5, 6))

    def fwd(x, w, scale, shift, prologue, stats, block_m):
        return (jnp_expression(x, w, scale, shift, prologue, stats, block_m),
                (x, w, scale, shift))
    fn.defvjp(fwd, jfmb._vjp_bwd)
    return fn


@pytest.mark.parametrize("m", [600, 77])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("prologue", PROLOGUES)
def test_every_row_at_a_ragged_m_matches_the_jnp_expression(prologue, dt,
                                                             m):
    """M that 512 does not divide: every row of y is finite and equals the
    function the docstring states, and so do the gradients."""
    d = inputs(m, 24, 32, seed=11)
    ref = run_jax(_jnp_fn(), d, dt, prologue, True, 512)
    got = run_port(d, dt, prologue, True, 512)
    assert got[0].shape == (m, 32)
    hold(got, ref, dt, True, prologue)


@pytest.mark.parametrize("prologue", PROLOGUES)
def test_stats_cotangents_that_do_not_flow_count_as_zeros(prologue):
    """JAX hands its VJP zeros for unused stats; the port's None gives the
    same gradients."""
    d = inputs(256, 16, 24, seed=3)
    with interpreted():
        ref = run_jax(jfmb.fused_matmul_bn_act, d, "f32", prologue, True,
                      128, cts=False)
    hold(run_port(d, "f32", prologue, True, 128, cts=False), ref, "f32",
         True, prologue)


def test_block_m_changes_nothing_and_the_cpu_launches_no_kernel():
    d = inputs(300, 16, 8, seed=5)
    x, w = torch.tensor(d["x"]), torch.tensor(d["w"])
    sc, sh = torch.tensor(d["scale"]), torch.tensor(d["shift"])
    before = tfmb.fused_matmul_bn_fwd.launches
    outs = [tfmb.fused_matmul_bn_act(x, w, sc, sh, block_m=bm)
            for bm in (64, 512, 4096)]
    for o in outs[1:]:
        for a, b in zip(o, outs[0]):
            assert torch.equal(a, b)
    assert tfmb.fused_matmul_bn_fwd.launches == before


def test_k9_refuses_what_jax_refuses():
    x = torch.zeros(8, 4)
    sc = torch.ones(4)
    with pytest.raises(ValueError, match="dtypes differ"):
        tfmb.fused_matmul_bn_act(x, torch.zeros(4, 3, dtype=torch.bfloat16),
                                 sc, sc)
    with pytest.raises(ValueError, match="prologue"):
        tfmb.fused_matmul_bn_act(x, torch.zeros(4, 3), sc, sc,
                                 prologue="relu")
    with pytest.raises(ValueError, match="w \\[Cin, Cout\\]"):
        tfmb.fused_matmul_bn_act(x, torch.zeros(5, 3), sc, sc)
    with pytest.raises(ValueError, match="scale must be"):
        tfmb.fused_matmul_bn_act(x, torch.zeros(4, 3), None, None)
