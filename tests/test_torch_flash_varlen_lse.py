"""Port parity: ``ops.flash_attn_unpadded`` and
``ops._hopper.flash_attention.flash_attention_with_lse`` against the JAX
package's functions of those names.

On the CPU JAX's ``_use_pallas`` is false, so JAX itself takes
``flash_attn_unpadded``'s padded dense fallback there. The fast path is
forced from the test side (``_use_pallas`` patched true) with JAX's Pallas
kernels run in interpret mode, and both JAX paths are held against the
port's, whose fast path runs K1-K3's plain versions over the packed row
with per-side segment ids. ``flash_attention_with_lse`` runs the Pallas
``_fwd``/``_bwd`` in interpret mode on the JAX side, the lse cotangent
folded into delta on both. Float32: o, lse and gradients within 2e-5 +
2e-5·|ref| (the kernels' block sums against K1's plain version).
"""

import contextlib
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

jfa = importlib.import_module("paddle_tpu.ops.flash_attention")
tfa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
hfa = importlib.import_module("paddle_tpu_torch.ops._hopper.flash_attention")
TOL = dict(rtol=2e-5, atol=2e-5)


@contextlib.contextmanager
def interpreted_pallas():
    """The JAX package's Pallas kernels in interpret mode on the CPU."""
    from paddle_tpu.ops._pallas import flash_attention as fa
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    pl.pallas_call = interp_call
    fa.pl.pallas_call = interp_call
    try:
        yield fa
    finally:
        pl.pallas_call = orig
        fa.pl.pallas_call = orig


# name: q lengths, k lengths (None: the q split), packed totals, heads,
# kv heads, head dim, causal
# (the causal packing ends with 16 query and key tokens past cu[-1], the
# cross packing with 6 key tokens past it)
VARLEN = {
    "causal_docs": ([40, 100, 7, 93], None, (256, 256), 2, 2, 128, True),
    "cross_splits": ([30, 90, 8], [100, 20, 130], (128, 256), 2, 1, 128,
                     False),
}


def _varlen(case, seed=0):
    lq, lk, (tq, tk), h, hk, d, causal = VARLEN[case]
    rng = np.random.default_rng(seed)
    cu_q = np.concatenate([[0], np.cumsum(lq)]).astype(np.int32)
    cu_k = cu_q if lk is None else \
        np.concatenate([[0], np.cumsum(lk)]).astype(np.int32)
    q = rng.standard_normal((tq, h, d)).astype(np.float32)
    k = rng.standard_normal((tk, hk, d)).astype(np.float32)
    v = rng.standard_normal((tk, hk, d)).astype(np.float32)
    do = rng.standard_normal((tq, h, d)).astype(np.float32)
    max_q = int(max(lq))
    max_k = int(max(lk or lq))
    return q, k, v, do, cu_q, cu_k, max_q, max_k, causal, lk is None


def _jax_run(case, fast):
    q, k, v, do, cu_q, cu_k, mq, mk, causal, same = _varlen(case)
    jcu_q = jnp.asarray(cu_q)
    jcu_k = jcu_q if same else jnp.asarray(cu_k)

    def f(q, k, v):
        return jfa.flash_attn_unpadded(q, k, v, jcu_q, jcu_k, mq, mk,
                                       causal=causal)

    @jax.jit
    def run(q, k, v):
        o, vjp = jax.vjp(f, q, k, v)
        return (o, *vjp(jnp.asarray(do)))

    args = tuple(jnp.asarray(a) for a in (q, k, v))
    if not fast:
        return tuple(map(np.asarray, run(*args)))
    orig = jfa._use_pallas
    jfa._use_pallas = lambda q, k: True
    try:
        with interpreted_pallas():
            out = tuple(map(np.asarray, run(*args)))
    finally:
        jfa._use_pallas = orig
    return out


def _port_run(case, **kw):
    q, k, v, do, cu_q, cu_k, mq, mk, causal, same = _varlen(case)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tcu_q = torch.from_numpy(cu_q)
    tcu_k = tcu_q if same else torch.from_numpy(cu_k)
    o = tfa.flash_attn_unpadded(tq, tk, tv, tcu_q, tcu_k, mq, mk,
                                causal=causal, **kw)
    (o * torch.from_numpy(do)).sum().backward()
    return tuple(t.detach().numpy() for t in (o, tq.grad, tk.grad, tv.grad))


@pytest.fixture(scope="module")
def jax_varlen():
    return {(case, fast): _jax_run(case, fast) for case in VARLEN
            for fast in (True, False)}


@pytest.mark.parametrize("case", list(VARLEN))
def test_unpadded_fast_path_matches_jax_kernels(case, jax_varlen):
    """The port's kernel route against JAX's Pallas fast path: o, dq, dk,
    dv; padding rows past ``cu[-1]`` come out 0 in both."""
    calls = []
    orig = hfa.flash_fwd_reference

    def spy(*a, **k):
        calls.append(k.get("masks"))
        return orig(*a, **k)

    hfa.flash_fwd_reference = spy
    try:
        got = _port_run(case)
    finally:
        hfa.flash_fwd_reference = orig
    seg_q, seg_k, bias = calls[0]
    assert bias is None and seg_q.shape[0] == 1
    lq, lk, (tq, tk) = VARLEN[case][:3]
    tail = tq - sum(lq)
    assert (seg_q[0] == -1).sum() == tail
    assert (seg_k[0] == -2).sum() == tk - sum(lk or lq)
    for g, w in zip(got, jax_varlen[(case, True)]):
        np.testing.assert_allclose(g, w, **TOL)
    if tail:
        assert np.all(got[0][-tail:] == 0) and np.all(got[1][-tail:] == 0)


@pytest.mark.parametrize("case", list(VARLEN))
def test_unpadded_fallback_matches_jax_fallback(case, jax_varlen):
    """The port's dense fallback (taken here through dropout, which it
    ignores as JAX does) against JAX's fallback, and both JAX paths'
    tokens against each other, on the tokens before ``cu[-1]`` (JAX's
    fallback gathers a clamped row past it)."""
    n = sum(VARLEN[case][0])
    got = _port_run(case, dropout=0.1)
    want = jax_varlen[(case, False)]
    fast = jax_varlen[(case, True)]
    np.testing.assert_allclose(got[0][:n], want[0][:n], **TOL)
    np.testing.assert_allclose(want[0][:n], fast[0][:n], **TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, **TOL)


def test_unpadded_causal_cross_and_off_route_take_the_fallback():
    """Causal with two cu tensors (even equal ones) and a head dim no
    kernel takes go to the dense fallback, as in JAX."""
    q, k, v, do, cu_q, cu_k, mq, mk, causal, _ = _varlen("causal_docs")
    cu = torch.from_numpy(cu_q)
    calls = []
    orig = hfa.flash_fwd_reference
    hfa.flash_fwd_reference = lambda *a, **kw: calls.append(1) or \
        orig(*a, **kw)
    try:
        fast = tfa.flash_attn_unpadded(*(torch.from_numpy(a) for a in
                                         (q, k, v)), cu, cu, mq, mk,
                                       causal=True)
        assert calls == [1]
        slow = tfa.flash_attn_unpadded(*(torch.from_numpy(a) for a in
                                         (q, k, v)), cu, cu.clone(), mq, mk,
                                       causal=True)
        d32 = tfa.flash_attn_unpadded(
            *(torch.from_numpy(a[..., :32].copy()) for a in (q, k, v)), cu,
            cu, mq, mk, causal=True)
        assert calls == [1]
    finally:
        hfa.flash_fwd_reference = orig
    np.testing.assert_allclose(slow.numpy(), fast.numpy(), **TOL)
    jcu = jnp.asarray(cu_q)
    want = jax.jit(lambda q, k, v: jfa.flash_attn_unpadded(
        q, k, v, jcu, jcu, mq, mk, causal=True))(
        *(jnp.asarray(a[..., :32]) for a in (q, k, v)))
    n = int(cu_q[-1])     # JAX's fallback gathers a clamped row past it
    np.testing.assert_allclose(d32.numpy()[:n], np.asarray(want)[:n], **TOL)
    assert np.all(d32.numpy()[n:] == 0)


# --- flash_attention_with_lse ----------------------------------------------

B, S, H, HK, D = 1, 256, 2, 1, 128


def _lse_inputs(seed=1):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, HK, D)).astype(np.float32)
    v = rng.standard_normal((B, S, HK, D)).astype(np.float32)
    co = rng.standard_normal((B, S, H, D)).astype(np.float32)
    cl = rng.standard_normal((B, S, H)).astype(np.float32)
    return q, k, v, co, cl


def _merged(fn, q, k, v, co, cl, lib):
    """Two partials over the two key halves merged by logaddexp; the loss
    reads o and lse, so lse's cotangent is not zero."""
    h = S // 2
    o1, l1 = fn(q, k[:, :h], v[:, :h])
    o2, l2 = fn(q, k[:, h:], v[:, h:])
    lse = lib.logaddexp(l1, l2)
    o = o1 * lib.exp(l1 - lse)[..., None] + o2 * lib.exp(l2 - lse)[..., None]
    return o, lse, (o * co).sum() + (lse * cl).sum()


@pytest.fixture(scope="module")
def jax_lse():
    from paddle_tpu.ops._pallas import flash_attention as fa
    q, k, v, co, cl = (jnp.asarray(a) for a in _lse_inputs())

    @jax.jit
    def run(q, k, v):
        full = fa.flash_attention_with_lse(q, k, v, causal=True)
        (_, (o, lse)), grads = jax.value_and_grad(
            lambda q, k, v: (lambda r: (r[2], r[:2]))(
                _merged(fa.flash_attention_with_lse, q, k, v, co, cl, jnp)),
            argnums=(0, 1, 2), has_aux=True)(q, k, v)
        return full, (o, lse), grads

    with interpreted_pallas():
        full, merged, grads = run(q, k, v)
    return (tuple(map(np.asarray, full)),
            tuple(map(np.asarray, merged[:2])), tuple(map(np.asarray, grads)))


def test_with_lse_matches_jax(jax_lse):
    (jo, jl), (mo, ml), jgrads = jax_lse
    q, k, v, co, cl = _lse_inputs()
    o, lse = hfa.flash_attention_with_lse(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=True)
    assert lse.shape == (B, S, H) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), jo, **TOL)
    np.testing.assert_allclose(lse.numpy(), jl, **TOL)

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o, lse, loss = _merged(hfa.flash_attention_with_lse, tq, tk, tv,
                           torch.from_numpy(co), torch.from_numpy(cl), torch)
    np.testing.assert_allclose(o.detach().numpy(), mo, **TOL)
    np.testing.assert_allclose(lse.detach().numpy(), ml, **TOL)
    loss.backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_with_lse_cotangent_reaches_delta():
    """The merge equals one call over all keys (non-causal), and lse's
    cotangent changes dq and dk (it folds into delta), not dv."""
    q, k, v, co, cl = _lse_inputs(2)

    def grads(with_lse):
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        o, lse = hfa.flash_attention_with_lse(*ts)
        loss = (o * torch.from_numpy(co)).sum()
        if with_lse:
            loss = loss + (lse * torch.from_numpy(cl)).sum()
        loss.backward()
        return [t.grad for t in ts]

    a, b = grads(False), grads(True)
    assert not torch.allclose(a[0], b[0]) and not torch.allclose(a[1], b[1])
    torch.testing.assert_close(a[2], b[2], rtol=0, atol=0)
    full = hfa.flash_attention_with_lse(*(torch.from_numpy(x)
                                          for x in (q, k, v)))
    o, lse, _ = _merged(hfa.flash_attention_with_lse,
                        *(torch.from_numpy(x) for x in (q, k, v, co, cl)),
                        torch)
    np.testing.assert_allclose(o.numpy(), full[0].numpy(), **TOL)
    np.testing.assert_allclose(lse.numpy(), full[1].numpy(), **TOL)


@pytest.mark.parametrize("shape,kv_heads,blocks", [
    ((1, 200, 2, 256), 2, {}),              # 200 past d=256's 128 block
    ((1, 256, 2, 128), 2, dict(block_q=96)),
    ((1, 128, 3, 64), 2, {}),               # 3 heads over 2 kv heads
])
def test_with_lse_raises_where_jax_raises(shape, kv_heads, blocks):
    from paddle_tpu.ops._pallas import flash_attention as fa
    b, s, h, d = shape
    q = np.zeros(shape, np.float32)
    kv = np.zeros((b, s, kv_heads, d), np.float32)
    with pytest.raises(ValueError):
        fa.flash_attention_with_lse(jnp.asarray(q), jnp.asarray(kv),
                                    jnp.asarray(kv), **blocks)
    with pytest.raises(ValueError):
        hfa.flash_attention_with_lse(torch.from_numpy(q),
                                     torch.from_numpy(kv),
                                     torch.from_numpy(kv), **blocks)
