"""Port parity: K4 (flash attention at head dim 64, one key tile) and the
attention routing that reaches it.

The plain PyTorch K4a-direct and K4b-fused (``flash_packed_fwd_reference``
and ``flash_packed_bwd_reference``, behind the port's
``flash_attention_packed``) are held against the JAX
``flash_attention_packed`` run in interpret mode on the CPU: o and the
gradients of ``jax.vjp`` on the same q, k, v and cotangent, and lse against
the packed ``_fwd``. Tolerances: f32 2e-5 on o and lse, 5e-5·max|ref| on
each gradient (float32 sums in another order); bf16 2e-2 absolute plus
2e-2·|ref| (both sides round p and ds to bf16 at the same points, from
float32 sums taken in another order, so a rounding may flip: one bf16 ulp is
2^-7 of the value). Then ``scaled_dot_product_attention``'s routing against
the JAX function (which takes its dense path on the CPU), with spies on the
route each case takes. The CUDA kernels themselves run only on a GPU
(``chip_smoke.py`` holds them against these plain versions there).
"""

import contextlib
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn import functional as JF
from _torch_threads import one_torch_thread  # noqa: F401

hfp = importlib.import_module(
    "paddle_tpu_torch.ops._hopper.flash_attention_packed")
hfa = importlib.import_module("paddle_tpu_torch.ops._hopper.flash_attention")
TF = importlib.import_module("paddle_tpu_torch.nn.functional")


@contextlib.contextmanager
def interpreted_pallas():
    """Run the JAX package's Pallas kernels in interpret mode on the CPU."""
    from paddle_tpu.ops._pallas import flash_attention as fa
    from paddle_tpu.ops._pallas import flash_attention_packed as fp
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    pl.pallas_call = fa.pl.pallas_call = fp.pl.pallas_call = interp_call
    try:
        yield fp
    finally:
        pl.pallas_call = fa.pl.pallas_call = fp.pl.pallas_call = orig


# (b, sq, sk, h, causal, dtype, mask)
CASES = {
    "f32_s256_nomask": (2, 256, 256, 2, False, "f32", None),
    "f32_s256_key_bias": (2, 256, 256, 2, False, "f32", "bias"),
    "f32_s256_segments": (2, 256, 256, 2, False, "f32", "seg"),
    "f32_s128_other_segment_ids_k": (2, 128, 128, 2, False, "f32", "segk"),
    "f32_sq128_sk256_segment_ids_k": (2, 128, 256, 2, False, "f32", "segk"),
    "f32_s256_causal": (2, 256, 256, 2, True, "f32", None),
    "f32_s128_causal_segments_bias": (2, 128, 128, 2, True, "f32",
                                      "seg_bias"),
    "f32_s512_key_bias": (1, 512, 512, 2, False, "f32", "bias"),
    "bf16_s256_nomask": (2, 256, 256, 2, False, "bf16", None),
    "bf16_s256_key_bias": (2, 256, 256, 2, False, "bf16", "bias"),
    "bf16_s128_segments": (2, 128, 128, 2, False, "bf16", "seg"),
    "bf16_s256_causal": (2, 256, 256, 2, True, "bf16", None),
}


def _case_inputs(name):
    """numpy q, k, v, do and the masks of a case (seed 0). Segment ids make
    rows hold up to three segments; ``segk`` gives the keys ids of their
    own (0-2 against 1-3), so that the query rows of segment 3 find no key;
    the key bias
    is bench.py's padding bias on a random length per row plus noise."""
    b, sq, sk, h, causal, dtype, mask = CASES[name]
    rng = np.random.default_rng(0)
    q = rng.standard_normal((b, sq, h, 64)).astype(np.float32)
    k = rng.standard_normal((b, sk, h, 64)).astype(np.float32)
    v = rng.standard_normal((b, sk, h, 64)).astype(np.float32)
    do = rng.standard_normal((b, sq, h, 64)).astype(np.float32)
    seg_q = seg_k = bias = None
    if mask in ("seg", "segk", "seg_bias"):
        seg_q = np.sort(rng.integers(1, 4, (b, sq)), axis=1).astype(np.int32)
        seg_k = seg_q if sq == sk else None
        if mask == "segk":
            seg_k = np.sort(rng.integers(0, 3, (b, sk)), axis=1).astype(
                np.int32)
    if mask in ("bias", "seg_bias"):
        lengths = rng.integers(sk // 4, sk + 1, b)
        pad = np.arange(sk)[None, :] >= lengths[:, None]
        bias = (np.where(pad, -1e9, 0.0) +
                rng.standard_normal((b, sk))).astype(np.float32)
    return (q, k, v, do), (seg_q, seg_k, bias), causal, dtype


def _jdt(dtype):
    return jnp.bfloat16 if dtype == "bf16" else jnp.float32


def _tdt(dtype):
    return torch.bfloat16 if dtype == "bf16" else torch.float32


@pytest.fixture(scope="module")
def pallas_results():
    """Each case's JAX results, computed once for the module: o and the
    ``jax.vjp`` gradients of ``flash_attention_packed``, and lse from the
    packed ``_fwd`` (``[B*H/G, Sq, G]``, unpacked to ``[B, H, Sq]``)."""
    cache = {}

    def get(name):
        if name in cache:
            return cache[name]
        (q, k, v, do), (seg_q, seg_k, bias), causal, dtype = \
            _case_inputs(name)
        b, sq, sk, h = q.shape[0], q.shape[1], k.shape[1], q.shape[2]
        jq, jk, jv, jdo = (jnp.asarray(x, _jdt(dtype)) for x in (q, k, v, do))
        kw = dict(causal=causal, key_bias=bias,
                  segment_ids=seg_q, segment_ids_k=seg_k)
        with interpreted_pallas() as fp:
            o, vjp = jax.vjp(lambda a, b_, c: fp.flash_attention_packed(
                a, b_, c, **kw), jq, jk, jv)
            grads = vjp(jdo)
            g = fp.pack_group(h)

            def packed(x, s):
                return x.reshape(b, s, h // g, g * 64).transpose(
                    0, 2, 1, 3).reshape(b * h // g, s, g * 64)

            _, lse = fp._fwd(
                packed(jq, sq), packed(jk, sk), packed(jv, sk),
                1.0 / math.sqrt(64), causal, 256, 512, g, h,
                None if seg_q is None else jnp.asarray(seg_q)[:, None],
                None if seg_q is None else jnp.asarray(seg_k)[:, None],
                bias=None if bias is None else jnp.asarray(bias)[:, None])
        lse = np.asarray(lse).reshape(b, h // g, sq, g).transpose(
            0, 1, 3, 2).reshape(b, h, sq)
        out = {"o": o, "lse": lse, "dq": grads[0], "dk": grads[1],
               "dv": grads[2]}
        cache[name] = {n: np.asarray(jnp.asarray(x).astype(jnp.float32))
                       for n, x in out.items()}
        return cache[name]

    return get


def _port(name):
    """The port's o (forward through ``flash_attention_packed``), its
    gradients (backward through ``flash_packed_bwd``) and lse."""
    (q, k, v, do), (seg_q, seg_k, bias), causal, dtype = _case_inputs(name)
    tq, tk, tv = (torch.from_numpy(x).to(_tdt(dtype)).requires_grad_()
                  for x in (q, k, v))
    kw = dict(causal=causal,
              segment_ids=None if seg_q is None else torch.from_numpy(seg_q),
              segment_ids_k=None if seg_k is None else torch.from_numpy(seg_k),
              key_bias=None if bias is None else torch.from_numpy(bias))
    o = hfp.flash_attention_packed(tq, tk, tv, **kw)
    o.backward(torch.from_numpy(do).to(_tdt(dtype)))
    masks = hfp._masks(q.shape[0], q.shape[1], k.shape[1], tq.device,
                       kw["segment_ids"], kw["segment_ids_k"], kw["key_bias"])
    _, lse = hfp.flash_packed_fwd(tq.detach(), tk.detach(), tv.detach(),
                                  causal, None, masks)
    return {"o": o, "lse": lse, "dq": tq.grad, "dk": tk.grad, "dv": tv.grad}


def _close(got, want, dtype, what, grad):
    got = got.detach().float().numpy()
    if dtype == "bf16":
        np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2,
                                   err_msg=what)
    else:
        atol = 5e-5 * float(np.abs(want).max()) if grad else 2e-5
        np.testing.assert_allclose(got, want, atol=atol, rtol=0,
                                   err_msg=what)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_k4a_forward_matches_pallas(case, pallas_results):
    want = pallas_results(case)
    got = _port(case)
    dtype = CASES[case][5]
    assert got["o"].dtype == _tdt(dtype) and got["lse"].dtype == torch.float32
    _close(got["o"], want["o"], dtype, f"{case} o", grad=False)
    _close(got["lse"], want["lse"], dtype, f"{case} lse", grad=False)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_k4b_grads_match_pallas_vjp(case, pallas_results):
    want = pallas_results(case)
    got = _port(case)
    for g in ("dq", "dk", "dv"):
        _close(got[g], want[g], CASES[case][5], f"{case} {g}", grad=True)
    if CASES[case][6] == "segk":
        # a query row whose segment id no key has: o = 0 and dq = 0
        (q, _, _, _), (seg_q, seg_k, _), _, _ = _case_inputs(case)
        empty = ~(seg_q[:, :, None] == seg_k[:, None, :]).any(-1)
        assert empty.any()
        assert np.all(got["dq"].numpy()[empty] == 0)
        assert np.all(got["o"].detach().numpy()[empty] == 0)


def test_pack_group_matches_jax():
    from paddle_tpu.ops._pallas.flash_attention_packed import pack_group
    for h in range(1, 33):
        assert hfp.pack_group(h) == pack_group(h), h
    assert hfp.pack_group(12) == 12 and hfp.pack_group(16) == 16


def _spy(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapped)


ROUTE_FUNCS = ((hfp, "flash_packed_fwd_reference"),
               (hfp, "flash_packed_bwd_reference"),
               (hfa, "flash_fwd_reference"), (hfa, "flash_bwd_reference"),
               (TF, "_dense_attention"))


def test_cpu_route_reaches_the_plain_k4_versions(monkeypatch):
    """The autograd function calls K4's plain forward and plain backward
    on CPU tensors: no autograd through the plain forward, no dense
    ``einsum`` path, no K1."""
    calls = []
    for mod, name in ROUTE_FUNCS:
        _spy(monkeypatch, mod, name, calls)
    (q, k, v, do), (_, _, bias), _, _ = _case_inputs("f32_s256_key_bias")
    tq = torch.from_numpy(q).requires_grad_()
    o = hfp.flash_attention_packed(tq, torch.from_numpy(k),
                                   torch.from_numpy(v),
                                   key_bias=torch.from_numpy(bias))
    assert type(o.grad_fn).__name__ == "_FlashPackedBackward"
    o.backward(torch.from_numpy(do))
    assert calls == ["flash_packed_fwd_reference",
                     "flash_packed_bwd_reference"]
    assert tq.grad is not None


def test_k4_wrappers_refuse_what_the_kernels_do_not_take():
    z = torch.zeros
    q64 = z(1, 128, 2, 64)
    with pytest.raises(ValueError, match="d=64 only"):
        hfp.flash_attention_packed(z(1, 128, 2, 128), z(1, 128, 2, 128),
                                   z(1, 128, 2, 128))
    with pytest.raises(ValueError, match="kv heads == query heads"):
        hfp.flash_attention_packed(q64, z(1, 128, 1, 64), z(1, 128, 1, 64))
    with pytest.raises(ValueError, match="no even pack group"):
        hfp.flash_attention_packed(z(1, 128, 3, 64), z(1, 128, 3, 64),
                                   z(1, 128, 3, 64))
    # Sk = 640 spans several of JAX's key tiles: the streamed forms run
    # (their plain versions here), not K4a-direct and K4b-fused
    kv640 = z(1, 640, 2, 64)
    assert hfp.plan(128, 640, 2) == ("stream", "dq", "direct")
    assert hfp.flash_attention_packed(q64, kv640, kv640).shape == q64.shape
    with pytest.raises(ValueError, match="rate must be below 1"):
        hfp.flash_attention_packed(q64, q64, q64, dropout=1.0)
    with pytest.raises(ValueError, match="segment_ids_k required"):
        hfp.flash_attention_packed(q64, z(1, 256, 2, 64), z(1, 256, 2, 64),
                                   segment_ids=z(1, 128, dtype=torch.int32))
    with pytest.raises(ValueError, match=r"segment_ids must be"):
        hfp.flash_attention_packed(q64, q64, q64,
                                   segment_ids=z(1, 64, dtype=torch.int32))
    with pytest.raises(ValueError, match="key_bias"):
        hfp.flash_attention_packed(q64, q64, q64, key_bias=z(1, 64))
    # the kernel launchers take CUDA tensors only, checked before a pointer
    # reaches the kernel; no fall back to the plain version
    with pytest.raises(ValueError, match="CUDA tensors"):
        hfp._launch_fwd(q64, q64, q64, False, 0.125, (None, None, None))
    lse = z(1, 2, 128)
    with pytest.raises(ValueError, match="CUDA tensors"):
        hfp._launch_bwd(q64, q64, q64, q64, lse, lse, False, 0.125,
                        (None, None, None))
    with pytest.raises(ValueError, match="CUDA tensors"):
        hfp._launch_fwd(q64, kv640, kv640, False, 0.125, (None, None, None))


def test_k4a_tensor_core_body_wrapper():
    """K4a-direct's bf16 tensor-core body has its own wrapper and count:
    on the CPU it is the same plain version as ``flash_packed_fwd``; it
    refuses float32 on the card (that is the CUDA-core body's), and both
    launchers refuse CPU tensors before any pointer reaches a kernel."""
    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, 128, 2, 64)).astype(np.float32)).bfloat16() for _ in range(3))
    bias = torch.from_numpy(rng.standard_normal((1, 128)).astype(np.float32))
    masks = (None, None, bias)
    hfp.flash_packed_fwd_tc.launches = hfp.flash_packed_fwd.launches = 0
    got = hfp.flash_packed_fwd_tc(q, k, v, True, None, masks)
    want = hfp.flash_packed_fwd(q, k, v, True, None, masks)
    ref = hfp.flash_packed_fwd_reference(q, k, v, True, None, masks)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert hfp.flash_packed_fwd_tc.launches == 0 == \
        hfp.flash_packed_fwd.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        hfp._launch_fwd(q, k, v, False, 0.125, masks)


# -- scaled_dot_product_attention: routing -----------------------------------

B, S, H = 2, 256, 2   # B != S: a [B, S] mask is a key mask


def _sdpa_inputs(d=64, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, d)).astype(np.float32)
            for _ in range(3)]


def _lengths_mask():
    att = np.arange(S)[None, :] < np.array([200, 256])[:, None]
    return att


SDPA_CASES = {
    # name: (JAX kwargs, route the port takes)
    "no_mask": (lambda: {}, "k4"),
    "float_b11s_mask": (lambda: {"attn_mask": (
        (1.0 - _lengths_mask()[:, None, None, :].astype(np.float32))
        * -1e9).astype(np.float32)}, "k4"),
    # the port takes [B, S]; the JAX dense path reads a 2-D mask as [Sq,
    # Sk], so JAX gets the same key mask as [B, 1, 1, S] (the test gives the
    # port the [B, S] form)
    "bool_bs_mask": (lambda: {"attn_mask": _lengths_mask()[:, None, None]},
                     "k4"),
    "segment_ids": (lambda: {"segment_ids": np.where(
        np.arange(S)[None, :] < 100, 1, 2).repeat(B, 0).astype(np.int32)},
        "k4"),
    "per_query_mask": (lambda: {"attn_mask": np.tril(
        np.ones((S, S), bool))}, "dense"),
    "causal": (lambda: {"is_causal": True}, "k4"),
}


@pytest.mark.parametrize("case", sorted(SDPA_CASES))
def test_sdpa_routes_and_matches_jax(case, monkeypatch):
    """The port's SDPA on the CPU against the JAX function (its dense
    path on the CPU), f32: 2e-5. Spies show the route: K4's plain versions
    where the JAX package would take K4 on a TPU, the dense path for a
    per-query mask; never K1's plain version."""
    make, route = SDPA_CASES[case]
    kw = make()
    q, k, v = _sdpa_inputs()
    want = np.asarray(JF.scaled_dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        **{n: jnp.asarray(x) if isinstance(x, np.ndarray) else x
           for n, x in kw.items()}))
    calls = []
    for mod, name in ROUTE_FUNCS:
        _spy(monkeypatch, mod, name, calls)
    if case == "bool_bs_mask":
        kw = {"attn_mask": _lengths_mask()}
    tq = torch.from_numpy(q).requires_grad_()
    got = TF.scaled_dot_product_attention(
        tq, torch.from_numpy(k), torch.from_numpy(v),
        **{n: torch.from_numpy(x) if isinstance(x, np.ndarray) else x
           for n, x in kw.items()})
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-5,
                               rtol=0)
    got.sum().backward()
    if route == "k4":
        assert calls == ["flash_packed_fwd_reference",
                         "flash_packed_bwd_reference"]
    else:
        assert calls == ["_dense_attention"]


def test_sdpa_bf16_key_bias_matches_jax():
    """bench.py's padded batch under O2: the additive mask made in bf16,
    turned into an f32 key bias only at the kernel entry. bf16: 2e-2."""
    q, k, v = (x.astype(np.float32) for x in _sdpa_inputs(seed=4))
    att = _lengths_mask()
    jmask = (1.0 - jnp.asarray(att)[:, None, None, :].astype(
        jnp.bfloat16)) * -1e9
    want = JF.scaled_dot_product_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), attn_mask=jmask)
    tmask = (1.0 - torch.from_numpy(att)[:, None, None, :].to(
        torch.bfloat16)) * -1e9
    assert tmask.dtype == torch.bfloat16
    got = TF.scaled_dot_product_attention(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
        attn_mask=tmask)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)


def test_sdpa_unsupported_shapes_take_the_dense_path(monkeypatch):
    """S = 200 is no multiple of 128: the JAX package's dense path, and the
    port's, on every device."""
    calls = []
    for mod, name in ROUTE_FUNCS:
        _spy(monkeypatch, mod, name, calls)
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 200, 2, 64)).astype(np.float32)
               for _ in range(3))
    want = JF.scaled_dot_product_attention(*(jnp.asarray(x)
                                             for x in (q, k, v)))
    got = TF.scaled_dot_product_attention(*(torch.from_numpy(x)
                                            for x in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    assert calls == ["_dense_attention"]


def test_sdpa_d128_with_a_key_mask_raises_on_the_kernel_route(monkeypatch):
    """d=128 takes K1, which now takes segment ids and the key bias: a bool
    key mask (as segment ids), a float key mask (as the key bias) and
    ``segment_ids`` all compute on the kernel route (K1's plain version on
    the CPU, never the dense path) and match the JAX function, f32 within
    1e-5 + 1e-5·|ref|; without a mask K1 runs as before."""
    calls = []
    for mod, name in ROUTE_FUNCS:
        _spy(monkeypatch, mod, name, calls)
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (B, S, H, 128)).astype(np.float32)) for _ in range(3))
    att = torch.from_numpy(_lengths_mask())
    fmask = (1.0 - att[:, None, None, :].float()) * -1e9
    seg = torch.ones(B, S, dtype=torch.int32)
    jq, jk, jv = (jnp.asarray(x.numpy()) for x in (q, k, v))
    for kwargs, jkwargs in (
            (dict(attn_mask=att),
             dict(attn_mask=jnp.asarray(att.numpy())[:, None, None, :])),
            (dict(attn_mask=fmask),
             dict(attn_mask=jnp.asarray(fmask.numpy()))),
            (dict(segment_ids=seg), dict(segment_ids=jnp.asarray(
                seg.numpy()))),
            ({}, {})):
        calls.clear()
        want = JF.scaled_dot_product_attention(jq, jk, jv, **jkwargs)
        got = TF.scaled_dot_product_attention(q, k, v, **kwargs)
        assert "_dense_attention" not in calls, kwargs
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)


def test_sdpa_dropout_raises_in_training_and_is_a_no_op_in_eval():
    """Attention dropout is ported now (``tests/test_torch_dropout.py``):
    in training it changes the output; in eval mode it is a no-op."""
    q, k, v = (torch.from_numpy(x) for x in _sdpa_inputs())
    plain = TF.scaled_dot_product_attention(q, k, v)
    assert not torch.equal(
        TF.scaled_dot_product_attention(q, k, v, dropout_p=0.1), plain)
    got = TF.scaled_dot_product_attention(q, k, v, dropout_p=0.1,
                                          training=False)
    assert torch.equal(got, plain)


def test_as_key_mask_matches_jax():
    """Every shape rule of ``_as_key_mask``, including the ``(b, sk)``
    mask with ``b == sq``, which is ambiguous and takes the dense path."""
    from paddle_tpu.nn.functional import _as_key_mask as jax_key_mask
    rng = np.random.default_rng(7)
    for shape, (b, sq, sk) in [((2, 1, 1, 8), (2, 6, 8)),
                               ((1, 1, 1, 8), (2, 6, 8)),
                               ((2, 1, 8), (2, 6, 8)),
                               ((2, 8), (2, 6, 8)), ((1, 8), (2, 6, 8)),
                               ((6, 8), (6, 6, 8)), ((2, 1, 6, 8), (2, 6, 8)),
                               ((6, 8), (2, 6, 8))]:
        m = rng.standard_normal(shape).astype(np.float32)
        want = jax_key_mask(jnp.asarray(m), b, sq, sk)
        got = TF._as_key_mask(torch.from_numpy(m), b, sq, sk)
        assert (want is None) == (got is None), shape
        if want is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
