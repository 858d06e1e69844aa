"""Port parity: K1 (flash-attention forward) and the attention helpers.

The plain PyTorch K1 (``flash_fwd_reference``) is held against the JAX
Pallas forward ``_fwd`` run in interpret mode on the CPU, in o and lse, with
the reference's own tolerances (``tests/test_flash_attention.py``: f32 atol
2e-5, bf16 atol and rtol 2e-2). The CUDA kernel itself runs only on a GPU
(``chip_smoke.py`` holds it against this plain version there).
"""

import contextlib
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

# the packages' ops/__init__ re-export a function under the module's name
jfa = importlib.import_module("paddle_tpu.ops.flash_attention")
tfa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
hfa = importlib.import_module("paddle_tpu_torch.ops._hopper.flash_attention")


@contextlib.contextmanager
def interpreted_pallas():
    """Run the JAX package's Pallas kernels in interpret mode on the CPU."""
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


def _inputs(b, sq, sk, h, hk, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hk, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hk, d)).astype(np.float32)
    return q, k, v


def _to_jax(x, dtype):
    return jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)


def _to_torch(x, dtype):
    return torch.from_numpy(x).to(
        torch.bfloat16 if dtype == "bf16" else torch.float32)


# (b, sq, sk, h, hk, d, causal, dtype)
K1_CASES = {
    "f32_noncausal": (1, 256, 256, 2, 2, 64, False, "f32"),
    "f32_causal": (1, 256, 256, 2, 2, 64, True, "f32"),
    "bf16_noncausal": (1, 256, 256, 2, 2, 64, False, "bf16"),
    "bf16_causal": (1, 256, 256, 2, 2, 64, True, "bf16"),
    "gqa_causal": (2, 128, 128, 4, 2, 64, True, "f32"),
    "sq_lt_sk_bottom_right": (1, 128, 256, 2, 2, 64, True, "f32"),
    "fully_masked_rows": (1, 256, 128, 2, 2, 64, True, "f32"),
    "d128_causal": (1, 128, 128, 2, 2, 128, True, "f32"),
}


@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_plain_k1_matches_pallas_fwd(case):
    b, sq, sk, h, hk, d, causal, dtype = K1_CASES[case]
    q, k, v = _inputs(b, sq, sk, h, hk, d)
    scale = 1.0 / math.sqrt(d)

    def bhsd(x, s, heads):
        return _to_jax(x, dtype).transpose(0, 2, 1, 3).reshape(b * heads, s, d)

    with interpreted_pallas() as fa:
        jo, jlse = fa._fwd(bhsd(q, sq, h), bhsd(k, sk, hk), bhsd(v, sk, hk),
                           scale, causal, 128, 128, h)
    jo = np.asarray(jo.astype(jnp.float32)).reshape(b, h, sq, d)
    jo = jo.transpose(0, 2, 1, 3)
    jlse = np.asarray(jlse).reshape(b, h, sq)

    to, tlse = hfa.flash_fwd_reference(_to_torch(q, dtype), _to_torch(k, dtype),
                                       _to_torch(v, dtype), causal, scale)
    assert to.dtype == _to_torch(q, dtype).dtype and tlse.dtype == torch.float32
    tol = dict(atol=2e-2, rtol=2e-2) if dtype == "bf16" else dict(atol=2e-5)
    np.testing.assert_allclose(to.float().numpy(), jo, **tol)
    np.testing.assert_allclose(tlse.numpy(), jlse, **tol)
    if case == "fully_masked_rows":
        # rows 0..127 see no key: o = 0 and lse = NEG_INF, as _finish leaves
        assert np.all(to[:, :sq - sk].numpy() == 0)
        assert np.all(tlse[:, :, :sq - sk].numpy() == np.float32(hfa.NEG_INF))


# The rounding point (K1's repair): bf16, JAX's blocks pinned at 128/128 and
# the plain version's stages at 128 keys round p at the same points.
# (b, sq, sk, h, hk, d, causal, masks, dropout)
ROUNDING_CASES = {
    "causal_s512": (1, 512, 512, 2, 2, 128, True, False, False),
    "noncausal_s512": (1, 512, 512, 2, 2, 128, False, False, False),
    "gqa_causal_s256": (1, 256, 256, 4, 2, 128, True, False, False),
    "segments_bias_s256": (2, 256, 256, 2, 2, 128, False, True, False),
    "dropout_causal_s256": (1, 256, 256, 2, 2, 128, True, False, True),
}


@pytest.mark.parametrize("case", sorted(ROUNDING_CASES))
def test_plain_k1_rounds_p_where_pallas_fwd_rounds(case):
    """``flash_fwd_reference`` at ``key_tile=128`` against ``_fwd`` at
    blocks 128/128 in interpret mode, bf16. Both round p (``p * keep``
    under dropout) to bf16 against the running max of the same 128-key
    stages; only the f32 sums' order differs, which now and then flips a
    rounding. So at least 99.5% of the outputs are equal and max |o -
    o_jax| <= 1e-3. With segments a row sees a few keys, and one flipped p
    moves its o by up to a few bf16 ulps (2.4e-3 at one row here): there
    the bound is 1e-2, as the other bf16 tests hold o. A softmax that
    rounds nothing (the plain version before its repair, here the same
    function in float32) fails: 58-69% equal, and at S = 512 7.8e-3 apart
    causal and 2.0e-3 non-causal."""
    b, sq, sk, h, hk, d, causal, masked, dropped = ROUNDING_CASES[case]
    q, k, v = _inputs(b, sq, sk, h, hk, d, seed=1)
    scale = 1.0 / math.sqrt(d)
    rng = np.random.default_rng(2)
    seg = bias = None
    jargs = {}
    if masked:
        seg = np.sort(rng.integers(0, 3, (b, sq)), axis=1).astype(np.int32)
        bias = rng.standard_normal((b, sk)).astype(np.float32)
        bias[:, sk * 3 // 4:] = -1e9
        per_head = jnp.repeat(jnp.asarray(seg)[:, None, :], h, axis=1)
        jargs = dict(seg_q=per_head.reshape(b * h, 1, sq),
                     seg_k=per_head.reshape(b * h, 1, sk),
                     bias=jnp.asarray(bias).reshape(b, 1, sk))
    drop = hfa.AttnDropout(0.1, 4321) if dropped else None
    if dropped:
        jargs.update(dropout=0.1, seed=jnp.asarray([4321], jnp.int32))

    def bhsd(x, s, heads):
        return _to_jax(x, "bf16").transpose(0, 2, 1, 3).reshape(
            b * heads, s, d)

    with interpreted_pallas() as fa:
        jo, jlse = fa._fwd(bhsd(q, sq, h), bhsd(k, sk, hk), bhsd(v, sk, hk),
                           scale, causal, 128, 128, h, **jargs)
    jo = np.asarray(jo.astype(jnp.float32)).reshape(b, h, sq, d).transpose(
        0, 2, 1, 3)
    jlse = np.asarray(jlse).reshape(b, h, sq)
    masks = tuple(None if x is None else torch.from_numpy(x)
                  for x in (seg, seg, bias))
    tq, tk, tv = (_to_torch(x, "bf16") for x in (q, k, v))
    to, tlse = hfa.flash_fwd_reference(tq, tk, tv, causal, scale, drop,
                                       masks=masks, key_tile=128)
    assert to.dtype == torch.bfloat16
    err = np.abs(to.float().numpy() - jo)
    assert float((err == 0).mean()) >= 0.995
    assert float(err.max()) <= (1e-2 if masked else 1e-3)
    np.testing.assert_allclose(tlse.numpy(), jlse, atol=1e-4, rtol=1e-5)
    # the default stage at head dim 128 is the tensor-core body's, 128 keys
    assert hfa.kernel_key_tile(torch.bfloat16, d) == 128
    assert torch.equal(hfa.flash_fwd_reference(tq, tk, tv, causal, scale,
                                               drop, masks=masks)[0], to)
    unrounded, _ = hfa.flash_fwd_reference(tq.float(), tk.float(),
                                           tv.float(), causal, scale, drop,
                                           masks=masks)
    err = np.abs(unrounded.bfloat16().float().numpy() - jo)
    assert float((err == 0).mean()) < 0.9
    if sq == 512:
        assert float(err.max()) > 1e-3


def test_plain_k1_ragged_lengths_match_dense_reference():
    """Ragged S (not a multiple of any tile) — what the engine's prefill
    buckets give the kernel — against the dense reference attention."""
    q, k, v = _inputs(1, 40, 40, 4, 2, 64, seed=3)
    to, _ = hfa.flash_fwd_reference(*(torch.from_numpy(x) for x in (q, k, v)),
                                    causal=True)
    ref = jfa.reference_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                  causal=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hk", [4, 2])
def test_reference_attention_matches_jax(causal, hk):
    q, k, v = _inputs(2, 24, 40, 4, hk, 16, seed=1)
    got = tfa.reference_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                  causal=causal)
    want = jfa.reference_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                   causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("hk", [4, 1])
def test_single_query_attention_matches_jax(hk):
    q, k, v = _inputs(3, 1, 32, 4, hk, 16, seed=2)
    lengths = np.array([5, 0, 32], np.int32)   # row 1 has no valid key
    got = tfa.single_query_attention(
        *(torch.from_numpy(x) for x in (q, k, v)),
        lengths=torch.from_numpy(lengths))
    want = jfa.single_query_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                      lengths=jnp.asarray(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    assert np.all(got[1].numpy() == 0)
    # no lengths == the last causal row of the dense reference
    got_full = tfa.single_query_attention(
        *(torch.from_numpy(x) for x in (q, k, v)))
    want_full = jfa.reference_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                        causal=True)
    np.testing.assert_allclose(got_full.numpy(), np.asarray(want_full),
                               atol=2e-5)


def test_flash_attention_on_cpu_runs_plain_version_without_launching():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 64, 64, 4, 2, 12))
    hfa.flash_fwd.launches = 0
    out = tfa.flash_attention(q, k, v, causal=True, training=False)
    assert hfa.flash_fwd.launches == 0
    ref = tfa.reference_attention(q, k, v, causal=True)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)


def test_flash_attention_backward_raises_and_dropout_not_ported():
    """The backward runs (K2/K3, here their plain version: gradients in
    ``tests/test_torch_flash_backward.py``); attention-prob dropout in
    training is ported now (``tests/test_torch_dropout.py``): it changes
    the output, its gradients are finite, and eval mode ignores it."""
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _inputs(1, 16, 16, 2, 2, 64))
    out = tfa.flash_attention(q, k, v, causal=True, training=False)
    out.sum().backward()
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))
    assert torch.equal(out, tfa.flash_attention(q, k, v, dropout=0.1,
                                                causal=True, training=False))
    dropped = tfa.flash_attention(q, k, v, dropout=0.5, causal=True,
                                  training=True, fixed_seed_offset=3)
    assert not torch.equal(dropped, out)
    q.grad = k.grad = v.grad = None
    dropped.sum().backward()
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))


def test_kernel_arg_checks():
    """What the CUDA kernel refuses (checked before any launch)."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 8, 8, 2, 2, 64))
    assert hfa.kernel_arg_error(q, k, v) is None
    assert hfa.kernel_arg_error(q.bfloat16(), k.bfloat16(), v.bfloat16()) \
        is None
    q32, k32, v32 = (torch.from_numpy(x) for x in _inputs(1, 8, 8, 2, 2, 32))
    assert "head dim 32" in hfa.kernel_arg_error(q32, k32, v32)
    assert hfa.kernel_arg_error(q.half(), k.half(), v.half()) is None
    assert "float64" in hfa.kernel_arg_error(q.double(), k.double(),
                                             v.double())
    strided = torch.zeros(1, 8, 2, 128)[..., ::2]
    assert "not dense" in hfa.kernel_arg_error(strided, k, v)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        hfa.flash_fwd(q, k[:, :, :1].expand(1, 8, 3, 64).contiguous(),
                      v[:, :, :1].expand(1, 8, 3, 64).contiguous())
