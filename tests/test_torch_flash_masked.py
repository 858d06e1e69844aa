"""Port parity: K1-K3 with segment ids and the key bias.

The plain PyTorch K1 (``flash_fwd_reference``) and K2/K3
(``flash_bwd_reference``) take the TPU kernels' masks: segment ids
``[B, Sq]``/``[B, Sk]`` and an f32 key bias ``[B, Sk]``, applied after the
causal mask in ``_fwd_kernel``'s, ``_bwd_dq_kernel``'s and
``_bwd_dkv_kernel``'s order. They are held against the JAX Pallas ``_fwd``
and ``_bwd`` run in interpret mode on the CPU (segments repeated over heads
as ``flash_attention_pallas`` repeats them), in o, lse, dq, dk and dv, f32
within 1e-5 + 1e-5·|ref|. Then the public entries that reach them:
``scaled_dot_product_attention`` and ``nn.MultiHeadAttention`` at head dim
128 with a key-padding mask (bool and float) against the JAX functions, in
output and gradients, and ``flash_attention_hopper`` at HK < H. The CUDA
kernels run only on a GPU (``chip_smoke.py``'s ``kernel_masked`` phase holds
them against these plain versions there).
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.core import flags as jflags
from paddle_tpu.framework.functional import functional_call, get_params
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch.convert import from_jax_state_dict, to_jax_state_dict
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.nn import MultiHeadAttention

from test_torch_flash_attention import interpreted_pallas

hfa = importlib.import_module("paddle_tpu_torch.ops._hopper.flash_attention")
TF = importlib.import_module("paddle_tpu_torch.nn.functional")

TOL = dict(atol=1e-5, rtol=1e-5)
PAD_Q, PAD_K = -1, -2   # pad sentinels: a pad query sees no key at all


def _segments(rng, b, s, pad_from, sentinel):
    """Sorted document ids 0..2 per batch row, ``sentinel`` from
    ``pad_from[b]`` on."""
    ids = np.sort(rng.integers(0, 3, (b, s)), axis=1).astype(np.int32)
    for i, start in enumerate(pad_from):
        ids[i, start:] = sentinel
    return ids


def _bias(rng, b, sk, kind):
    """A finite bias (padding at -1e9 plus noise) or one with -inf at a
    few keys of every batch row."""
    bias = rng.standard_normal((b, sk)).astype(np.float32)
    if kind == "finite":
        bias[:, sk * 3 // 4:] = -1e9
    else:
        bias[:, ::7] = -np.inf
    return bias


# (b, sq, sk, h, hk, d, causal, segments, bias)
CASES = {
    "segments_pad_sentinel": (2, 256, 256, 2, 2, 128, False, True, None),
    "segments_causal": (2, 256, 256, 2, 2, 128, True, True, None),
    "segments_gqa_causal": (1, 256, 256, 4, 2, 128, True, True, None),
    "finite_bias": (2, 128, 128, 2, 2, 128, False, False, "finite"),
    "finite_bias_gqa_causal": (2, 128, 256, 4, 1, 128, True, False,
                               "finite"),
    "neg_inf_bias": (1, 256, 256, 2, 2, 128, False, False, "-inf"),
    "neg_inf_bias_causal_gqa": (1, 128, 128, 4, 2, 128, True, False,
                                "-inf"),
    "segments_and_bias": (2, 128, 128, 2, 2, 128, False, True, "finite"),
    "segments_bias_causal_d64": (2, 256, 256, 2, 2, 64, True, True, "-inf"),
    "sq_lt_sk_segments_k": (2, 128, 256, 2, 1, 128, False, True, "finite"),
}


def _case_inputs(case, seed=0):
    b, sq, sk, h, hk, d, causal, segmented, bias_kind = CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hk, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hk, d)).astype(np.float32)
    do = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    seg_q = seg_k = bias = None
    if segmented:
        # batch row 0 pads its last 32 queries and keys with sentinels
        # that match nothing: those queries see no valid key
        seg_q = _segments(rng, b, sq, [sq - 32] + [sq] * (b - 1), PAD_Q)
        seg_k = _segments(rng, b, sk, [sk - 32] + [sk] * (b - 1), PAD_K)
        if sq == sk and case != "segments_pad_sentinel":
            seg_k = seg_q.copy()
    if bias_kind is not None:
        bias = _bias(rng, b, sk, bias_kind)
    return q, k, v, do, seg_q, seg_k, bias


def _jax_fwd_bwd(case, q, k, v, do, seg_q, seg_k, bias):
    """``_fwd`` then ``_bwd`` of the JAX package in interpret mode, with
    the segments repeated per head as ``flash_attention_pallas`` makes
    them (``:955-969``) and the bias as ``[B, 1, Sk]``."""
    b, sq, sk, h, hk, d, causal, _, _ = CASES[case]
    scale = 1.0 / math.sqrt(d)

    def bhsd(x, s, heads):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * heads, s, d)

    def per_head(seg, s):
        if seg is None:
            return None
        return jnp.repeat(jnp.asarray(seg)[:, None, :], h,
                          axis=1).reshape(b * h, 1, s)

    jbias = None if bias is None else jnp.asarray(bias).reshape(b, 1, sk)
    with interpreted_pallas() as fa:
        jq, jk, jv, jdo = (bhsd(q, sq, h), bhsd(k, sk, hk), bhsd(v, sk, hk),
                           bhsd(do, sq, h))
        args = dict(seg_q=per_head(seg_q, sq), seg_k=per_head(seg_k, sk),
                    bias=jbias)
        jo, jlse = fa._fwd(jq, jk, jv, scale, causal, 128, 128, h, **args)
        jdq, jdk, jdv = fa._bwd(jq, jk, jv, jo, jlse, jdo, scale, causal,
                                128, 128, h, **args)

    def unflat(x, s, heads):
        x = np.array(jnp.asarray(x).astype(jnp.float32))
        return x.reshape(b, heads, s, d).transpose(0, 2, 1, 3)

    return (unflat(jo, sq, h), np.asarray(jlse).reshape(b, h, sq),
            unflat(jdq, sq, h), unflat(jdk, sk, hk), unflat(jdv, sk, hk))


def _port_masks(seg_q, seg_k, bias):
    return tuple(None if x is None else torch.from_numpy(x)
                 for x in (seg_q, seg_k, bias))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_k1_k3_with_masks_match_pallas(case):
    """K1's and K2/K3's plain versions with segments and the key bias
    against ``_fwd`` and ``_bwd`` in interpret mode: o, lse, dq, dk, dv in
    f32 within 1e-5 + 1e-5·|ref|. The backward takes JAX's own o and lse,
    so each kernel is held on its own inputs. Rows with no valid key give
    o = 0, lse = NEG_INF + log(1e-30) and dq = 0 on both sides; a -inf bias
    gives no NaN."""
    b, sq, sk, h, hk, d, causal, _, _ = CASES[case]
    q, k, v, do, seg_q, seg_k, bias = _case_inputs(case)
    jo, jlse, jdq, jdk, jdv = _jax_fwd_bwd(case, q, k, v, do, seg_q, seg_k,
                                           bias)
    masks = _port_masks(seg_q, seg_k, bias)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    to, tlse = hfa.flash_fwd_reference(tq, tk, tv, causal, masks=masks)
    assert torch.isfinite(to).all() and torch.isfinite(tlse).all()
    np.testing.assert_allclose(to.numpy(), jo, **TOL)
    np.testing.assert_allclose(tlse.numpy(), jlse, **TOL)
    tdq, tdk, tdv = hfa.flash_bwd(
        tq, tk, tv, torch.from_numpy(jo), torch.from_numpy(jlse), tdo, causal,
        masks=masks)
    for got, want in ((tdq, jdq), (tdk, jdk), (tdv, jdv)):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    if seg_q is not None and case == "segments_pad_sentinel":
        # batch row 0's last 32 queries are pad: no valid key
        assert np.all(to[0, sq - 32:].numpy() == 0)
        assert np.all(tlse[0, :, sq - 32:].numpy() ==
                      np.float32(hfa.NEG_INF + math.log(1e-30)))
        assert np.all(tdq[0, sq - 32:].numpy() == 0)


def test_masks_through_autograd_match_the_plain_backward():
    """``flash_fwd`` with masks is differentiable in q, k and v through
    ``flash_bwd`` with the same masks; the key bias gets no gradient."""
    case = "segments_and_bias"
    q, k, v, do, seg_q, seg_k, bias = _case_inputs(case, seed=3)
    masks = _port_masks(seg_q, seg_k, bias)
    masks = (masks[0], masks[1], masks[2].requires_grad_())
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o, lse = hfa.flash_fwd(tq, tk, tv, masks=masks)
    o.backward(torch.from_numpy(do))
    want = hfa.flash_bwd_reference(tq.detach(), tk.detach(), tv.detach(),
                                   o.detach(), lse, torch.from_numpy(do),
                                   masks=masks)
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        assert torch.equal(got, ref)
    assert masks[2].grad is None


def test_flash_attention_hopper_takes_masks_at_hk_lt_h():
    """The K1 route of ``flash_attention_hopper`` (head dim 128, 4 query
    heads over 2 KV heads) no longer raises on segment ids or a key bias:
    it matches ``flash_attention_pallas`` in interpret mode, output within
    1e-5 + 1e-5·|ref|, and so do the gradients of q, k and v."""
    from paddle_tpu.ops._pallas import flash_attention as jfp
    case = "segments_gqa_causal"
    q, k, v, do, seg_q, _, _ = _case_inputs(case, seed=5)
    rng = np.random.default_rng(6)
    bias = _bias(rng, 1, 256, "finite")

    def jloss(q_, k_, v_):
        o = jfp.flash_attention_pallas(
            q_, k_, v_, causal=True, segment_ids=jnp.asarray(seg_q),
            key_bias=jnp.asarray(bias), block_q=128, block_k=128)
        return jnp.sum(o * jnp.asarray(do)), o

    with interpreted_pallas():
        (_, want), grads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                              has_aux=True)(
            *(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = hfa.flash_attention_hopper(tq, tk, tv, causal=True,
                                     segment_ids=torch.from_numpy(seg_q),
                                     key_bias=torch.from_numpy(bias))
    (got * torch.from_numpy(do)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for g, w in zip((tq.grad, tk.grad, tv.grad), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_mask_arguments_are_checked():
    """Wrong shapes raise as ``per_head`` raises; the kernel's argument
    check refuses masks it does not take, before any launch."""
    z = torch.zeros
    q = z(1, 128, 2, 128)
    with pytest.raises(ValueError, match=r"segment_ids must be"):
        hfa.flash_attention_hopper(q, q, q,
                                   segment_ids=z(1, 64, dtype=torch.int32))
    with pytest.raises(ValueError, match="segment_ids_k required"):
        hfa.flash_attention_hopper(q, z(1, 256, 2, 128), z(1, 256, 2, 128),
                                   segment_ids=z(1, 128, dtype=torch.int32))
    with pytest.raises(ValueError, match="key_bias"):
        hfa.flash_attention_hopper(q, q, q, key_bias=z(1, 64))
    seg = z(1, 128, dtype=torch.int32)
    assert hfa.kernel_arg_error(q, q, q, (seg, seg, z(1, 128))) is None
    assert "both seg_q and seg_k" in hfa.kernel_arg_error(
        q, q, q, (seg, None, None))
    assert "seg_q must be dense" in hfa.kernel_arg_error(
        q, q, q, (seg.long(), seg, None))
    assert "key_bias must be dense" in hfa.kernel_arg_error(
        q, q, q, (None, None, z(1, 128, dtype=torch.float64)))
    strided = z(1, 256)[:, ::2]
    assert "key_bias must be dense" in hfa.kernel_arg_error(
        q, q, q, (None, None, strided))


# -- the public entries at head dim 128 ---------------------------------------

B, S, H, D = 2, 128, 2, 128
LENGTHS = np.array([96, 128])


def _key_masks():
    """A bool key-padding mask ``[B, 1, 1, S]`` and the float mask BERT
    makes from it."""
    att = (np.arange(S)[None, :] < LENGTHS[:, None])[:, None, None, :]
    return att, ((1.0 - att.astype(np.float32)) * -1e9).astype(np.float32)


@pytest.mark.parametrize("kind", ["bool", "float"])
def test_sdpa_d128_key_mask_matches_jax_with_grads(kind, monkeypatch):
    """``scaled_dot_product_attention`` at head dim 128 with a key-padding
    mask rides K1 (segment ids for a bool mask, the key bias for a float
    one; its plain version on the CPU), and matches the JAX function (its
    dense path on the CPU) in output and in the gradients of q, k and v,
    f32 within 1e-5 + 1e-5·|ref|."""
    calls = []
    orig = hfa.flash_fwd_reference

    def spy(*a, **kw):
        calls.append(kw.get("masks"))
        return orig(*a, **kw)

    monkeypatch.setattr(hfa, "flash_fwd_reference", spy)
    rng = np.random.default_rng(8)
    q, k, v, w = (rng.standard_normal((B, S, H, D)).astype(np.float32)
                  for _ in range(4))
    mask = _key_masks()[0 if kind == "bool" else 1]

    def jloss(q_, k_, v_):
        o = JF.scaled_dot_product_attention(q_, k_, v_,
                                            attn_mask=jnp.asarray(mask))
        return jnp.sum(o * jnp.asarray(w)), o

    (_, want), grads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                          has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = TF.scaled_dot_product_attention(tq, tk, tv,
                                          attn_mask=torch.from_numpy(mask))
    (got * torch.from_numpy(w)).sum().backward()
    assert len(calls) == 1
    seg_q, seg_k, bias = calls[0]
    assert (seg_q is not None) == (kind == "bool") == (bias is None)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for g, ref in zip((tq.grad, tk.grad, tv.grad), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), **TOL)


def test_sdpa_d64_key_mask_on_k1_matches_jax():
    """With ``flash_head_pack = 0`` a d=64 input takes K1 too, mask and
    all: output and gradients as the JAX function's, f32 within 1e-5 +
    1e-5·|ref|."""
    rng = np.random.default_rng(9)
    q, k, v, w = (rng.standard_normal((B, 256, H, 64)).astype(np.float32)
                  for _ in range(4))
    att = (np.arange(256)[None, :] < np.array([200, 256])[:, None])
    mask = ((1.0 - att.astype(np.float32)) * -1e9)[:, None, None, :]
    jflags.set_flags({"flash_head_pack": 0})
    tflags.set_flags({"flash_head_pack": 0})
    try:
        def jloss(q_, k_, v_):
            o = JF.scaled_dot_product_attention(q_, k_, v_,
                                                attn_mask=jnp.asarray(mask))
            return jnp.sum(o * jnp.asarray(w)), o

        (_, want), grads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                              has_aux=True)(
            *(jnp.asarray(x) for x in (q, k, v)))
        tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
        got = TF.scaled_dot_product_attention(
            tq, tk, tv, attn_mask=torch.from_numpy(mask))
        assert type(got.grad_fn).__name__ == "_FlashFwdBackward"
        (got * torch.from_numpy(w)).sum().backward()
    finally:
        jflags.set_flags({"flash_head_pack": 1})
        tflags.set_flags({"flash_head_pack": 1})
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for g, ref in zip((tq.grad, tk.grad, tv.grad), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("kind", ["bool", "float"])
def test_multi_head_attention_d128_key_mask_matches_jax(kind):
    """``nn.MultiHeadAttention(256, 2)`` (head dim 128) with a key-padding
    mask against the JAX layer on the same weights: output, input and
    parameter gradients, f32 within 1e-5 + 1e-5·|ref|. The key projection's
    bias has a true gradient of 0 (softmax ignores a constant added to a
    row's scores), so both sides hold rounding noise there: it is held
    within 1e-5 of the key weight's gradient's scale."""
    paddle.seed(4)
    jl = jnn.MultiHeadAttention(H * D, H)
    tl = MultiHeadAttention(H * D, H, device="cpu")
    tl.load_state_dict(from_jax_state_dict(
        {k: np.asarray(v) for k, v in jl.state_dict().items()}), strict=True)
    rng = np.random.default_rng(2)
    x = (0.5 * rng.standard_normal((B, S, H * D))).astype(np.float32)
    dout = rng.standard_normal((B, S, H * D)).astype(np.float32)
    mask = _key_masks()[0 if kind == "bool" else 1]

    def jloss(p, x_):
        return jnp.sum(functional_call(jl, p, x_, x_, x_,
                                       attn_mask=jnp.asarray(mask)) * dout)

    want = np.asarray(jl(jnp.asarray(x), jnp.asarray(x), jnp.asarray(x),
                         attn_mask=jnp.asarray(mask)))
    wg, wx = jax.grad(jloss, argnums=(0, 1))(get_params(jl), jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    got = tl(tx, tx, tx, attn_mask=torch.from_numpy(mask))
    got.backward(torch.from_numpy(dout))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    grads = to_jax_state_dict({n: p.grad for n, p in tl.named_parameters()})
    grads["x"] = tx.grad.numpy()
    wanted = {**{n: np.asarray(g) for n, g in wg.items()}, "x": np.asarray(wx)}
    assert set(grads) == set(wanted)
    for name, g in grads.items():
        if name == "k_proj.bias":
            atol = 1e-5 * float(np.abs(wanted["k_proj.weight"]).max())
            np.testing.assert_allclose(g, wanted[name], atol=atol, rtol=0)
        else:
            np.testing.assert_allclose(g, wanted[name], err_msg=name, **TOL)
