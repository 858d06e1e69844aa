"""Port parity: dropout — the attention-prob mask of K1-K4, the kernels'
plain versions with it, hidden dropout, the key streams, and the models
that train with both — against the JAX package.

- The mask: the port's ``dropout_keep_dense`` is bit-equal to JAX's, and
  its heads numbered from a ``first_head`` past 0 to ``_dropout_keepf``'s
  tiles where the flat index wraps past 2^32 (exact).
- K1-K3's plain versions with dropout against the Pallas ``_fwd``/``_bwd``
  in interpret mode, an explicit seed on both sides; K4's six bodies through
  ``flash_attention_packed`` under ``jax.vjp`` (spies show the port ran the
  counterpart of each body JAX ran). Tolerances as the dropout-free tests
  hold them: f32 o and lse within 2e-5, gradients within 5e-5·max|ref|
  (the same sums in another tile order; K1's o within 1e-4 at |o| up to
  ~10, since a kept p is scaled by 1/0.9); bf16 within 2e-2 + 2e-2·|ref|.
- Hidden dropout: the draw is pinned on both sides (the same numpy masks
  handed to ``jax.random.bernoulli`` and to the port's ``_keep_mask``,
  in the tests only), so the layers compare exactly as without dropout;
  the port's own draws are held to binomial bounds and to ``(seed,
  step_count)``.
- GPT, BERT and ERNIE at attention dropout 0.1 with the seed draws pinned
  on both sides (``randint`` on the JAX side, ``draw_seed`` on the port's):
  GPT against the JAX dense mirror (its CPU route; the port's is the
  kernels' plain versions), BERT and ERNIE against
  the JAX models forced onto ``flash_attention_pallas`` in interpret mode.
"""

import contextlib
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.functional import functional_call, get_params
from paddle_tpu_torch.convert import from_jax_state_dict, to_jax_state_dict

from test_torch_flash_stream import COUNTERPART, jax_pallas, port_forms
from _torch_threads import one_torch_thread  # noqa: F401

jfa = importlib.import_module("paddle_tpu.ops._pallas.flash_attention")
jops = importlib.import_module("paddle_tpu.ops.flash_attention")
hfa = importlib.import_module("paddle_tpu_torch.ops._hopper.flash_attention")
hfp = importlib.import_module(
    "paddle_tpu_torch.ops._hopper.flash_attention_packed")
tops = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
TF = importlib.import_module("paddle_tpu_torch.nn.functional")
trandom = importlib.import_module("paddle_tpu_torch.core.random")


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(x, dtype="f32"):
    return torch.from_numpy(np.array(x, np.float32)).to(
        torch.bfloat16 if dtype == "bf16" else torch.float32)


def _j(x, dtype="f32"):
    return jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)


def _close(got, want, dtype, what, grad=False, atol=2e-5):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    if dtype == "bf16":
        np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2,
                                   err_msg=what)
    else:
        tol = 5e-5 * float(np.abs(want).max()) if grad else atol
        np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=what)


# -- the mask -----------------------------------------------------------------

MASK_CASES = [(3, 5, 7, 123, 0.1), (2, 128, 64, -5, 0.5),
              (4, 33, 129, 2 ** 31 - 2, 0.9), (1, 16, 16, 0, 1e-12),
              (24, 64, 64, 987654, 0.1)]


@pytest.mark.parametrize("bh,sq,sk,seed,rate", MASK_CASES)
def test_dropout_keep_dense_is_bit_equal_to_jax(bh, sq, sk, seed, rate):
    want = np.asarray(jfa.dropout_keep_dense(bh, sq, sk, jnp.int32(seed),
                                             rate))
    got = hfa.dropout_keep_dense(bh, sq, sk, seed, rate).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("bh,qi,kj", [(1000, 20, 31), (1100, 31, 0),
                                      (4095, 3, 2)])
def test_tile_function_matches_jax_where_the_flat_index_wraps(bh, qi, kj):
    """At Sq = Sk = 4096 the flat index (bh·Sq + q)·Sk + k passes 2^32 from
    bh = 256 on: the uint32 arithmetic wraps on both sides alike. The
    port's mask of head ``bh`` (``first_head=bh``, as the plain versions
    number a slice of a larger batch) holds JAX's tile ``(qi, kj)``."""
    assert (bh * 4096 + qi * 128) * 4096 > 2 ** 32
    want = np.asarray(jfa._dropout_keepf((128, 128), bh, qi, kj, 128, 128,
                                         4096, 4096, jnp.int32(77), 0.1))
    dense = hfa.dropout_keep_dense(1, 4096, 4096, 77, 0.1,
                                   first_head=bh).numpy()
    assert np.array_equal(dense[0, qi * 128:(qi + 1) * 128,
                                kj * 128:(kj + 1) * 128], want)


def test_flat_head_and_the_host_constants_match_jax():
    """JAX's K4 hashes a packed head by ``_flat_head``; the port's K4
    kernels, which do not pack, hash head ``head`` of batch ``b`` by ``b*H +
    head``: the same row for the same head."""
    from paddle_tpu.ops._pallas import flash_attention_packed as jfp
    for bg, hg, g_pack, h, num_heads in [(0, 1, 2, 1, 2), (5, 2, 16, 3, 32),
                                         (7, 3, 4, 2, 12)]:
        b, head = bg // hg, (bg % hg) * g_pack + h
        assert jfp._flat_head(bg, hg, g_pack, h, num_heads) == \
            b * num_heads + head
    for rate in (0.1, 0.5, 1e-12, 0.999999):
        assert hfa.keep_threshold(rate) == jfa._keep_threshold(rate)
        want = np.asarray(jnp.ones((), jnp.float32) * (1.0 / (1.0 - rate)))
        assert np.float32(hfa.keep_scale(rate)) == want


# -- K1-K3 --------------------------------------------------------------------

# (b, sq, sk, h, hk, d, causal, dtype)
K1_CASES = {
    "f32_causal": (1, 256, 256, 2, 2, 64, True, "f32"),
    "f32_noncausal_b2": (2, 128, 128, 2, 2, 32, False, "f32"),
    "gqa_causal": (2, 128, 128, 4, 2, 64, True, "f32"),
    "sq_lt_sk": (1, 128, 256, 2, 2, 64, True, "f32"),
    "bf16_causal": (1, 256, 256, 2, 2, 64, True, "bf16"),
}


@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_plain_k1_k2_k3_with_dropout_match_pallas(case):
    """The Pallas forward and backward with dropout 0.1 and seed 1234, and
    the port's plain K1 and K2/K3 with the same rate and seed: o and lse
    from the same inputs, then the gradients from the same (o, lse)."""
    b, sq, sk, h, hk, d, causal, dtype = K1_CASES[case]
    rng = np.random.default_rng(3)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, sk, hk, d)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    scale, seed = 1.0 / np.sqrt(d), 1234

    def bhsd(x, s, heads):
        return _j(x, dtype).transpose(0, 2, 1, 3).reshape(b * heads, s, d)

    def unflat(x, s, heads):
        return _np(x).reshape(b, heads, s, d).transpose(0, 2, 1, 3)

    jseed = jnp.asarray([seed], jnp.int32)
    with jax_pallas([]):
        jq, jk, jv, jdo = (bhsd(q, sq, h), bhsd(k, sk, hk), bhsd(v, sk, hk),
                           bhsd(do, sq, h))
        jo, jlse = jfa._fwd(jq, jk, jv, scale, causal, 128, 128, h,
                            dropout=0.1, seed=jseed)
        jdq, jdk, jdv = jfa._bwd(jq, jk, jv, jo, jlse, jdo, scale, causal,
                                 128, 128, h, dropout=0.1, seed=jseed)
    drop = hfa.AttnDropout(0.1, seed)
    to, tlse = hfa.flash_fwd(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                             causal, scale, dropout=drop)
    _close(to, unflat(jo, sq, h), dtype, "o", atol=1e-4)
    _close(tlse, _np(jlse).reshape(b, h, sq), "f32", "lse")
    o = _t(unflat(jo, sq, h), dtype)
    lse = torch.from_numpy(_np(jlse).reshape(b, h, sq))
    got = hfa.flash_bwd(_t(q, dtype), _t(k, dtype), _t(v, dtype), o, lse,
                        _t(do, dtype), causal, scale, dropout=drop)
    for name, g, w, s, heads in (("dq", got[0], jdq, sq, h),
                                 ("dk", got[1], jdk, sk, hk),
                                 ("dv", got[2], jdv, sk, hk)):
        _close(g, unflat(w, s, heads), dtype, name, grad=True)
    # the mask matters: without it the gradients move
    plain = hfa.flash_bwd(_t(q, dtype), _t(k, dtype), _t(v, dtype), o, lse,
                          _t(do, dtype), causal, scale)
    assert float((plain[2] - got[2]).abs().max()) > 1e-2


def test_identity_v_probe_shows_the_dropped_probabilities():
    """The probe the card runs: at Sk <= D with V the identity, o·l is p
    times keep, so its zeros are exactly the dropped scores (p > 0 at
    every unmasked score)."""
    b, s, h, d = 2, 64, 3, 64
    rng = np.random.default_rng(0)
    q, k = (torch.from_numpy(0.1 * rng.standard_normal((b, s, h, d)).astype(
        np.float32)) for _ in range(2))
    v = torch.eye(s, d).reshape(1, s, 1, d).expand(b, s, h, d).contiguous()
    drop = hfa.AttnDropout(0.1, 99)
    keep = hfa.dropout_keep_dense(b * h, s, s, 99, 0.1).reshape(b, h, s, s)
    for fwd in (lambda: hfa.flash_fwd(q, k, v, dropout=drop),
                lambda: hfp.flash_packed_fwd(q, k, v, dropout=drop),
                lambda: hfp.flash_packed_fwd_stream(q, k, v, dropout=drop)):
        o, lse = fwd()
        ol = o.permute(0, 2, 1, 3)[..., :s] * torch.exp(lse)[..., None]
        assert torch.equal(ol == 0, keep == 0)


# -- K4 ------------------------------------------------------------------------

PIN = (128, 128)
# (b, sq, sk, h, causal, dtype, mask, pins)
K4_CASES = {
    "f32_s128_direct_fused": (1, 128, 128, 2, False, "f32", None, PIN),
    "f32_s128_causal_bias_direct": (2, 128, 128, 2, True, "f32", "bias",
                                    PIN),
    "f32_h32_s128_direct": (1, 128, 128, 32, False, "f32", None, PIN),
    "f32_s256_stream": (1, 256, 256, 2, False, "f32", None, PIN),
    "f32_s256_causal_segments_stream": (1, 256, 256, 2, True, "f32", "seg",
                                        PIN),
    "f32_sq128_sk256_dkv_direct": (2, 128, 256, 2, False, "f32", "segk",
                                   PIN),
    "bf16_s128_direct_fused": (1, 128, 128, 2, False, "bf16", None, PIN),
    "bf16_s256_bias_stream": (1, 256, 256, 2, False, "bf16", "bias", PIN),
    # dk/dv-direct in bf16 (K3's tensor-core body on the card)
    "bf16_sq128_sk256_bias_dkv_direct": (1, 128, 256, 2, False, "bf16",
                                         "bias", PIN),
}


def _k4_inputs(name):
    b, sq, sk, h, causal, dtype, mask, _ = K4_CASES[name]
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((b, s, h, 64)).astype(np.float32)
               for s in (sq, sk, sk))
    do = rng.standard_normal((b, sq, h, 64)).astype(np.float32)
    seg_q = seg_k = bias = None
    if mask in ("seg", "segk"):
        seg_q = np.sort(rng.integers(1, 4, (b, sq)), axis=1).astype(np.int32)
        seg_k = seg_q if mask == "seg" else np.sort(
            rng.integers(0, 3, (b, sk)), axis=1).astype(np.int32)
    if mask == "bias":
        lengths = rng.integers(sk // 4, sk + 1, b)
        bias = (np.where(np.arange(sk)[None, :] >= lengths[:, None], -1e9,
                         0.0) + rng.standard_normal((b, sk))).astype(
                             np.float32)
    return (q, k, v, do), dict(segment_ids=seg_q, segment_ids_k=seg_k,
                               key_bias=bias)


@pytest.mark.parametrize("case", sorted(K4_CASES))
def test_k4_bodies_with_dropout_match_pallas_vjp(case):
    """o and the ``jax.vjp`` gradients of the JAX ``flash_attention_packed``
    (bodies in interpret mode) at dropout 0.1 and seed 4321, against the
    port's with the same rate and seed; the forms the port ran are the
    counterparts of the bodies JAX ran."""
    b, sq, sk, h, causal, dtype, _, pins = K4_CASES[case]
    (q, k, v, do), masks = _k4_inputs(case)
    blocks = dict(block_q=pins[0], block_k=pins[1])
    bodies = []
    jmasks = {n: None if m is None else jnp.asarray(m)
              for n, m in masks.items()}
    with jax_pallas(bodies) as fp:
        jo, vjp = jax.vjp(lambda a, b_, c: fp.flash_attention_packed(
            a, b_, c, causal=causal, dropout=0.1,
            dropout_seed=jnp.asarray([4321], jnp.int32), **blocks, **jmasks),
            _j(q, dtype), _j(k, dtype), _j(v, dtype))
        jgrads = vjp(_j(do, dtype))
    tq, tk, tv = (_t(x, dtype).requires_grad_() for x in (q, k, v))
    tmasks = {n: None if m is None else torch.from_numpy(m)
              for n, m in masks.items()}
    with port_forms() as ran:
        o = hfp.flash_attention_packed(tq, tk, tv, causal=causal,
                                       dropout=0.1, dropout_seed=4321,
                                       **blocks, **tmasks)
        o.backward(_t(do, dtype))
    assert ran == [COUNTERPART[body] for body in bodies]
    _close(o, _np(jo), dtype, "o")
    for name, g, w in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad),
                          jgrads):
        _close(g, _np(w), dtype, name, grad=True)


def test_k4_with_the_same_seed_repeats_and_another_seed_differs():
    (q, k, v, _), _ = _k4_inputs("f32_s256_stream")
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    runs = [hfp.flash_attention_packed(q, k, v, dropout=0.1,
                                       dropout_seed=s) for s in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    plain = hfp.flash_attention_packed(q, k, v)
    assert not torch.equal(runs[0], plain)


# -- the entries ---------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_cpu_route_is_the_dense_mirror(causal):
    """``ops.flash_attention`` with dropout on a CPU tensor runs the
    kernels' plain versions with their mask: equal to JAX's dense mirror
    ``_dense_prob_dropout_attention``, its route off the TPU, at a pinned
    seed, GQA included (f32, 2e-5)."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 40, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 40, 2, 16)).astype(np.float32)
            for _ in range(2))
    want = jops._dense_prob_dropout_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, None,
        jnp.asarray([77], jnp.int32), 0.2)
    got = tops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                               dropout=0.2, causal=causal,
                               fixed_seed_offset=77)
    _close(got, _np(want), "f32", "o")
    # eval mode, or rate 0: no dropout at all
    evald = tops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                 dropout=0.2, causal=causal, training=False)
    assert torch.equal(evald, tops.flash_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal))


def test_sdpa_routes_dropout_into_the_kernel_or_onto_the_probabilities(
        monkeypatch):
    """On the kernel route dropout_p rides K4 (the seed from the next key);
    on the dense route it is ``dropout(probs)``, the same masks as JAX's
    dense path when the draw is pinned on both sides."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((1, 128, 2, 64)).astype(
        np.float32))
    with port_forms() as ran:
        trandom.seed(5)
        a = TF.scaled_dot_product_attention(q, q, q, dropout_p=0.1)
        trandom.seed(5)
        b = TF.scaled_dot_product_attention(q, q, q, dropout_p=0.1)
    assert ran == ["flash_packed_fwd", "flash_packed_fwd"]
    assert torch.equal(a, b)
    assert not torch.equal(a, TF.scaled_dot_product_attention(q, q, q))
    # dense route: d = 20 takes no kernel
    x = rng.standard_normal((2, 30, 3, 20)).astype(np.float32)
    keep = rng.random((2, 3, 30, 30)) >= 0.25
    with pinned_masks(monkeypatch, [keep]):
        want = jax_sdpa(jnp.asarray(x), 0.25)
    with pinned_masks(monkeypatch, [keep]):
        got = TF.scaled_dot_product_attention(*(torch.from_numpy(x),) * 3,
                                              dropout_p=0.25)
    _close(got, _np(want), "f32", "o")


def jax_sdpa(x, p):
    from paddle_tpu.nn import functional as JF
    return JF.scaled_dot_product_attention(x, x, x, dropout_p=p,
                                           training=True)


# -- hidden dropout -------------------------------------------------------------

@contextlib.contextmanager
def pinned_masks(monkeypatch, masks):
    """Hand the same numpy keep masks, in order, to both packages' draws:
    ``jax.random.bernoulli`` and the port's ``_keep_mask``."""
    jq, tq = list(masks), list(masks)

    def jax_draw(key, p, shape):
        m = jq.pop(0)
        assert tuple(shape) == m.shape
        return jnp.asarray(m)

    def port_draw(key, shape, keep, device):
        m = tq.pop(0)
        assert tuple(shape) == m.shape
        return torch.from_numpy(m)

    with monkeypatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", jax_draw)
        mp.setattr(TF, "_keep_mask", port_draw)
        yield


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_functional_dropout_matches_jax_on_the_same_mask(monkeypatch, mode,
                                                         dtype):
    from paddle_tpu.nn import functional as JF
    rng = np.random.default_rng(4)
    x = rng.standard_normal((6, 50)).astype(np.float32)
    keep = rng.random((6, 50)) >= 0.3
    with pinned_masks(monkeypatch, [keep, keep]):
        want = JF.dropout(_j(x, dtype), 0.3, training=True, mode=mode)
        got = TF.dropout(_t(x, dtype), 0.3, training=True, mode=mode)
    assert got.dtype == _t(x, dtype).dtype
    assert np.array_equal(got.float().numpy(), _np(want))
    for training in (True, False):
        for p in (0.0, 1.0, 0.3):
            if training and p == 0.3:
                continue
            w = JF.dropout(_j(x, dtype), p, training=training, mode=mode)
            g = TF.dropout(_t(x, dtype), p, training=training, mode=mode)
            assert np.array_equal(g.float().numpy(), _np(w)), (p, training)


def test_port_draws_keep_their_share_and_follow_the_key():
    """The keep share of 10^6 draws at p = 0.1 lies within 6 standard
    deviations of 0.9; equal keys give equal masks, the next key another
    one; the global generator's state round-trips."""
    x = torch.ones(1000, 1000)
    y = TF.dropout(x, 0.1, key=trandom.fold_in(trandom.make_key(3), 1))
    share = float((y != 0).float().mean())
    assert abs(share - 0.9) < 6 * np.sqrt(0.9 * 0.1 / 1e6)
    assert torch.allclose(y[y != 0], torch.tensor(1 / 0.9))
    again = TF.dropout(x, 0.1, key=trandom.fold_in(trandom.make_key(3), 1))
    assert torch.equal(y, again)
    trandom.seed(11)
    state = trandom.get_rng_state()
    a, b = TF.dropout(x, 0.1), TF.dropout(x, 0.1)
    assert not torch.equal(a, b)
    trandom.set_rng_state(state)
    assert torch.equal(TF.dropout(x, 0.1), a)
    with trandom.rng_scope(trandom.make_key(9)):
        c = TF.dropout(x, 0.1)
    with trandom.rng_scope(trandom.make_key(9)):
        assert torch.equal(TF.dropout(x, 0.1), c)
    assert trandom.get_rng_state() == (11, 1)   # scopes leave it alone


@pytest.mark.parametrize("normalize_before", [False, True])
def test_encoder_layer_with_dropout_matches_jax(monkeypatch,
                                                normalize_before):
    """``TransformerEncoderLayer(dropout=0.1)`` in training: the three
    hidden dropouts on pinned masks, attention dropout 0 (its kernel mask
    is tested above), against the JAX layer. f32 within 1e-5."""
    from paddle_tpu import nn as jnn
    from paddle_tpu_torch.nn import TransformerEncoderLayer
    paddle.seed(3)
    jl = jnn.TransformerEncoderLayer(128, 2, 256, dropout=0.1,
                                     activation="gelu", attn_dropout=0.0,
                                     normalize_before=normalize_before)
    tl = TransformerEncoderLayer(128, 2, 256, dropout=0.1,
                                 activation="gelu", attn_dropout=0.0,
                                 normalize_before=normalize_before)
    tl.load_state_dict(from_jax_state_dict(
        {k: np.asarray(v) for k, v in jl.state_dict().items()}), strict=True)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 128, 128)).astype(np.float32)
    masks = [rng.random(s) >= 0.1 for s in
             [(2, 128, 128), (2, 128, 256), (2, 128, 128)]]
    jl.train()
    tl.train()
    with pinned_masks(monkeypatch, masks):
        want = jl(jnp.asarray(x))
        got = tl(torch.from_numpy(x))
    _close(got, _np(want), "f32", "out", atol=1e-5)


# -- the models ----------------------------------------------------------------

@contextlib.contextmanager
def pinned_seeds(monkeypatch, seeds):
    """The attention-dropout seeds, in order, on both sides: JAX's
    ``jax.random.randint`` and the port's ``draw_seed``."""
    jq, tq = list(seeds), list(seeds)

    def jax_randint(key, shape, lo, hi, dtype=None):
        return jnp.full(shape, jq.pop(0), jnp.int32)

    with monkeypatch.context() as mp:
        mp.setattr(jax.random, "randint", jax_randint)
        mp.setattr(trandom, "draw_seed", lambda key=None: tq.pop(0))
        yield jq, tq


def test_gpt_with_attention_dropout_matches_the_jax_dense_mirror(
        monkeypatch):
    """GPT (2 layers, attention dropout 0.1, hidden 0) in training on the
    CPU: logits, loss and every gradient against JAX's on its CPU route
    (the dense mirror), one pinned seed per layer. f32: logits and loss
    within 1e-5, gradients within 1e-4·max|ref|."""
    from paddle_tpu.text.models import gpt as jgpt
    from paddle_tpu_torch.text.models import gpt as tgpt
    cfg = dict(num_layers=2, attention_dropout=0.1, hidden_dropout=0.0)
    paddle.seed(0)
    jm = jgpt.GPTForCausalLM(jgpt.gpt_tiny(**cfg))
    tm = tgpt.GPTForCausalLM(tgpt.gpt_tiny(**cfg), device="cpu")
    tm.load_state_dict(from_jax_state_dict(
        {k: np.asarray(v) for k, v in jm.state_dict().items()}), strict=True)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 1024, (2, 64)).astype(np.int32)
    labels = rng.integers(0, 1024, (2, 64)).astype(np.int32)
    seeds = [101, 202, 101, 202]
    with pinned_seeds(monkeypatch, seeds) as left:
        want_logits = jax.jit(lambda p: functional_call(
            jm, p, jnp.asarray(ids), training=True))(get_params(jm))
        want_loss, want = jax.jit(jax.value_and_grad(
            lambda p: functional_call(jm, p, jnp.asarray(ids),
                                      jnp.asarray(labels), training=True)))(
                get_params(jm))
        tm.train()
        got_logits = tm(torch.from_numpy(ids).long())
        loss = tm(torch.from_numpy(ids).long(),
                  torch.from_numpy(labels).long())
        loss.backward()
    assert left == ([], [])   # every layer drew its seed, on both sides
    _close(got_logits, _np(want_logits), "f32", "logits", atol=1e-5)
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5
    got = to_jax_state_dict({n: p.grad for n, p in tm.named_parameters()})
    for name, g in got.items():
        w = np.asarray(want[name])
        np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max() + 1e-9,
                                   rtol=0, err_msg=name)
    tm.eval()
    with torch.no_grad():   # the dropout changed the logits
        assert float((tm(torch.from_numpy(ids).long()) - got_logits).abs()
                     .max()) > 1e-3


@contextlib.contextmanager
def jax_on_the_kernels(monkeypatch):
    """The JAX package's SDPA on its kernel route (``_use_pallas``), the
    Pallas bodies in interpret mode."""
    bodies = []
    with monkeypatch.context() as mp:
        mp.setattr(jops, "_use_pallas", lambda q, k: True)
        with jax_pallas(bodies):
            yield bodies


def _model_case(monkeypatch, jm, tm, jargs, targs, n_layers):
    """Loss and gradients of both models in training, attention dropout on
    pinned seeds (one a layer), JAX on its kernels."""
    seeds = [1000 + i for i in range(n_layers)]
    with pinned_seeds(monkeypatch, seeds) as left, \
            jax_on_the_kernels(monkeypatch):
        want_loss, want = jax.jit(jax.value_and_grad(
            lambda p: functional_call(jm, p, *jargs, training=True)))(
                get_params(jm))
        with port_forms() as ran:
            tm.train()
            loss = tm(*targs)
            loss.backward()
    assert left == ([], [])   # every layer drew its seed, on both sides
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5
    got = to_jax_state_dict({n: torch.zeros_like(p) if p.grad is None
                             else p.grad for n, p in tm.named_parameters()})
    for name, g in got.items():
        w = np.asarray(want[name])
        ref = np.asarray(want[name[:-4] + "weight"]) \
            if name.endswith("k_proj.bias") else w
        np.testing.assert_allclose(
            g, w, atol=1e-4 * float(np.abs(ref).max()) + 1e-9, rtol=0,
            err_msg=name)
    return ran


def test_bert_with_attention_dropout_matches_jax_on_its_kernels(
        monkeypatch):
    """BERT (2 layers, 2 heads of 64, S = 128, padded): K4a-direct and
    K4b-fused with dropout 0.1 against the JAX bodies. Loss within 1e-5,
    gradients within 1e-4·max|ref|."""
    from test_torch_bert import (_jax_args, _torch_args, bert_batch,
                                 carried_pair)
    jm, tm = carried_pair(attention_dropout=0.1)
    args, seg = bert_batch("padded", seed=1)
    jargs, _ = _jax_args(args, seg)
    targs, _ = _torch_args(args, seg)
    ran = _model_case(monkeypatch, jm, tm, jargs, targs, 2)
    assert ran == ["flash_packed_fwd"] * 2 + ["flash_packed_bwd"] * 2


def test_ernie_at_1024_with_attention_dropout_matches_jax_on_its_kernels(
        monkeypatch):
    """ERNIE (2 layers, B = 1, S = 1024, padded): the streamed forward, dq
    and dk/dv with dropout 0.1 against the JAX bodies. Loss within 1e-5,
    gradients within 1e-4·max|ref|."""
    from test_torch_ernie import batch, carried_pair
    jm, tm = carried_pair(max_position_embeddings=1024, attention_dropout=0.1)
    ids, att, labels, sop = batch(b=1, s=1024, seed=2, masked=True)
    jargs = [jnp.asarray(ids), None, jnp.asarray(att), jnp.asarray(labels),
             jnp.asarray(sop)]
    targs = [torch.from_numpy(ids).long(), None, torch.from_numpy(att),
             torch.from_numpy(labels).long(), torch.from_numpy(sop).long()]
    ran = _model_case(monkeypatch, jm, tm, jargs, targs, 2)
    assert ran == ["flash_packed_fwd_stream"] * 2 + \
        ["flash_packed_bwd_dq", "flash_packed_bwd_dkv"] * 2


# -- the train step --------------------------------------------------------------

def _dropout_step(seed=0):
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.framework import make_sharded_train_step
    from paddle_tpu_torch.text.models.bert import (BertForPretraining,
                                                   bert_tiny)
    torch.manual_seed(seed)
    m = BertForPretraining(bert_tiny(num_heads=2, num_layers=1), device="cpu",
                           seed=seed)
    return make_sharded_train_step(
        m, AdamW(1e-3), lambda mod, bt: mod(bt[0], None, None, bt[1]))


def _bert_tiny_batch(i):
    rng = np.random.default_rng(100 + i)
    return (rng.integers(0, 1024, (2, 128)).astype(np.int64),
            rng.integers(0, 1024, (2, 128)).astype(np.int64))


def test_train_step_resumed_with_dropout_equals_an_unbroken_run():
    """BERT at its published dropout (hidden and attention 0.1): a new step
    loaded from a state saved after step 2 gives steps 3-4 exactly as the
    unbroken run does; every step's masks differ (the losses of one batch
    at steps 1 and 2, from one state, differ), and equal (seed,
    step_count) give equal losses."""
    step = _dropout_step()
    losses = [float(step.step(_bert_tiny_batch(i))) for i in range(2)]
    saved = step.state_dict()
    cont = [float(step.step(_bert_tiny_batch(i))) for i in (2, 3)]
    resumed = _dropout_step(seed=1)         # other weights, then loaded
    resumed.load_state_dict(saved)
    assert resumed.step_count == 2
    again = [float(resumed.step(_bert_tiny_batch(i))) for i in (2, 3)]
    assert again == cont
    fresh = _dropout_step()
    assert [float(fresh.step(_bert_tiny_batch(i))) for i in range(2)] == \
        losses
    # one state, one batch, two step indices: two masks
    a, b = _dropout_step(), _dropout_step()
    la = float(a.step(_bert_tiny_batch(0), index=1))
    lb = float(b.step(_bert_tiny_batch(0), index=2))
    assert la != lb
