"""Port parity: K2/K3's rounding points pinned in bf16, and the bodies their
wrappers reach.

K2 and K3 (``_bwd_dq_kernel``, ``_bwd_dkv_kernel``) round ``ds = p (dp keep
- delta) scale`` to bf16 before ``ds k`` and ``ds^T q``, and ``p keep`` to
bf16 before ``(p keep)^T dO``; everything else is an f32 sum, rounded once
at the end. The port's plain version (``flash_bwd_reference``) is the
yardstick its tensor-core bodies (``csrc/flash_bwd_tc.cu``) are held to on
the card, so it must round at the same points. Here both sides get one lse
(the plain forward's, with the keyless rows' ``NEG_INF + log 1e-30``) and
one delta (the one JAX's ``_bwd`` computes, read off its ``pallas_call``
arguments), and JAX's bodies run in interpret mode at pinned 128/128
blocks, at D = 128: causal and not, GQA (4 query heads on 2 KV heads),
segments with the key bias and pad-sentinel keyless rows, dropout, and an
lse cotangent. In bf16 the two agree on at least 99% of the elements of
dq, dk and dv (found: 99.54-100%), and no element of dv differs by more
than one bf16 ulp of its value, taken no smaller than 1/64 of the tensor's
largest (found: at most one). dq and dk are held to three such ulps
(found: three, at a few of 65536 elements, non-causal and under dropout):
their sums ds k and ds^T q cancel at D = 128 down to elements 1/70 of the
largest, and a ds whose bf16 rounding flips where the two sides' f32 dp
sums differ moves such an element by one ulp of a term several times its
size (summed over JAX's 128-key tiles instead of all keys at once, the
plain dq gives the same three ulps). The same plain version without the ds
rounding (dq, dk) or without the p rounding (dv) misses (found: 58.2-58.8%
equal, 12-21 ulps). ``mma_sums`` (dp summed as ``mma.sync`` sums it,
``mma_dot``, which takes dO's H heads against v's HK) changes those sums
and nothing else.

Then the bodies the wrappers reach on the card, with the kernel calls
stubbed: bf16 at head dims 64 and 128 reaches the tensor-core entries
(``paddle_flash_bwd_dq_tc``/``_dkv_tc``, counted by ``flash_bwd_dq_tc`` and
``flash_bwd_dkv_tc``), float32 and bf16 at 256 the CUDA-core ones of
``flash_bwd.cu``; the ``_tc`` wrappers refuse float32, head dim 256 and rows
that are not 16-byte aligned.
"""

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_flash_stream_bwd import _agreement

hfa = importlib.import_module("paddle_tpu_torch.ops._hopper.flash_attention")

D = 128
S = 256
PIN = 128          # JAX's block_q = block_k, pinned
RATE = 0.1
SEED = 2424
PAD_Q, PAD_K = -1, -2   # pad sentinels: a pad query sees no key at all

# name: (H, HK, causal, masks, dropout rate, with an lse cotangent)
CASES = {
    "s256": (2, 2, False, False, 0.0, False),
    "s256_causal": (2, 2, True, False, 0.0, False),
    "gqa_h4_hk2_causal": (4, 2, True, False, 0.0, False),
    "segments_bias_keyless": (2, 2, False, True, 0.0, False),
    "causal_dropout": (2, 2, True, False, RATE, False),
    "causal_dlse": (2, 2, True, False, 0.0, True),
}


def _inputs(name):
    """torch bf16 q, k, v, do, the masks, the dropout and the lse cotangent
    of a case, from seed 0: segment ids 0..2 sorted with the last 40
    queries and keys the pad sentinels (those queries find no key), and a
    padding bias at -1e9 past a random length plus noise."""
    h, hk, _, masked, rate, with_dlse = CASES[name]
    rng = np.random.default_rng(0)

    def bf16(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).bfloat16()

    q, k, v, do = bf16(1, S, h, D), bf16(1, S, hk, D), bf16(1, S, hk, D), \
        bf16(1, S, h, D)
    masks = (None, None, None)
    if masked:
        ids = np.sort(rng.integers(0, 3, (1, S)), axis=1).astype(np.int32)
        seg_q, seg_k = ids.copy(), ids.copy()
        seg_q[:, S - 40:] = PAD_Q
        seg_k[:, S - 40:] = PAD_K
        length = rng.integers(S // 4, S + 1)
        bias = (np.where(np.arange(S)[None, :] >= length, -1e9, 0.0) +
                rng.standard_normal((1, S))).astype(np.float32)
        masks = hfa._masks(1, S, S, q.device, torch.from_numpy(seg_q),
                           torch.from_numpy(seg_k), torch.from_numpy(bias))
    drop = hfa.as_dropout(rate, SEED) if rate else None
    dlse = torch.from_numpy(rng.standard_normal((1, h, S)).astype(
        np.float32)) if with_dlse else None
    return (q, k, v, do), masks, drop, dlse


def _recording_pallas(calls):
    """``pl.pallas_call`` in interpret mode, each call's body name and
    input arrays appended to ``calls``."""
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def call(kernel, *args, **kwargs):
        kwargs.setdefault("interpret", True)
        fn = orig(kernel, *args, **kwargs)
        body = kernel.func if isinstance(kernel, functools.partial) else \
            kernel

        def run(*xs):
            calls.append((body.__name__, xs))
            return fn(*xs)
        return run
    return orig, call


@pytest.fixture(scope="module")
def pallas_bwd():
    """Each case's JAX gradients from ``_bwd`` at pinned 128/128 blocks in
    interpret mode (the bodies it ran, dq/dk/dv as f32 numpy in the port's
    layout), fed the plain forward's o and lse; and the lse and delta both
    sides take."""
    from paddle_tpu.ops._pallas import flash_attention as fa
    import jax.experimental.pallas as pl
    cache = {}

    def get(name):
        if name in cache:
            return cache[name]
        h, hk, causal, _, rate, _ = CASES[name]
        (q, k, v, do), masks, drop, dlse = _inputs(name)
        o, lse = hfa.flash_fwd_reference(q, k, v, causal, None, drop,
                                         masks=masks)

        def flat(t, heads):
            return jnp.asarray(t.float().numpy(), jnp.bfloat16).transpose(
                0, 2, 1, 3).reshape(heads, S, D)

        seg_q, seg_k, bias = masks
        jmask = {}
        if seg_q is not None:
            jmask = dict(
                seg_q=jnp.repeat(jnp.asarray(seg_q.numpy())[:, None], h,
                                 axis=1).reshape(h, 1, S),
                seg_k=jnp.repeat(jnp.asarray(seg_k.numpy())[:, None], h,
                                 axis=1).reshape(h, 1, S),
                bias=jnp.asarray(bias.numpy()).reshape(1, 1, S))
        if dlse is not None:
            jmask["dlse"] = jnp.asarray(dlse.numpy()).reshape(h, 1, S)
        calls = []
        orig, call = _recording_pallas(calls)
        pl.pallas_call = fa.pl.pallas_call = call
        try:
            dq, dk, dv = fa._bwd(
                flat(q, h), flat(k, hk), flat(v, hk), flat(o, h),
                jnp.asarray(lse.numpy()).reshape(h, 1, S), flat(do, h),
                1.0 / np.sqrt(D), causal, PIN, PIN, h, dropout=rate,
                seed=jnp.full((1,), SEED, jnp.int32), **jmask)
        finally:
            pl.pallas_call = fa.pl.pallas_call = orig
        bodies = [c[0] for c in calls]
        delta = np.asarray(calls[0][1][5]).reshape(1, h, S)

        def unflat(x, heads):
            return np.asarray(jnp.asarray(x, jnp.float32)).reshape(
                1, heads, S, D).transpose(0, 2, 1, 3)

        out = {"dq": unflat(dq, h), "dk": unflat(dk, hk),
               "dv": unflat(dv, hk)}
        cache[name] = (out, bodies, o, lse, torch.from_numpy(delta.copy()))
        return cache[name]

    return get


def _plain(name, o, lse, delta, monkeypatch, mma_sums=False, **over):
    """The plain K2/K3 of a case, fed JAX's delta (``_delta`` patched to
    return it), with any input replaced by ``over``."""
    (q, k, v, do), masks, drop, dlse = _inputs(name)
    ins = {"q": q, "k": k, "v": v, "do": do, **over}
    monkeypatch.setattr(hfa, "_delta", lambda *a, **kw: delta)
    got = hfa.flash_bwd_reference(ins["q"], ins["k"], ins["v"], o, lse,
                                  ins["do"], CASES[name][2], None, dlse,
                                  drop, masks=masks, mma_sums=mma_sums)
    return dict(zip(("dq", "dk", "dv"), got))


#: the most bf16 ulps an element may differ by (see the module's note)
ULPS = {"dq": 3.0, "dk": 3.0, "dv": 1.0}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_k2_k3_round_where_pallas_rounds(case, pallas_bwd,
                                               monkeypatch):
    """At least 99% of dq, dk and dv equal JAX's bodies' in bf16, the rest
    within ``ULPS``; keyless rows give dq = 0 on both sides."""
    want, bodies, o, lse, delta = pallas_bwd(case)
    assert bodies == ["_bwd_dq_kernel", "_bwd_dkv_kernel"]
    got = _plain(case, o, lse, delta, monkeypatch)
    for g in ("dq", "dk", "dv"):
        assert got[g].dtype == torch.bfloat16
        equal, ulps = _agreement(got[g], want[g])
        assert equal >= 0.99 and ulps <= ULPS[g], (case, g, equal, ulps)
    if CASES[case][3]:
        keyless = (lse <= hfa.NEG_INF / 2).transpose(1, 2)   # [B, Sq, H]
        assert int(keyless.sum()) == 40 * CASES[case][0]
        assert bool((got["dq"][keyless] == 0).all())
        assert np.all(want["dq"][keyless.numpy()] == 0)


@pytest.mark.parametrize("grad", ["dq", "dk", "dv"])
def test_rounding_pin_catches_a_moved_rounding_point(grad, pallas_bwd,
                                                     monkeypatch):
    """The same check misses the plain version without one rounding: ds
    left in f32 before ``ds k`` (dq) and ``ds^T q`` (dk), both rounded to
    q's dtype, which a float32 q keeps; p left in f32 before ``p^T dO``
    (dv), rounded to do's dtype. The values stay bf16's."""
    case = "gqa_h4_hk2_causal"
    want, _, o, lse, delta = pallas_bwd(case)
    (q, _, _, do), _, _, _ = _inputs(case)
    over = dict(do=do.float()) if grad == "dv" else dict(q=q.float())
    got = _plain(case, o, lse, delta, monkeypatch, **over)[grad]
    equal, ulps = _agreement(got.bfloat16(), want[grad])
    assert not (equal >= 0.99 and ulps <= ULPS[grad]), (grad, equal, ulps)


def test_mma_dot_takes_grouped_query_heads():
    """``mma_dot`` of dO's H heads against v's HK heads is the same sum
    as against v repeated to H heads, head h taking KV head h // (H/HK)."""
    g = torch.Generator().manual_seed(7)
    a = torch.randn(1, 9, 4, 32, generator=g).bfloat16()
    b = torch.randn(1, 11, 2, 32, generator=g).bfloat16()
    got = hfa.mma_dot(a, b)
    assert got.shape == (1, 4, 9, 11)
    assert torch.equal(got, hfa.mma_dot(a, b.repeat_interleave(2, dim=2)))


def test_mma_sums_change_only_the_sums_of_dp(pallas_bwd, monkeypatch):
    """With ``mma_sums`` the plain K2/K3 take dp from ``mma_dot`` on dO and
    v (a spy sees it once, at GQA: v has the KV heads) and round where they
    did: at least 99% of dq, dk and dv equal the default's."""
    case = "gqa_h4_hk2_causal"
    _, _, o, lse, delta = pallas_bwd(case)
    (_, _, v, do), _, _, _ = _inputs(case)
    calls = []
    orig = hfa.mma_dot

    def spy(a, b):
        calls.append((torch.equal(a, do), torch.equal(b, v), b.shape[2]))
        return orig(a, b)

    monkeypatch.setattr(hfa, "mma_dot", spy)
    plain = _plain(case, o, lse, delta, monkeypatch)
    assert calls == []
    summed = _plain(case, o, lse, delta, monkeypatch, mma_sums=True)
    assert calls == [(True, True, 2)]
    for g in ("dq", "dk", "dv"):
        equal = float((plain[g] == summed[g]).float().mean())
        assert equal >= 0.99, (g, equal)


class _Stub:
    """``_kernel``/``_call`` stand-ins that record the entry each launch
    would reach and the dtype code it would pass."""

    def __init__(self):
        self.entries = []

    def kernel(self, stem, name, n_ptrs, n_strides):
        return stem, name

    def call(self, lib, fn, what, q, k, *args):
        self.entries.append((lib, fn, what, args[-5]))


COUNTS = ("flash_bwd_dq", "flash_bwd_dq_tc", "flash_bwd_dkv",
          "flash_bwd_dkv_tc")


def _stub_launches(monkeypatch):
    stub = _Stub()
    monkeypatch.setattr(hfa, "_kernel", stub.kernel)
    monkeypatch.setattr(hfa, "_call", stub.call)
    # the inputs pass the checks a CUDA tensor meets
    monkeypatch.setattr(hfa, "_require_kernel_inputs", lambda *a: None)
    for name in COUNTS:
        monkeypatch.setattr(getattr(hfa, name), "launches", 0)
    return stub


def _small(dtype, d, h=4, hk=2):
    g = torch.Generator().manual_seed(0)
    q, do = (torch.randn(1, 32, h, d, generator=g).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(1, 48, hk, d, generator=g).to(dtype)
            for _ in range(2))
    return q, k, v, do, torch.zeros(1, h, 32), torch.zeros(1, h, 32)


@pytest.mark.parametrize("dtype,d,tc", [
    (torch.bfloat16, 64, True), (torch.bfloat16, 128, True),
    (torch.bfloat16, 256, False), (torch.float32, 64, False),
    (torch.float32, 128, False), (torch.float32, 256, False),
    (torch.float16, 64, True), (torch.float16, 128, True),
    (torch.float16, 256, False)])
def test_backward_picks_its_body_by_dtype_and_head_dim(dtype, d, tc,
                                                       monkeypatch):
    """bf16 and float16 dq and dk/dv at head dims 64 and 128 reach the
    tensor-core entries of ``flash_bwd_tc.cu`` and their counts; float32,
    and 16 bits at 256, the CUDA-core entries of ``flash_bwd.cu``. Nothing
    falls back."""
    stub = _stub_launches(monkeypatch)
    args = _small(dtype, d)
    hfa.flash_bwd_dq(*args, True, 0.1)
    hfa.flash_bwd_dkv(*args, True, 0.1)
    suffix, stem = ("_tc", "flash_bwd_tc") if tc else ("", "flash_bwd")
    code = hfa._DTYPE_CODE[dtype]
    assert stub.entries == [
        (stem, f"paddle_flash_bwd_dq{suffix}", f"flash_bwd_dq{suffix}",
         code),
        (stem, f"paddle_flash_bwd_dkv{suffix}", f"flash_bwd_dkv{suffix}",
         code)]
    assert {n: getattr(hfa, n).launches for n in COUNTS} == {
        "flash_bwd_dq": int(not tc), "flash_bwd_dq_tc": int(tc),
        "flash_bwd_dkv": int(not tc), "flash_bwd_dkv_tc": int(tc)}


def test_tensor_core_backward_takes_bf16_at_64_and_128_only(monkeypatch):
    """The ``_tc`` wrappers refuse float32 and head dim 256 (the CUDA-core
    bodies run those) and rows that are not 16-byte aligned, before any
    launch; bf16 at 64 and 128 reaches their bodies."""
    stub = _stub_launches(monkeypatch)
    for fn in (hfa.flash_bwd_dq_tc, hfa.flash_bwd_dkv_tc):
        with pytest.raises(ValueError, match="takes bfloat16 at head dims"):
            fn(*_small(torch.float32, 128), True, 0.1)
        with pytest.raises(ValueError, match="takes bfloat16 at head dims"):
            fn(*_small(torch.bfloat16, 256), True, 0.1)
        fn(*_small(torch.bfloat16, 64), True, 0.1)
        fn(*_small(torch.bfloat16, 128), True, 0.1)
    assert [e[2] for e in stub.entries] == ["flash_bwd_dq_tc"] * 2 + \
        ["flash_bwd_dkv_tc"] * 2
    q, k, v, do, lse, delta = _small(torch.bfloat16, 64, h=2, hk=2)
    # rows 4 values (8 bytes) past a 16-byte boundary
    wide = torch.zeros(40 * 132, dtype=torch.bfloat16)
    odd = torch.as_strided(wide, (1, 32, 2, 64), (32 * 132, 132, 68, 1), 4)
    for fn in (hfa.flash_bwd_dq_tc, hfa.flash_bwd_dq):
        with pytest.raises(ValueError, match="16-byte aligned"):
            fn(odd, k, v, do, lse, delta, True, 0.1)
    assert len(stub.entries) == 4
