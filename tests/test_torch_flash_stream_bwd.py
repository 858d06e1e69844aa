"""Port parity: the streamed backward's rounding points, pinned in bf16.

K4's streamed dq and dk/dv (``_bwd_dq_kernel``, ``_bwd_dkv_kernel``) round
``ds = p (dp keep - delta) scale`` to bf16 before ``ds k`` and ``ds^T q``,
and ``p keep`` to bf16 before ``(p keep)^T dO``; everything else is an f32
sum, rounded once at the end. The port's plain versions
(``flash_packed_bwd_dq_reference``, ``flash_packed_bwd_dkv_reference``) are
the yardstick its CUDA bodies are held to on the card, so they must round
at the same points. Here both sides get one lse (the plain forward's, with
the keyless rows' ``NEG_INF + log 1e-30``) and one delta (the one JAX's
``_bwd`` computes, read off its ``pallas_call`` arguments), and JAX's
bodies run in interpret mode at pinned 128/128 blocks, which stream at
S = 256 already. In bf16 the two agree on at least 99% of the elements of
dq, dk and dv, and no element differs by more than one bf16 ulp of its
value, taken no smaller than 1/64 of the tensor's largest (found: 99.86-100%
equal, at most one ulp); the same plain versions without the ds rounding
(dq, dk), or without the p rounding (dv), miss both (found: 57.7-78.2%
equal, 3.5-21 ulps). The f32 sums run over other tiles in another order
(JAX's 128, the port's 64), which is what the ulp allows. ``mma_sums``,
the option by which the card's comparison sums dp as the tensor-core bodies
do (``mma_dot``, held here against a scalar model of its rule and in
``chip_smoke.py`` against the card's own sums), changes those sums and
nothing else.

Then the routing of the streamed backward on the card, with the kernel
calls stubbed: bf16 reaches the tensor-core entries (K2's and K3's,
``csrc/flash_bwd_tc.cu``, counted by ``flash_packed_bwd_dq_tc`` and
``flash_packed_bwd_dkv_tc``), float32 the CUDA-core entries, dk/dv-direct
``flash_packed_stream.cu`` in both, and the ``_tc`` wrappers refuse
float32.
"""

import contextlib
import functools
import importlib
import math
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

hfp = importlib.import_module(
    "paddle_tpu_torch.ops._hopper.flash_attention_packed")
hfa = importlib.import_module("paddle_tpu_torch.ops._hopper.flash_attention")

H = 2
PIN = 128          # JAX's block_q = block_k, pinned
RATE = 0.1
SEED = 4242
PAD_Q, PAD_K = -1, -2   # pad sentinels: a pad query sees no key at all

# name: (S, causal, masks, dropout rate)
CASES = {
    "s256": (256, False, None, 0.0),
    "s256_causal": (256, True, None, 0.0),
    "s512_causal": (512, True, None, 0.0),
    "s256_segments_bias_keyless": (256, False, "seg_bias_pad", 0.0),
    "s256_causal_dropout": (256, True, None, RATE),
}


def _inputs(name):
    """numpy q, k, v, do (bf16 values) and the masks of a case, seed 0:
    segment ids 0..2 sorted per row with the last 40 queries and keys the
    pad sentinels, so those queries find no key; bench.py's padding bias on
    a random length plus noise."""
    s, _, mask, _ = CASES[name]
    rng = np.random.default_rng(0)

    def bf16(x):
        return torch.from_numpy(x.astype(np.float32)).bfloat16().float() \
            .numpy()

    q, k, v, do = (bf16(rng.standard_normal((1, s, H, 64)))
                   for _ in range(4))
    seg_q = seg_k = bias = None
    if mask == "seg_bias_pad":
        ids = np.sort(rng.integers(0, 3, (1, s)), axis=1).astype(np.int32)
        seg_q, seg_k = ids.copy(), ids.copy()
        seg_q[:, s - 40:] = PAD_Q
        seg_k[:, s - 40:] = PAD_K
        length = rng.integers(s // 4, s + 1)
        bias = (np.where(np.arange(s)[None, :] >= length, -1e9, 0.0) +
                rng.standard_normal((1, s))).astype(np.float32)
    return (q, k, v, do), (seg_q, seg_k, bias)


def _port_inputs(name):
    (q, k, v, do), (seg_q, seg_k, bias) = _inputs(name)
    tq, tk, tv, tdo = (torch.from_numpy(x).bfloat16() for x in (q, k, v, do))
    masks = hfp._masks(1, q.shape[1], k.shape[1], tq.device,
                       *(None if x is None else torch.from_numpy(x)
                         for x in (seg_q, seg_k, bias)))
    rate = CASES[name][3]
    drop = hfa.as_dropout(rate, SEED) if rate else None
    return (tq, tk, tv, tdo), masks, drop


@contextlib.contextmanager
def recording_pallas(calls):
    """The JAX package's Pallas calls in interpret mode on the CPU, each
    call's kernel body and input arrays appended to ``calls``."""
    from paddle_tpu.ops._pallas import flash_attention_packed as fp
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

    pl.pallas_call = fp.pl.pallas_call = call
    try:
        yield fp
    finally:
        pl.pallas_call = fp.pl.pallas_call = orig


def _to_packed(x, g):
    b, s, h, d = x.shape
    return x.reshape(b, s, h // g, g * d).transpose(0, 2, 1, 3).reshape(
        b * (h // g), s, g * d)


def _from_packed(x, b, h):
    bhg, s, gd = x.shape
    return x.reshape(b, bhg // b, s, gd).transpose(0, 2, 1, 3).reshape(
        b, s, h, gd * (bhg // b) // h)


def _stats_from_packed(x, b, h):
    """``[B*HG, Sq, G]`` (the packed lse / delta layout) -> ``[B, H, Sq]``."""
    bhg, s, g = x.shape
    return x.reshape(b, bhg // b, s, g).transpose(0, 1, 3, 2).reshape(b, h, s)


@pytest.fixture(scope="module")
def pallas_bwd():
    """Each case's JAX gradients from ``_bwd`` at pinned 128/128 blocks in
    interpret mode (the bodies it ran, dq/dk/dv as f32 numpy), fed the
    plain forward's lse; and the lse and delta both sides take."""
    cache = {}

    def get(name):
        if name in cache:
            return cache[name]
        s, causal, _, rate = CASES[name]
        (q, k, v, do), masks, drop = _port_inputs(name)
        o, lse = hfp.flash_packed_fwd_stream_reference(q, k, v, causal, None,
                                                       masks, drop)
        g = hfp.pack_group(H)

        def jx(t, dtype=jnp.bfloat16):
            return jnp.asarray(t.float().numpy(), dtype)

        seg_q, seg_k, bias = (None if t is None else
                              jnp.asarray(t.numpy()).reshape(1, 1, -1)
                              for t in masks)
        lse_p = lse.reshape(1, H // g, g, s).transpose(2, 3).reshape(
            H // g, s, g)
        calls = []
        with recording_pallas(calls) as fp:
            dq, dk, dv = fp._bwd(
                _to_packed(jx(q), g), _to_packed(jx(k), g),
                _to_packed(jx(v), g), _to_packed(jx(o), g),
                jx(lse_p, jnp.float32), _to_packed(jx(do), g),
                1.0 / 8.0, causal, PIN, PIN, g, H, seg_q, seg_k,
                dropout=rate, seed=jnp.full((1,), SEED, jnp.int32),
                bias=bias)
        bodies = [c[0] for c in calls]
        delta = _stats_from_packed(np.asarray(calls[0][1][5]), 1, H)
        out = {n: _from_packed(np.asarray(jnp.asarray(x, jnp.float32)), 1, H)
               for n, x in (("dq", dq), ("dk", dk), ("dv", dv))}
        cache[name] = (out, bodies, lse, torch.from_numpy(delta.copy()))
        return cache[name]

    return get


def _bf16_ulp(x):
    """The spacing of bf16 values at each |x| (8 significant bits)."""
    a = np.abs(x).astype(np.float64)
    e = np.floor(np.log2(np.where(a > 0, a, 1.0)))
    return np.where(a > 0, np.exp2(e - 7), 2.0 ** -133)


def _agreement(got, want):
    """(share of elements equal, the largest |got - want| in bf16 ulps of
    the value, taken no smaller than 1/64 of the tensor's largest: a
    smaller value is a cancellation of larger f32 terms, which the order of
    the sums alone moves by more than its own ulp)."""
    got = got.float().numpy().astype(np.float64)
    diff = np.abs(got - want)
    floor = np.abs(want).max() / 64
    ulp = _bf16_ulp(np.maximum(np.maximum(np.abs(got), np.abs(want)), floor))
    return float((diff == 0).mean()), float((diff / ulp).max())


def _plain(name, lse, delta, mma_sums=False):
    (q, k, v, do), masks, drop = _port_inputs(name)
    causal = CASES[name][1]
    dq = hfp.flash_packed_bwd_dq_reference(q, k, v, do, lse, delta, causal,
                                           None, masks, drop,
                                           mma_sums=mma_sums)
    dk, dv = hfp.flash_packed_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                causal, None, masks, drop,
                                                mma_sums=mma_sums)
    return {"dq": dq, "dk": dk, "dv": dv}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_streamed_backward_rounds_where_pallas_rounds(case,
                                                            pallas_bwd):
    """At least 99% of dq, dk and dv equal JAX's bodies' in bf16, the rest
    within one bf16 ulp; keyless rows give dq = 0 on both sides."""
    want, bodies, lse, delta = pallas_bwd(case)
    assert bodies == ["_bwd_dq_kernel", "_bwd_dkv_kernel"]
    got = _plain(case, lse, delta)
    for g in ("dq", "dk", "dv"):
        assert got[g].dtype == torch.bfloat16
        equal, ulps = _agreement(got[g], want[g])
        assert equal >= 0.99 and ulps <= 1.0, (case, g, equal, ulps)
    if CASES[case][2] == "seg_bias_pad":
        keyless = (lse <= hfp.NEG_INF / 2).transpose(1, 2)   # [B, Sq, H]
        assert int(keyless.sum()) == 40 * H
        assert bool((got["dq"][keyless] == 0).all())
        assert np.all(want["dq"][keyless.numpy()] == 0)


@pytest.mark.parametrize("grad", ["dq", "dk", "dv"])
def test_rounding_pin_catches_a_moved_rounding_point(grad, pallas_bwd,
                                                     monkeypatch):
    """The same check misses the plain versions without one rounding: ds
    left in f32 before ``ds k`` (dq) and ``ds^T q`` (dk), p left in f32
    before ``p^T dO`` (dv)."""
    case = "s256_causal"
    want, _, lse, delta = pallas_bwd(case)
    (q, k, v, do), masks, drop = _port_inputs(case)
    orig = hfp._bwd_p_ds
    # ds is rounded to q's dtype: a float32 q there keeps it in f32
    monkeypatch.setattr(hfp, "_bwd_p_ds",
                        lambda q_, *a, **kw: orig(q_.float(), *a, **kw))
    if grad == "dq":
        got = hfp.flash_packed_bwd_dq_reference(q, k, v, do, lse, delta,
                                                True, None, masks, drop)
    elif grad == "dk":
        got = hfp.flash_packed_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                 True, None, masks, drop)[0]
    else:
        monkeypatch.setattr(hfp, "_bwd_p_ds", orig)
        # p is rounded to do's dtype for the dv product: a float32 do keeps
        # it in f32 (do's values are bf16's either way)
        got = hfp.flash_packed_bwd_dkv_reference(q, k, v, do.float(), lse,
                                                 delta, True, None, masks,
                                                 drop)[1]
    equal, ulps = _agreement(got.bfloat16(), want[grad])
    assert not (equal >= 0.99 and ulps <= 1.0), (grad, equal, ulps)


def _scalar_mma_sum(a, b):
    """One sum of ``mma_dot``'s rule, element by element in exact rational
    arithmetic: steps of 16 products; each step's products and running sum
    truncated toward zero to 2^(E - 25), E their largest exponent (a
    product's the sum of its factors'), added, and the sum truncated toward
    zero to 24 significant bits."""
    def exponent(x):
        return math.frexp(x)[1] - 1

    def trunc(x, lsb):
        return Fraction(math.trunc(x / lsb)) * lsb

    acc = Fraction(0)
    for c in range(0, len(a), 16):
        pairs = [(x, y) for x, y in zip(a[c:c + 16], b[c:c + 16])
                 if x != 0 and y != 0]
        tops = [exponent(x) + exponent(y) for x, y in pairs]
        if acc != 0:
            tops.append(exponent(float(acc)))
        if not tops:
            continue
        lsb = Fraction(2) ** (max(tops) - 25)
        total = sum(trunc(Fraction(x) * Fraction(y), lsb) for x, y in pairs)
        total += trunc(acc, lsb)
        if total == 0:
            acc = Fraction(0)
            continue
        m, e = math.frexp(float(total))       # exact: at most 32 bits
        acc = Fraction(math.trunc(m * 2 ** 24)) * Fraction(2) ** (e - 24)
    return float(acc)


def test_mma_dot_is_the_step_rule_it_states():
    """``mma_dot`` (vectorised, float64) equals the scalar model of its
    rule bit for bit, on bf16 inputs of mixed magnitudes, zeros and signs;
    and it is not a float32 einsum (the rule truncates)."""
    g = torch.Generator().manual_seed(5)
    a = torch.randn(1, 6, 1, 64, generator=g) * torch.exp2(
        torch.randint(-8, 9, (1, 6, 1, 64), generator=g).float())
    b = torch.randn(1, 7, 1, 64, generator=g) * torch.exp2(
        torch.randint(-8, 9, (1, 7, 1, 64), generator=g).float())
    a[0, 1, 0, 20:40] = 0
    b[0, 2, 0, :16] = 0
    a, b = a.bfloat16(), b.bfloat16()
    got = hfp.mma_dot(a, b)
    assert got.dtype == torch.float32 and got.shape == (1, 1, 6, 7)
    for i in range(6):
        for j in range(7):
            want = _scalar_mma_sum(a[0, i, 0].double().tolist(),
                                   b[0, j, 0].double().tolist())
            assert float(got[0, 0, i, j]) == want, (i, j)
    einsum = torch.einsum("bqhd,bkhd->bhqk", a.float(), b.float())
    assert not torch.equal(got, einsum)
    exact = torch.einsum("bqhd,bkhd->bhqk", a.double(), b.double())
    assert float((got.double() - exact).abs().max()) <= \
        1e-5 * float(exact.abs().max())


def test_mma_sums_change_only_the_sums_of_dp(pallas_bwd, monkeypatch):
    """With ``mma_sums`` the plain dq and dk/dv take dp from ``mma_dot`` on
    dO and v (a spy sees it) and round where they did: at least 99% of
    dq, dk and dv equal the default's."""
    case = "s256_causal_dropout"
    _, _, lse, delta = pallas_bwd(case)
    (q, k, v, do), _, _ = _port_inputs(case)
    calls = []
    orig = hfp.mma_dot

    def spy(a, b):
        calls.append((torch.equal(a, do), torch.equal(b, v)))
        return orig(a, b)

    monkeypatch.setattr(hfp, "mma_dot", spy)
    plain = _plain(case, lse, delta)
    assert calls == []
    summed = _plain(case, lse, delta, mma_sums=True)
    assert calls == [(True, True), (True, True)]
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


def _stub_launches(monkeypatch):
    stub = _Stub()
    monkeypatch.setattr(hfp, "_kernel", stub.kernel)
    monkeypatch.setattr(hfp, "_call", stub.call)
    monkeypatch.setattr(hfp, "_require", lambda *a, **kw: None)
    # the inputs report a CUDA device, so the wrappers take the kernel path
    monkeypatch.setattr(hfp, "_bwd_inputs",
                        lambda *a, **kw: torch.device("cuda"))
    for name in ("flash_packed_bwd_dq", "flash_packed_bwd_dq_tc",
                 "flash_packed_bwd_dkv", "flash_packed_bwd_dkv_tc",
                 "flash_packed_bwd_dkv_direct",
                 "flash_packed_bwd_dkv_direct_tc"):
        monkeypatch.setattr(getattr(hfp, name), "launches", 0)
    return stub


def _small(dtype, sq=128, sk=256):
    g = torch.Generator().manual_seed(0)
    q, do = (torch.randn(1, sq, H, 64, generator=g).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(1, sk, H, 64, generator=g).to(dtype)
            for _ in range(2))
    lse = torch.zeros(1, H, sq)
    return q, k, v, do, lse, torch.zeros(1, H, sq)


@pytest.mark.parametrize("dtype,stem,suffix", [
    (torch.bfloat16, "flash_bwd_tc", "_tc"),
    (torch.float16, "flash_bwd_tc", "_tc"),
    (torch.float32, "flash_packed_stream", "")])
def test_streamed_backward_picks_its_body_by_dtype(dtype, stem, suffix,
                                                   monkeypatch):
    """bf16 and float16 dq, dk/dv and dk/dv-direct reach the tensor-core
    entries (K2's and K3's, the same functions at KV heads = heads; K3's
    for dk/dv-direct, its function with all the queries in one tile) and
    their own counts, float32 the CUDA-core ones. Nothing falls back from
    one body to the other."""
    stub = _stub_launches(monkeypatch)
    args = _small(dtype)
    hfp.flash_packed_bwd_dq(*args)
    hfp.flash_packed_bwd_dkv(*args)
    hfp.flash_packed_bwd_dkv_direct(*args)
    code = hfa._DTYPE_CODE[dtype]
    entry = "paddle_flash_bwd_{}_tc" if suffix else \
        "paddle_flash_packed_bwd_{}"
    assert stub.entries == [
        (stem, entry.format("dq"), f"flash_packed_bwd_dq{suffix}", code),
        (stem, entry.format("dkv"), f"flash_packed_bwd_dkv{suffix}", code),
        (stem, entry.format("dkv") if suffix else
         "paddle_flash_packed_bwd_dkv_direct",
         f"flash_packed_bwd_dkv_direct{suffix}", code)]
    tc = suffix == "_tc"
    assert {n: getattr(hfp, n).launches for n in (
        "flash_packed_bwd_dq", "flash_packed_bwd_dq_tc",
        "flash_packed_bwd_dkv", "flash_packed_bwd_dkv_tc",
        "flash_packed_bwd_dkv_direct", "flash_packed_bwd_dkv_direct_tc")} == {
        "flash_packed_bwd_dq": int(not tc), "flash_packed_bwd_dq_tc": int(tc),
        "flash_packed_bwd_dkv": int(not tc),
        "flash_packed_bwd_dkv_tc": int(tc),
        "flash_packed_bwd_dkv_direct": int(not tc),
        "flash_packed_bwd_dkv_direct_tc": int(tc)}


def test_tensor_core_backward_takes_bf16_only(monkeypatch):
    """The ``_tc`` entries refuse float32 on the card (the CUDA-core bodies
    run it) and reach their tensor-core bodies for bf16; rows that are not
    16-byte aligned are refused before any launch."""
    stub = _stub_launches(monkeypatch)
    for fn in (hfp.flash_packed_bwd_dq_tc, hfp.flash_packed_bwd_dkv_tc):
        with pytest.raises(ValueError, match="takes bfloat16"):
            fn(*_small(torch.float32))
        fn(*_small(torch.bfloat16))
    assert [e[2] for e in stub.entries] == ["flash_packed_bwd_dq_tc",
                                            "flash_packed_bwd_dkv_tc"]
    q, k, v, do, lse, delta = _small(torch.bfloat16)
    # a head stride of 4 values: rows start 8 bytes apart
    wide = torch.zeros(1, 128, 2 * H + 1, 64, dtype=torch.bfloat16)
    odd = wide.view(1, 128, -1)[..., 4:4 + H * 64].view(1, 128, H, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        hfp.flash_packed_bwd_dq(odd, k, v, do, lse, delta)
    assert len(stub.entries) == 2
