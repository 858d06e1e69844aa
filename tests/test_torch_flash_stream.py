"""Port parity: K4's streamed forms (the forward, dq, dk/dv and dk/dv-direct
kernels' plain versions) against the JAX package's Pallas bodies
``_fwd_kernel``, ``_bwd_dq_kernel``, ``_bwd_dkv_kernel`` and
``_bwd_dkv_kernel_direct`` run in interpret mode on the CPU, and the routing
that chooses them.

Pinned tiles (``block_q = block_k = 128``, which pin both directions in
both packages) make 2 heads stream at 256 keys already: Sq = Sk = 256 runs
the streamed forward, dq and dk/dv; Sq = 128 with Sk = 256 or 384 runs
dk/dv-direct (all queries in one tile), the latter with causal masking on
the offset band. For every case, spies record which JAX body ran (the
kernel function handed to ``pallas_call``) and which plain version the
port ran, and the test asserts they are counterparts. Tolerances: f32 2e-5
on o and lse, 5e-5·max|ref| on each gradient (float32 sums over other
tiles in another order: the port's CUDA-core kernels tile by 64, JAX's by
128); bf16 2e-2 absolute plus 2e-2·|ref| (both round p and ds to bf16, so a
rounding may flip; the bf16 forward's plain version walks 128-key stages,
as the tensor-core body does and as JAX's tiles do when pinned at 128/128;
JAX's default tiles are wider and round p elsewhere, which the bf16
tolerance covers: ``test_torch_flash_route.py``).

Then the routing repairs: ``ops.flash_attention`` reaches K4 at d=64,
``flash_head_pack=0`` sends d=64 to K1 as in JAX, the block pins choose
the forms as JAX's arithmetic does (checked against the bodies JAX launches,
with a ``pallas_call`` that only records and returns zeros), cross-attention
through ``nn.MultiHeadAttention`` against the JAX layer, gradients
included, and what still raises.
"""

import contextlib
import functools
import importlib

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

hfp = importlib.import_module(
    "paddle_tpu_torch.ops._hopper.flash_attention_packed")
hfa = importlib.import_module("paddle_tpu_torch.ops._hopper.flash_attention")
tops_fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
jops_fa = importlib.import_module("paddle_tpu.ops.flash_attention")
TF = importlib.import_module("paddle_tpu_torch.nn.functional")

#: JAX body (module, function) -> the port's form
COUNTERPART = {
    ("flash_attention_packed", "_fwd_kernel"): "flash_packed_fwd_stream",
    ("flash_attention_packed", "_fwd_kernel_direct"): "flash_packed_fwd",
    ("flash_attention_packed", "_bwd_dq_kernel"): "flash_packed_bwd_dq",
    ("flash_attention_packed", "_bwd_dkv_kernel"): "flash_packed_bwd_dkv",
    ("flash_attention_packed", "_bwd_dkv_kernel_direct"):
        "flash_packed_bwd_dkv_direct",
    ("flash_attention_packed", "_bwd_fused_kernel"): "flash_packed_bwd",
    ("flash_attention", "_fwd_kernel"): "flash_fwd",
    ("flash_attention", "_bwd_dq_kernel"): "flash_bwd_dq",
    ("flash_attention", "_bwd_dkv_kernel"): "flash_bwd_dkv",
}
PORT_FORMS = ("flash_packed_fwd", "flash_packed_bwd",
              "flash_packed_fwd_stream", "flash_packed_bwd_dq",
              "flash_packed_bwd_dkv", "flash_packed_bwd_dkv_direct")


def _body(kernel):
    fn = kernel.func if isinstance(kernel, functools.partial) else kernel
    return fn.__module__.rsplit(".", 1)[-1], fn.__name__


@contextlib.contextmanager
def jax_pallas(bodies, interpret=True, outputs=None):
    """The JAX package's Pallas calls in interpret mode on the CPU (or, with
    ``interpret=False``, not run at all: zeros of the output shapes), each
    body appended to ``bodies`` and, given ``outputs``, each call's outputs
    to it."""
    from paddle_tpu.ops._pallas import flash_attention as fa
    from paddle_tpu.ops._pallas import flash_attention_packed as fp
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def call(kernel, *args, **kwargs):
        bodies.append(_body(kernel))
        if interpret:
            kwargs.setdefault("interpret", True)
            fn = orig(kernel, *args, **kwargs)

            def run(*xs):
                out = fn(*xs)
                if outputs is not None:
                    outputs.append(out)
                return out
            return run
        out_shape = kwargs["out_shape"]

        def zeros(*_):
            if isinstance(out_shape, (list, tuple)):
                return [jnp.zeros(s.shape, s.dtype) for s in out_shape]
            return jnp.zeros(out_shape.shape, out_shape.dtype)
        return zeros

    pl.pallas_call = fa.pl.pallas_call = fp.pl.pallas_call = call
    try:
        yield fp
    finally:
        pl.pallas_call = fa.pl.pallas_call = fp.pl.pallas_call = orig


@contextlib.contextmanager
def port_forms():
    """The port's forms that run, in order: a spy on each plain version
    (CPU tensors reach only those) and on K1-K3's."""
    calls = []
    saved = []
    spied = [(hfp, n + "_reference") for n in PORT_FORMS] + \
        [(hfa, "flash_fwd_reference"), (hfa, "flash_bwd_reference")]
    for mod, name in spied:
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            calls.append(_name[:-len("_reference")])
            return _fn(*a, **kw)

        saved.append((mod, name, fn))
        setattr(mod, name, wrapped)
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


# (b, sq, sk, h, causal, dtype, mask, (block_q, block_k))
PIN = (128, 128)
CASES = {
    "f32_s256_nomask": (1, 256, 256, 2, False, "f32", None, PIN),
    "f32_s256_key_bias": (1, 256, 256, 2, False, "f32", "bias", PIN),
    "f32_s256_segments": (1, 256, 256, 2, False, "f32", "seg", PIN),
    "f32_s256_causal": (1, 256, 256, 2, True, "f32", None, PIN),
    "f32_s256_causal_segments_bias": (1, 256, 256, 2, True, "f32",
                                      "seg_bias", PIN),
    "f32_sq128_sk256_segment_ids_k": (1, 128, 256, 2, False, "f32", "segk",
                                      PIN),
    "f32_sq128_sk384_causal": (1, 128, 384, 2, True, "f32", None, PIN),
    "f32_sq128_sk384_causal_segments_bias": (1, 128, 384, 2, True, "f32",
                                             "segk_bias", PIN),
    "bf16_s256_key_bias": (1, 256, 256, 2, False, "bf16", "bias", PIN),
    "bf16_sq128_sk256_segment_ids_k": (1, 128, 256, 2, False, "bf16",
                                       "segk", PIN),
    # the 16-head case: JAX's tiles at dp = 1024 stream S = 512 unpinned
    "f32_h16_s512_causal": (1, 512, 512, 16, True, "f32", None, None),
}


def _inputs(name):
    """numpy q, k, v, do and the masks of a case (seed 0). Segment ids make
    rows hold up to three segments; ``segk`` gives the keys ids of their
    own (0-2 against 1-3), so the query rows of segment 3 find no key; the
    key bias is bench.py's padding bias on a random length per row plus
    noise."""
    b, sq, sk, h, causal, dtype, mask, _ = CASES[name]
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((b, s, h, 64)).astype(np.float32)
               for s in (sq, sk, sk))
    do = rng.standard_normal((b, sq, h, 64)).astype(np.float32)
    seg_q = seg_k = bias = None
    if mask in ("seg", "segk", "seg_bias", "segk_bias"):
        seg_q = np.sort(rng.integers(1, 4, (b, sq)), axis=1).astype(np.int32)
        seg_k = seg_q if sq == sk else None
        if mask.startswith("segk"):
            seg_k = np.sort(rng.integers(0, 3, (b, sk)), axis=1).astype(
                np.int32)
    if mask in ("bias", "seg_bias", "segk_bias"):
        lengths = rng.integers(sk // 4, sk + 1, b)
        pad = np.arange(sk)[None, :] >= lengths[:, None]
        bias = (np.where(pad, -1e9, 0.0) +
                rng.standard_normal((b, sk))).astype(np.float32)
    return (q, k, v, do), (seg_q, seg_k, bias)


def _jdt(dtype):
    return jnp.bfloat16 if dtype == "bf16" else jnp.float32


def _tdt(dtype):
    return torch.bfloat16 if dtype == "bf16" else torch.float32


def _blocks(name):
    pins = CASES[name][7]
    return {} if pins is None else {"block_q": pins[0], "block_k": pins[1]}


@pytest.fixture(scope="module")
def pallas_results():
    """Each case's JAX results, computed once for the module: o and the
    ``jax.vjp`` gradients of ``flash_attention_packed`` in interpret mode,
    the bodies they ran, and lse as the forward body wrote it (packed
    ``[B*H/G, Sq, G]``, unpacked to ``[B, H, Sq]``)."""
    cache = {}

    def get(name):
        if name in cache:
            return cache[name]
        (q, k, v, do), (seg_q, seg_k, bias) = _inputs(name)
        b, sq, sk, h, causal, dtype = CASES[name][:6]
        jq, jk, jv, jdo = (jnp.asarray(x, _jdt(dtype)) for x in (q, k, v, do))
        kw = dict(causal=causal, key_bias=bias, segment_ids=seg_q,
                  segment_ids_k=seg_k, **_blocks(name))
        bodies, outputs = [], []
        with jax_pallas(bodies, outputs=outputs) as fp:
            o, vjp = jax.vjp(lambda a, b_, c: fp.flash_attention_packed(
                a, b_, c, **kw), jq, jk, jv)
            grads = vjp(jdo)
            g = fp.pack_group(h)
        ran = [COUNTERPART[body] for body in bodies]
        lse = np.asarray(outputs[0][1]).reshape(b, h // g, sq, g).transpose(
            0, 1, 3, 2).reshape(b, h, sq)
        out = {"o": o, "lse": lse, "dq": grads[0], "dk": grads[1],
               "dv": grads[2]}
        cache[name] = ({n: np.asarray(jnp.asarray(x).astype(jnp.float32))
                        for n, x in out.items()}, ran)
        return cache[name]

    return get


def _port(name):
    """The port's o and gradients through ``flash_attention_packed`` (with
    the case's pins), the forms it ran, and lse from the forward form that
    ran."""
    (q, k, v, do), (seg_q, seg_k, bias) = _inputs(name)
    causal, dtype = CASES[name][4:6]
    tq, tk, tv = (torch.from_numpy(x).to(_tdt(dtype)).requires_grad_()
                  for x in (q, k, v))
    kw = dict(causal=causal,
              segment_ids=None if seg_q is None else torch.from_numpy(seg_q),
              segment_ids_k=None if seg_k is None else torch.from_numpy(seg_k),
              key_bias=None if bias is None else torch.from_numpy(bias))
    with port_forms() as ran:
        o = hfp.flash_attention_packed(tq, tk, tv, **kw, **_blocks(name))
        o.backward(torch.from_numpy(do).to(_tdt(dtype)))
    masks = hfp._masks(q.shape[0], q.shape[1], k.shape[1], tq.device,
                       kw["segment_ids"], kw["segment_ids_k"], kw["key_bias"])
    fwd = getattr(hfp, ran[0])
    _, lse = fwd(tq.detach(), tk.detach(), tv.detach(), causal, None, masks)
    return {"o": o, "lse": lse, "dq": tq.grad, "dk": tk.grad,
            "dv": tv.grad}, ran


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
def test_port_runs_the_counterpart_of_the_body_jax_runs(case,
                                                        pallas_results):
    """The forms the port ran, in order, are the counterparts of the
    Pallas bodies JAX ran: the streamed forward, dq and dk/dv, or
    dk/dv-direct where all the queries fit one JAX tile."""
    _, jax_ran = pallas_results(case)
    _, ran = _port(case)
    assert ran == jax_ran
    direct = CASES[case][1] == 128 and CASES[case][2] > 128
    assert ran == ["flash_packed_fwd_stream", "flash_packed_bwd_dq",
                   "flash_packed_bwd_dkv_direct" if direct else
                   "flash_packed_bwd_dkv"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_stream_forward_matches_pallas(case, pallas_results):
    want, _ = pallas_results(case)
    got, _ = _port(case)
    dtype = CASES[case][5]
    assert got["o"].dtype == _tdt(dtype) and got["lse"].dtype == torch.float32
    _close(got["o"], want["o"], dtype, f"{case} o", grad=False)
    _close(got["lse"], want["lse"], dtype, f"{case} lse", grad=False)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_stream_grads_match_pallas_vjp(case, pallas_results):
    want, _ = pallas_results(case)
    got, _ = _port(case)
    for g in ("dq", "dk", "dv"):
        _close(got[g], want[g], CASES[case][5], f"{case} {g}", grad=True)
    if CASES[case][6] in ("segk", "segk_bias"):
        # a query row whose segment id no key has: o = 0 and dq = 0
        _, (seg_q, seg_k, _) = _inputs(case)
        empty = ~(seg_q[:, :, None] == seg_k[:, None, :]).any(-1)
        assert empty.any()
        assert np.all(got["dq"].float().numpy()[empty] == 0)
        assert np.all(got["o"].detach().float().numpy()[empty] == 0)


@pytest.mark.parametrize("case", ["bf16_s256_key_bias",
                                  "f32_s256_causal_segments_bias",
                                  "bf16_sq128_sk256_segment_ids_k"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_plain_stream_forward_is_the_plain_k1(case, rate, monkeypatch):
    """K4a-stream's function is K1's at head dim 64 with as many KV heads
    as heads: its plain version is one call to K1's (same stages, same
    rounding), not a copy. The call is seen through a spy, and the result
    equals K1's plain version bit for bit, with masks and dropout."""
    (q, k, v, _), (seg_q, seg_k, bias) = _inputs(case)
    causal, dtype = CASES[case][4:6]
    tq, tk, tv = (torch.from_numpy(x).to(_tdt(dtype)) for x in (q, k, v))
    masks = hfp._masks(q.shape[0], q.shape[1], k.shape[1], tq.device,
                       *(None if x is None else torch.from_numpy(x)
                         for x in (seg_q, seg_k, bias)))
    drop = hfa.as_dropout(rate, 77)
    calls = []

    def spy(*a, **kw):
        calls.append(kw.get("first_head"))
        return hfa.flash_fwd_reference(*a, **kw)

    monkeypatch.setattr(hfp, "flash_fwd_reference", spy)
    o, lse = hfp.flash_packed_fwd_stream_reference(tq, tk, tv, causal, None,
                                                   masks, drop, first_head=3)
    assert calls == [3]
    ro, rlse = hfa.flash_fwd_reference(tq, tk, tv, causal, None, drop,
                                       first_head=3, masks=masks)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)


def test_pick_blocks_matches_jax():
    from paddle_tpu.ops._pallas.flash_attention_packed import \
        _pick_blocks_packed
    for dp in (128, 256, 768, 1024):
        for sq in (128, 200, 256, 384, 512, 640, 1024, 2048):
            for sk in (128, 256, 384, 512, 640, 768, 1024, 2048):
                for bwd in (False, True):
                    assert hfp._pick_blocks_packed(sq, sk, dp, bwd) == \
                        _pick_blocks_packed(sq, sk, dp, bwd), \
                        (sq, sk, dp, bwd)


PLAN_SHAPES = [
    # (sq, sk, h, block_q, block_k)
    (512, 512, 12, None, None), (2048, 2048, 12, None, None),
    (512, 2048, 12, None, None), (1024, 1024, 2, None, None),
    (256, 640, 2, None, None), (640, 640, 12, None, None),
    (512, 512, 16, None, None), (256, 256, 16, None, None),
    (256, 512, 16, None, None), (256, 256, 2, 128, 128),
    (128, 256, 2, 128, 128), (256, 128, 2, 128, 128),
    (512, 512, 2, 256, None), (512, 512, 2, None, 256),
    (1024, 1024, 4, 512, 1024), (384, 768, 6, 128, 256),
]


@pytest.mark.parametrize("shape", PLAN_SHAPES,
                         ids=lambda s: "sq{}_sk{}_h{}_bq{}_bk{}".format(*s))
def test_plan_picks_the_forms_jax_launches(shape):
    """``plan`` against the Pallas bodies JAX's ``flash_attention_packed``
    launches for the same lengths, heads and pins (bodies recorded, not
    run): unpinned at 12 heads Sk <= 512 is direct and fused, Sk > 512
    streams, with dk/dv-direct when Sq <= 512; at 16 heads JAX streams from
    S = 512 on; pins choose the forms of both directions."""
    sq, sk, h, bq, bk = shape
    bodies = []
    x = jnp.zeros((1, sq, h, 64))
    y = jnp.zeros((1, sk, h, 64))
    with jax_pallas(bodies, interpret=False) as fp:
        _, vjp = jax.vjp(lambda a, b_, c: fp.flash_attention_packed(
            a, b_, c, block_q=bq, block_k=bk), x, y, y)
        vjp(jnp.zeros((1, sq, h, 64)))
    jax_forms = [COUNTERPART[b] for b in bodies]
    forms = hfp.plan(sq, sk, h, bq, bk)
    port = [{"direct": "flash_packed_fwd",
             "stream": "flash_packed_fwd_stream"}[forms.fwd]]
    if forms.bwd == "fused":
        port.append("flash_packed_bwd")
    else:
        port += ["flash_packed_bwd_dq", "flash_packed_bwd_dkv_direct"
                 if forms.dkv == "direct" else "flash_packed_bwd_dkv"]
    assert port == jax_forms


def test_pins_that_do_not_divide_raise_as_in_jax():
    with pytest.raises(ValueError, match="divisible by blocks"):
        hfp.plan(384, 384, 2, 256, None)
    z = torch.zeros(1, 384, 2, 64)
    with pytest.raises(ValueError, match="divisible by blocks"):
        hfp.flash_attention_packed(z, z, z, block_q=256)


# -- the routing repairs ------------------------------------------------------

def _qkv(b, s, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(3)]


@contextlib.contextmanager
def entry_spy(monkeypatch):
    """Which kernel entry ``flash_attention_hopper`` reaches: K4's
    ``flash_attention_packed`` or K1's ``flash_fwd``."""
    calls = []
    for mod, name in ((hfp, "flash_attention_packed"), (hfa, "flash_fwd")):
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*a, **kw)

        monkeypatch.setattr(mod, name, wrapped)
    yield calls


@pytest.mark.parametrize("d,heads,route", [(64, 12, "flash_attention_packed"),
                                           (128, 2, "flash_fwd")])
def test_ops_flash_attention_reaches_k4_at_d64(d, heads, route, monkeypatch):
    """``ops.flash_attention`` routes as JAX's ``flash_attention_pallas``:
    d=64 MHA at lengths that are multiples of 128 reaches K4's entry, d=128
    K1's. Against the JAX function (its reference path on the CPU), f32:
    2e-5."""
    q, k, v = _qkv(1, 128, heads, d, seed=d)
    want = np.asarray(jops_fa.flash_attention(
        *(jnp.asarray(x) for x in (q, k, v)), causal=True, training=False))
    with entry_spy(monkeypatch) as calls:
        got = tops_fa.flash_attention(*(torch.from_numpy(x)
                                        for x in (q, k, v)),
                                      causal=True, training=False)
    assert calls == [route]
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def test_flash_head_pack_flag_routes_as_in_jax(monkeypatch):
    """``flash_head_pack`` exists with JAX's default (1); at 0 a d=64 input
    takes K1 in the port as ``flash_attention_pallas`` takes its unpacked
    kernel in JAX, and K1 takes a key mask there as the JAX function does
    (f32 within 1e-5 + 1e-5·|ref|)."""
    assert tflags.flag("flash_head_pack") == 1 == \
        jflags.flag("flash_head_pack")
    q, k, v = _qkv(1, 128, 2, 64, seed=5)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    from paddle_tpu.ops._pallas.flash_attention import flash_attention_pallas
    tflags.set_flags({"FLAGS_flash_head_pack": 0})
    jflags.set_flags({"flash_head_pack": 0})
    try:
        bodies = []
        with jax_pallas(bodies, interpret=False):
            flash_attention_pallas(*(jnp.asarray(x) for x in (q, k, v)))
        assert [COUNTERPART[b] for b in bodies] == ["flash_fwd"]
        with entry_spy(monkeypatch) as calls:
            got = hfa.flash_attention_hopper(tq, tk, tv)
        assert calls == ["flash_fwd"]
        att = np.arange(128)[None, :] < 100
        with entry_spy(monkeypatch) as calls:
            masked = TF.scaled_dot_product_attention(
                tq, tk, tv, attn_mask=torch.from_numpy(att))
        assert calls == ["flash_fwd"]
        want = JF.scaled_dot_product_attention(
            *(jnp.asarray(x) for x in (q, k, v)),
            attn_mask=jnp.asarray(att)[:, None, None, :])
        np.testing.assert_allclose(masked.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)
    finally:
        tflags.set_flags({"flash_head_pack": 1})
        jflags.set_flags({"flash_head_pack": 1})
    with entry_spy(monkeypatch) as calls:
        packed = hfa.flash_attention_hopper(tq, tk, tv)
    assert calls == ["flash_attention_packed"]
    np.testing.assert_allclose(got.numpy(), packed.numpy(), atol=2e-5)


@pytest.mark.parametrize("sk,forms", [
    (256, ["flash_packed_fwd", "flash_packed_bwd"]),
    (640, ["flash_packed_fwd_stream", "flash_packed_bwd_dq",
           "flash_packed_bwd_dkv_direct"])])
def test_cross_attention_layer_matches_jax_with_grads(sk, forms):
    """``nn.MultiHeadAttention(128, 2)`` with a 128-token query over keys of
    another sequence against the JAX layer (its dense path on the CPU), on
    the same weights: at 256 keys the port runs K4a-direct and K4b-fused,
    at 640 the streamed forward, dq and dk/dv-direct, as JAX's kernels
    would on a TPU. f32: output within 2e-5, every gradient within
    5e-5·max|ref|; the key projection's bias has a true gradient of 0
    (softmax ignores a constant added to all of a row's scores), so both
    sides hold rounding noise there, held on the scale of the key weight's
    gradient."""
    paddle.seed(4)
    jl = jnn.MultiHeadAttention(128, 2)
    tl = MultiHeadAttention(128, 2, device="cpu")
    tl.load_state_dict(from_jax_state_dict(
        {k: np.asarray(v) for k, v in jl.state_dict().items()}), strict=True)
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 128, 128)).astype(np.float32)
    kv = rng.standard_normal((2, sk, 128)).astype(np.float32)
    dout = rng.standard_normal((2, 128, 128)).astype(np.float32)

    def jloss(p, a, b_):
        return jnp.sum(functional_call(jl, p, a, b_, b_) * dout)

    want = np.asarray(jl(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv)))
    wg, wq, wkv = jax.grad(jloss, argnums=(0, 1, 2))(
        get_params(jl), jnp.asarray(q), jnp.asarray(kv))
    tq, tkv = (torch.from_numpy(x).requires_grad_() for x in (q, kv))
    with port_forms() as ran:
        got = tl(tq, tkv, tkv)
        got.backward(torch.from_numpy(dout))
    assert ran == forms
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-5, rtol=0)
    grads = to_jax_state_dict({n: p.grad for n, p in tl.named_parameters()})
    grads.update(x_query=tq.grad.numpy(), x_kv=tkv.grad.numpy())
    wanted = {**{n: np.asarray(g) for n, g in wg.items()},
              "x_query": np.asarray(wq), "x_kv": np.asarray(wkv)}
    assert set(grads) == set(wanted)
    for name, g in grads.items():
        w = wanted[name]
        scale = wanted["k_proj.weight"] if name == "k_proj.bias" else w
        atol = 5e-5 * float(np.abs(scale).max())
        np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=name)


def test_streamed_forms_refuse_what_they_do_not_take():
    """A dropout rate of 1 raises (a kept probability would be scaled by
    1/0); the kernel launchers take CUDA tensors only (checked before a
    pointer reaches a kernel, with no fall back to the plain version);
    dk/dv-direct's kernel takes at most 512 queries."""
    z = torch.zeros
    q, kv = z(1, 128, 2, 64), z(1, 640, 2, 64)
    with pytest.raises(ValueError, match="rate must be below 1"):
        hfp.flash_attention_packed(q, kv, kv, dropout=1.0)
    lse = z(1, 2, 128)
    with pytest.raises(ValueError, match="CUDA tensors"):
        hfp._launch_fwd_stream(q, kv, kv, False, 0.125, (None, None, None))
    for which in ("dq", "dkv", "dkv_direct"):
        with pytest.raises(ValueError, match="CUDA tensors"):
            hfp._launch_bwd_split(which, q, kv, kv, q, lse, lse, False,
                                  0.125, (None, None, None))
    assert hfp.MAX_SEQ_Q_DIRECT == 512
