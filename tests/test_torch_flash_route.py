"""Port parity: where ``ops.flash_attention`` sends its inputs, the dense
route's function, the ``amp_dtype`` flag, and K1's plain version at JAX's
default tiles.

- The route is decided by head dim alone, before any launch, on the CPU
  as on the card: a head dim in ``SUPPORTED_HEAD_DIMS`` reaches
  ``flash_attention_hopper`` (K1-K4) in every dtype, as JAX's
  ``supported_shapes`` sends float16 to its kernels too; any other
  (``gpt_tiny``'s head dim 32) takes the dense route, which JAX takes for
  such inputs (``reference_attention``, ``_dense_prob_dropout_attention``).
  The dense route matches JAX's ``flash_attention`` on the CPU in the
  forward and the gradients, with and without dropout (the same
  position-hashed mask from the same seed). Float16 at a kernel head dim
  takes K1's plain version on the CPU, which matches JAX's K1 run in
  interpret mode.
- ``set_flags({"amp_dtype": "float16"})`` makes ``decorate`` cast to
  float16, as in JAX, and a float16 GPT forward then matches JAX's through
  the dense route.
- K1's plain version rounds p at 128-key stages (the tensor-core body's);
  JAX's ``_fwd`` rounds it at its own tiles, which by default
  (``_pick_blocks``) are wider. At the smallest S where the default tile is
  wider than 128 keys (S = 256: one 256-key tile at D = 64 and 128) the two
  agree within the bf16 tolerance; the share of o that is bit-equal is
  lower than at JAX's pinned 128/128 (found: 94.8% at D = 128 and 93.1% at
  D = 64, causal, where the same inputs at 128/128 give 99.99%; a wider
  tile, 1024 keys at S = 1024, lowers it further).
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_flash_attention import _inputs, interpreted_pallas

import paddle_tpu as paddle
from paddle_tpu.text.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.text.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch.convert import from_jax_state_dict
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.text.models.gpt import GPTForCausalLM, gpt_tiny

jfa = importlib.import_module("paddle_tpu.ops.flash_attention")
tfa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
hfa = importlib.import_module("paddle_tpu_torch.ops._hopper.flash_attention")

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
          "f16": torch.float16}
JAX_DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16, "f16": jnp.float16}


# (head dim, dtype, the route)
ROUTES = {
    "d32_f32": (32, "f32", "dense"),
    "d32_bf16": (32, "bf16", "dense"),
    "d32_f16": (32, "f16", "dense"),
    "d64_f16": (64, "f16", "kernels"),
    "d128_f16": (128, "f16", "kernels"),
    "d256_f16": (256, "f16", "kernels"),
    "d64_f32": (64, "f32", "kernels"),
    "d64_bf16": (64, "bf16", "kernels"),
    "d128_f32": (128, "f32", "kernels"),
    "d128_bf16": (128, "bf16", "kernels"),
    "d256_f32": (256, "f32", "kernels"),
    "d256_bf16": (256, "bf16", "kernels"),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_route_is_decided_by_head_dim_and_dtype(case, monkeypatch):
    """With ``flash_attention_hopper`` stubbed, a kernel head dim always
    reaches it, whatever the dtype (with and without dropout, in training
    and not), and any other never does: it takes the dense route, which
    counts it."""
    d, dt, route = ROUTES[case]
    calls = []

    def stub(q, k, v, **kw):
        calls.append(kw.get("dropout", 0.0))
        return torch.zeros_like(q)

    monkeypatch.setattr(tfa, "flash_attention_hopper", stub)
    monkeypatch.setattr(tfa.flash_attention, "dense_routes", 0)
    q, k, v = (torch.from_numpy(x).to(DTYPES[dt])
               for x in _inputs(1, 16, 16, 2, 2, d))
    assert tfa.attention_route(q) == route
    tfa.flash_attention(q, k, v, causal=True, training=False)
    tfa.flash_attention(q, k, v, dropout=0.1, causal=False,
                        fixed_seed_offset=3)
    if route == "kernels":
        assert calls == [0.0, 0.1]
        assert tfa.flash_attention.dense_routes == 0
    else:
        assert calls == []
        assert tfa.flash_attention.dense_routes == 2


def test_return_softmax_is_refused_as_in_jax():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 8, 8, 2, 2, 64))
    with pytest.raises(NotImplementedError, match="return_softmax"):
        tfa.flash_attention(q, k, v, return_softmax=True)
    with pytest.raises(NotImplementedError, match="return_softmax"):
        jfa.flash_attention(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                            return_softmax=True)


# (head dim, dtype, kv heads, atol of o, atol of the gradients): float32 to
# its sums' order (found at most 1e-6); float16, whose products and cast of
# p round on both sides, to one float16 ulp of o's values (|o| < 4: 2^-10)
# and of the gradients' (|grad| < 8: 2^-8) (found at most 2.4e-4)
DENSE = {
    "d32_f32": (32, "f32", 2, 2e-5, 2e-5),
    "d32_f32_gqa": (32, "f32", 1, 2e-5, 2e-5),
    "d32_f16": (32, "f16", 2, 2 ** -10, 2 ** -8),
}


@pytest.mark.parametrize("dropout", [0.0, 0.2])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", sorted(DENSE))
def test_dense_route_matches_jax(case, causal, dropout):
    """The dense route against JAX's ``flash_attention`` on the CPU (which
    takes its dense route for every input): o and the gradients of q, k and
    v, with dropout from one pinned seed on both sides."""
    d, dt, hk, atol_o, atol_g = DENSE[case]
    b, s, h = 2, 24, 2
    q, k, v = _inputs(b, s, s, h, hk, d, seed=5)
    w = np.random.default_rng(6).standard_normal((b, s, h, d)).astype(
        np.float32)
    kw = dict(dropout=dropout, causal=causal, training=True,
              fixed_seed_offset=77)

    def jloss(q_, k_, v_):
        out = jfa.flash_attention(q_, k_, v_, **kw)
        return jnp.sum(out.astype(jnp.float32) * w), out

    jx = [jnp.asarray(x, JAX_DTYPES[dt]) for x in (q, k, v)]
    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(*jx)
    tx = [torch.from_numpy(x).to(DTYPES[dt]).requires_grad_()
          for x in (q, k, v)]
    tfa.flash_attention.dense_routes = 0
    hfa.flash_fwd.launches = 0
    out = tfa.flash_attention(*tx, **kw)
    (out.float() * torch.from_numpy(w)).sum().backward()
    assert tfa.flash_attention.dense_routes == 1
    assert hfa.flash_fwd.launches == 0
    assert out.dtype == DTYPES[dt]
    np.testing.assert_allclose(out.float().detach().numpy(),
                               np.asarray(jout.astype(jnp.float32)),
                               atol=atol_o, rtol=0)
    for t, g in zip(tx, jgrads):
        np.testing.assert_allclose(t.grad.float().numpy(),
                                   np.asarray(g.astype(jnp.float32)),
                                   atol=atol_g, rtol=0)


def test_float16_at_a_kernel_head_dim_is_jax_kernels_function():
    """Float16 at head dim 64 with GQA (K1's route in both packages) on the
    CPU: the port's route reaches K1's plain version and matches JAX's
    ``flash_attention_pallas`` run in interpret mode, as JAX runs it on a
    TPU, in o and in the gradients of q, k and v. Both round p and ds to
    float16 at the same points, and only the f32 sums' order differs: o
    and the gradients within 2^-10, one float16 ulp of a value in [1, 2)
    (found: o bit-equal, the gradients at most 2.4e-4 apart, 99.3-99.95%
    of their elements equal). The dense route is not taken."""
    b, s, h, hk, d = 1, 128, 2, 1, 64
    q, k, v = _inputs(b, s, s, h, hk, d, seed=7)
    w = np.random.default_rng(8).standard_normal((b, s, h, d)).astype(
        np.float32)

    def jloss(q_, k_, v_):
        out = fa.flash_attention_pallas(q_, k_, v_, causal=True)
        return jnp.sum(out.astype(jnp.float32) * w), out

    with interpreted_pallas() as fa:
        (_, jout), jgrads = jax.value_and_grad(
            jloss, argnums=(0, 1, 2), has_aux=True)(
                *(jnp.asarray(x, jnp.float16) for x in (q, k, v)))
    tx = [torch.from_numpy(x).half().requires_grad_() for x in (q, k, v)]
    tfa.flash_attention.dense_routes = 0
    out = tfa.flash_attention(*tx, causal=True)
    (out.float() * torch.from_numpy(w)).sum().backward()
    assert tfa.flash_attention.dense_routes == 0
    assert out.dtype == torch.float16
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(jout.astype(jnp.float32)),
                               atol=2 ** -10, rtol=0)
    for t, g in zip(tx, jgrads):
        np.testing.assert_allclose(t.grad.float().numpy(),
                                   np.asarray(g.astype(jnp.float32)),
                                   atol=2 ** -10, rtol=0)


@pytest.fixture
def amp_float16():
    """``amp_dtype`` at float16 in both packages, restored afterwards."""
    saved_t = tflags.flag("amp_dtype")
    saved_j = paddle.get_flags(["amp_dtype"])["amp_dtype"]
    tflags.set_flags({"amp_dtype": "float16"})
    paddle.set_flags({"amp_dtype": "float16"})
    try:
        yield
    finally:
        tflags.set_flags({"amp_dtype": saved_t})
        paddle.set_flags({"amp_dtype": saved_j})


def test_amp_dtype_flag_sets_what_decorate_casts_to(amp_float16):
    """``decorate`` without a dtype takes the flag, as JAX's does (the
    fixture set it with ``set_flags``, which takes the name with or without
    ``FLAGS_``)."""
    tflags.set_flags({"FLAGS_amp_dtype": "float16"})
    assert tflags.get_flags("amp_dtype") == {"amp_dtype": "float16"}
    m = torch.nn.Linear(4, 4)
    assert tamp.decorate(m) is m
    assert all(p.dtype == torch.float16 for p in m.parameters())
    m2 = tamp.decorate(torch.nn.Linear(4, 4), dtype="bfloat16")
    assert all(p.dtype == torch.bfloat16 for p in m2.parameters())


def test_amp_dtype_default_is_bfloat16():
    assert tflags.flag("amp_dtype") == "bfloat16"
    m = tamp.decorate(torch.nn.Linear(4, 4))
    assert all(p.dtype == torch.bfloat16 for p in m.parameters())


def test_float16_gpt_forward_matches_jax(amp_float16):
    """``gpt_tiny`` decorated at the flag's float16 in both packages: the
    port's logits match JAX's (head dim 32 in float16: the dense route on
    both sides), within two float16 ulps of logits below 2 (2^-9; found
    9.8e-4, one ulp, where the two layers' float16 products round apart)."""
    paddle.seed(11)
    jm = JaxGPT(jax_gpt_tiny())
    jm.eval()
    tm = GPTForCausalLM(gpt_tiny(), device="cpu")
    tm.load_state_dict(from_jax_state_dict(
        {k: np.asarray(v) for k, v in jm.state_dict().items()}), strict=True)
    tm.eval()
    jm = paddle.amp.decorate(jm, level="O2")
    tm = tamp.decorate(tm, level="O2")
    assert all(p.dtype == torch.float16 for p in tm.parameters())
    ids = np.random.default_rng(0).integers(0, 1024, (2, 24)).astype(
        np.int32)
    want = np.asarray(jm(jnp.asarray(ids)).astype(jnp.float32))
    tfa.flash_attention.dense_routes = 0
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long()).float().numpy()
    assert tfa.flash_attention.dense_routes == gpt_tiny().num_layers
    assert np.abs(want).max() < 2
    np.testing.assert_allclose(got, want, atol=2 ** -9, rtol=0)


@pytest.mark.parametrize("d", [128, 64])
def test_plain_k1_at_jax_default_tiles(d):
    """``flash_fwd_reference`` (128-key stages) against ``_fwd`` at the
    blocks ``_pick_blocks`` gives (256 x 256 at S = 256), bf16, causal: o
    within 2e-2 + 2e-2 |o|, lse within 1e-2 (1 + |lse|); the bit-equal
    share of o stands in the module's docstring."""
    from paddle_tpu.ops._pallas import flash_attention as pfa
    b, s, h = 1, 256, 2
    block_q, block_k = pfa._pick_blocks(s, s, d)
    assert block_k > 128 and (block_q, block_k) == (256, 256)
    q, k, v = _inputs(b, s, s, h, h, d, seed=9)
    scale = 1.0 / math.sqrt(d)

    def bhsd(x):
        return jnp.asarray(x, jnp.bfloat16).transpose(0, 2, 1, 3).reshape(
            b * h, s, d)

    with interpreted_pallas() as fa:
        jo, jlse = fa._fwd(bhsd(q), bhsd(k), bhsd(v), scale, True, block_q,
                           block_k, h)
    jo = np.asarray(jo.astype(jnp.float32)).reshape(b, h, s, d).transpose(
        0, 2, 1, 3)
    jlse = np.asarray(jlse).reshape(b, h, s)
    to, tlse = hfa.flash_fwd_reference(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v)), True, scale)
    to = to.float().numpy()
    assert np.all(np.abs(to - jo) <= 2e-2 + 2e-2 * np.abs(jo))
    assert np.all(np.abs(tlse.numpy() - jlse) <= 1e-2 * (1 + np.abs(jlse)))
    equal = float((to == jo).mean())
    assert 0.5 < equal < 0.99, equal
