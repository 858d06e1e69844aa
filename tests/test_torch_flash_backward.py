"""Port parity: K2 and K3 (the flash-attention backward) and their wiring.

The plain PyTorch K2/K3 (``flash_bwd_reference``) is held against the JAX
Pallas backward ``_bwd`` run in interpret mode on the CPU, in dq, dk and
dv, on the same q, k, v, do and the same (o, lse) from the Pallas forward.
Tolerances are the reference's own for its kernel gradients
(``tests/test_flash_attention.py``): f32 atol 5e-4, bf16 atol and rtol
5e-2. Then the gradients of the port's ``flash_attention`` (autograd through
``_FlashFwd.backward``, i.e. ``flash_bwd``) against ``jax.grad`` of the JAX
``reference_attention``. The CUDA kernels themselves run only on a GPU
(``chip_smoke.py`` holds them against this plain version there).
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_flash_attention import _inputs, _to_jax, _to_torch, \
    interpreted_pallas
from _torch_threads import one_torch_thread  # noqa: F401

jfa = importlib.import_module("paddle_tpu.ops.flash_attention")
tfa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
hfa = importlib.import_module("paddle_tpu_torch.ops._hopper.flash_attention")

# (b, sq, sk, h, hk, d, causal, dtype, with_dlse)
BWD_CASES = {
    "f32_noncausal": (1, 256, 256, 2, 2, 64, False, "f32", False),
    "f32_causal": (1, 256, 256, 2, 2, 64, True, "f32", False),
    "bf16_noncausal": (1, 256, 256, 2, 2, 64, False, "bf16", False),
    "bf16_causal": (1, 256, 256, 2, 2, 64, True, "bf16", False),
    "gqa_causal": (2, 128, 128, 4, 2, 64, True, "f32", False),
    "sq_lt_sk_bottom_right": (1, 128, 256, 2, 2, 64, True, "f32", False),
    "fully_masked_rows": (1, 256, 128, 2, 2, 64, True, "f32", False),
    "d128_causal": (1, 128, 128, 2, 2, 128, True, "f32", False),
    "dlse_given": (1, 128, 128, 2, 2, 64, True, "f32", True),
}


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_plain_k2_k3_match_pallas_bwd(case):
    b, sq, sk, h, hk, d, causal, dtype, with_dlse = BWD_CASES[case]
    q, k, v = _inputs(b, sq, sk, h, hk, d)
    rng = np.random.default_rng(1)
    do = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    dlse = rng.standard_normal((b, h, sq)).astype(np.float32) \
        if with_dlse else None
    scale = 1.0 / math.sqrt(d)

    def bhsd(x, s, heads):
        return _to_jax(x, dtype).transpose(0, 2, 1, 3).reshape(b * heads, s, d)

    def unflat(x, s, heads):
        x = np.array(jnp.asarray(x).astype(jnp.float32))
        return x.reshape(b, heads, s, d).transpose(0, 2, 1, 3)

    with interpreted_pallas() as fa:
        jq, jk, jv, jdo = (bhsd(q, sq, h), bhsd(k, sk, hk), bhsd(v, sk, hk),
                           bhsd(do, sq, h))
        jo, jlse = fa._fwd(jq, jk, jv, scale, causal, 128, 128, h)
        jdlse = None if dlse is None else \
            jnp.asarray(dlse.reshape(b * h, 1, sq))
        jdq, jdk, jdv = fa._bwd(jq, jk, jv, jo, jlse, jdo, scale, causal,
                                128, 128, h, dlse=jdlse)

    # the same o and lse go into the port's backward
    o = _to_torch(unflat(jo, sq, h), dtype)
    lse = torch.from_numpy(np.asarray(jlse).reshape(b, h, sq))
    tdq, tdk, tdv = hfa.flash_bwd(
        _to_torch(q, dtype), _to_torch(k, dtype), _to_torch(v, dtype), o,
        lse, _to_torch(do, dtype), causal, scale,
        dlse=None if dlse is None else torch.from_numpy(dlse))
    assert tdq.dtype == _to_torch(q, dtype).dtype
    assert tdq.shape == (b, sq, h, d) and tdk.shape == (b, sk, hk, d) \
        and tdv.shape == (b, sk, hk, d)
    tol = dict(atol=5e-2, rtol=5e-2) if dtype == "bf16" else dict(atol=5e-4)
    np.testing.assert_allclose(tdq.float().numpy(), unflat(jdq, sq, h), **tol)
    np.testing.assert_allclose(tdk.float().numpy(), unflat(jdk, sk, hk), **tol)
    np.testing.assert_allclose(tdv.float().numpy(), unflat(jdv, sk, hk), **tol)
    if case == "fully_masked_rows":
        # rows 0..127 see no key (lse = NEG_INF): their dq is exactly 0
        assert np.all(tdq[:, :sq - sk].numpy() == 0)
    if case == "dlse_given":
        # the lse cotangent moves the gradients (it is folded into delta)
        plain = hfa.flash_bwd(*(torch.from_numpy(x) for x in (q, k, v)), o,
                              lse, torch.from_numpy(do), causal, scale)
        assert float((plain[0] - tdq).abs().max()) > 1e-3


# (b, sq, sk, h, hk, d, causal)
GRAD_CASES = {
    "ragged_causal": (2, 37, 37, 4, 4, 16, True),
    "ragged_gqa_causal": (1, 45, 45, 4, 2, 16, True),
    "ragged_noncausal_sq_ne_sk": (2, 29, 53, 2, 1, 8, False),
    "sq_gt_sk_masked_rows": (1, 50, 30, 2, 2, 8, True),
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_flash_attention_grads_match_jax_reference(case):
    """Autograd through the port's flash_attention (``flash_bwd``, whose
    CPU path is the plain K2/K3) against ``jax.grad`` of the JAX dense
    reference, at ragged lengths. f32 atol 2e-5: the same sums taken in
    another order."""
    b, sq, sk, h, hk, d, causal = GRAD_CASES[case]
    q, k, v = _inputs(b, sq, sk, h, hk, d, seed=4)
    w = np.random.default_rng(5).standard_normal((b, sq, h, d)).astype(
        np.float32)

    def jloss(q, k, v):
        return jnp.sum(jfa.reference_attention(q, k, v, causal=causal) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x)
                                                for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=causal)
    (out * torch.from_numpy(w)).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


def test_backward_runs_flash_bwd_not_autograd_through_the_plain_forward(
        monkeypatch):
    """The gradient comes from ``_FlashFwd.backward`` -> ``flash_bwd``
    (here its plain version), once per attention call, and launches no
    kernel on the CPU."""
    calls = []
    orig = hfa.flash_bwd_reference

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return orig(*args, **kwargs)

    monkeypatch.setattr(hfa, "flash_bwd_reference", spy)
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _inputs(1, 24, 24, 2, 2, 64))
    hfa.flash_fwd.launches = hfa.flash_bwd_dq.launches = 0
    hfa.flash_bwd_dkv.launches = 0
    out = tfa.flash_attention(q, k, v, causal=True)
    assert type(out.grad_fn).__name__ == "_FlashFwdBackward"
    out.sum().backward()
    assert calls == [(1, 24, 2, 64)]
    assert (hfa.flash_fwd.launches, hfa.flash_bwd_dq.launches,
            hfa.flash_bwd_dkv.launches) == (0, 0, 0)
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in (q, k, v))


def test_flash_bwd_argument_checks():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 8, 8, 2, 2, 64))
    o, lse = hfa.flash_fwd_reference(q, k, v, True)
    do = torch.ones_like(o)
    with pytest.raises(ValueError, match="must have q's shape"):
        hfa.flash_bwd(q, k, v, o[:, :4], lse, do)
    with pytest.raises(ValueError, match=r"lse must be \[B, H, Sq\]"):
        hfa.flash_bwd(q, k, v, o, lse[:, :1], do)
    # the kernel wrappers take CUDA tensors only: flash_bwd is the entry
    # that runs the plain version on the CPU
    delta = hfa._delta(o, do)
    with pytest.raises(ValueError, match="run on CUDA tensors"):
        hfa.flash_bwd_dq(q, k, v, do, lse, delta, True, 0.125)
    with pytest.raises(ValueError, match="run on CUDA tensors"):
        hfa.flash_bwd_dkv(q, k, v, do, lse, delta, True, 0.125)
    # what the kernels refuse, checked before any launch
    assert hfa._bwd_arg_error(q, k, v, do) is None
    assert "do's dtype" in hfa._bwd_arg_error(q, k, v, do.bfloat16())
    strided = torch.zeros(1, 8, 2, 128)[..., ::2]
    assert "not dense" in hfa._bwd_arg_error(q, k, v, strided)
