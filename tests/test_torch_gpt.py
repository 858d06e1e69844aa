"""Port parity: the GPT causal LM with weights carried from the JAX model.

JAX weights go through ``state_dict()`` -> numpy ->
``paddle_tpu_torch.convert.from_jax_state_dict`` into the port's model;
logits of ``forward`` and of ``decode`` match in f32 (atol 1e-4, two layers
of f32 products summed in another order), and greedy ``generate`` is
token-exact.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.text.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.text.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.convert import from_jax_state_dict
from paddle_tpu_torch.text.models.gpt import GPTForCausalLM, gpt_tiny
from _torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-4
VARIANTS = {"mha": {}, "gqa": {"num_kv_heads": 2}}


def jax_state_numpy(model):
    return {k: np.asarray(v) for k, v in model.state_dict().items()}


def carried_pair(**over):
    """(JAX model, port model with the JAX weights), both in eval mode."""
    paddle.seed(11)
    jm = JaxGPT(jax_gpt_tiny(**over))
    jm.eval()
    tm = GPTForCausalLM(gpt_tiny(**over), device="cpu")
    tm.load_state_dict(from_jax_state_dict(jax_state_numpy(jm)), strict=True)
    tm.eval()
    return jm, tm


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def pair(request):
    return carried_pair(**VARIANTS[request.param])


def _ids(b, s, vocab=1024, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def test_forward_logits_match(pair):
    jm, tm = pair
    ids = _ids(2, 24)
    want = np.asarray(jm(jnp.asarray(ids)))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long()).numpy()
    assert got.shape == want.shape == (2, 24, 1024)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_decode_logits_match(pair):
    jm, tm = pair
    ids = _ids(2, 10, seed=1)
    nxt = _ids(2, 1, seed=2)
    jc = jm.gpt.init_cache(2, 16)
    jh, jc = jm.gpt.decode(jnp.asarray(ids), jc, 0)
    jh2, _ = jm.gpt.decode(jnp.asarray(nxt), jc, 10)
    with torch.no_grad():
        tc = tm.gpt.init_cache(2, 16)
        th, tc = tm.gpt.decode(torch.from_numpy(ids).long(), tc, 0)
        th2, _ = tm.gpt.decode(torch.from_numpy(nxt).long(), tc, 10)
        got = [tm.logits(th).numpy(), tm.logits(th2).numpy()]
    want = [np.asarray(jm.logits(jh)), np.asarray(jm.logits(jh2))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL)


def test_generate_token_exact(pair):
    jm, tm = pair
    prompt = _ids(2, 7, seed=3)
    want = np.asarray(jm.generate(jnp.asarray(prompt), max_new_tokens=8))
    got = tm.generate(torch.from_numpy(prompt).long(), max_new_tokens=8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_eos_padding():
    """After an emitted eos the rest of the row is eos (as the JAX
    generate pads it)."""
    _, tm = carried_pair()
    prompt = torch.from_numpy(_ids(1, 5, seed=4)).long()
    free = tm.generate(prompt, max_new_tokens=6)
    eos = int(free[0, 6])           # the second generated token
    out = tm.generate(prompt, max_new_tokens=6, eos_token_id=eos)
    assert out[0, 6] == eos and torch.all(out[0, 6:] == eos)
    assert torch.equal(out[0, :6], free[0, :6])


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_convert_maps_every_key_once(variant):
    """Every JAX state_dict key maps to exactly one port parameter with the
    same shape after transposition; none dropped, none left
    uninitialised."""
    paddle.seed(5)
    jm = JaxGPT(jax_gpt_tiny(**VARIANTS[variant]))
    jsd = jax_state_numpy(jm)
    tm = GPTForCausalLM(gpt_tiny(**VARIANTS[variant]), device="cpu")
    tsd = tm.state_dict()
    conv = from_jax_state_dict(jsd)
    assert set(conv) == set(tsd) == set(jsd)
    assert len(tsd) == len(list(tm.parameters()))
    n_transposed = 0
    for key, arr in jsd.items():
        if conv[key].shape != tsd[key].shape:
            raise AssertionError(f"{key}: {tuple(conv[key].shape)} vs port "
                                 f"{tuple(tsd[key].shape)}")
        if key.endswith(".weight") and arr.ndim == 2 and \
                key.split(".")[-2] not in ("wte", "wpe"):
            np.testing.assert_array_equal(conv[key].numpy(), arr.T)
            n_transposed += 1
        else:
            np.testing.assert_array_equal(conv[key].numpy(), arr)
    n_layers = tm.cfg.num_layers
    per_layer = 4 if variant == "mha" else 5     # qkv|q,kv, out, up, down
    assert n_transposed == n_layers * per_layer
    missing, unexpected = tm.load_state_dict(conv, strict=True)
    assert not missing and not unexpected
    for key, t in tm.state_dict().items():
        torch.testing.assert_close(t, conv[key], atol=0, rtol=0)


def test_entry_points_default_to_the_gpu():
    """``device=None`` means cuda:0: without CUDA it raises instead of
    carrying on on the CPU."""
    if torch.cuda.is_available():
        m = GPTForCausalLM(gpt_tiny(num_layers=1))
        assert m.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPTForCausalLM(gpt_tiny(num_layers=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from paddle_tpu_torch.serving import ServingEngine
        ServingEngine(GPTForCausalLM(gpt_tiny(num_layers=1), device="cpu"))
