"""Port parity: sampling in ``GPTForCausalLM.generate``.

The JAX model samples with ``jax.random.categorical``, which is
``argmax(logits + gumbel(key, logits.shape, logits.dtype))``; its keys are
``key = PRNGKey(seed)`` then ``key, sub = split(key)`` once for the first
token and once for each step after. The test rebuilds those ``sub`` keys
and their ``jax.random.gumbel`` draws outside ``generate`` and hands the
same arrays to the port through ``gumbel_noise`` (the one function the
port draws through), then asserts the tokens equal JAX's ``generate`` on
``gpt_tiny`` with JAX's weights: greedy, temperature only, top-k, top-p,
both, with ``eos_token_id``, and ``top_p`` at the edge where no prefix of
the sorted softmax reaches it. The filters are also held on crafted
logits: ties at the k-th value all survive, and at the edge nothing is
cut (JAX's ``take_along_axis`` gives NaN past the end). Nothing in the
JAX package changes for this.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.text.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.text.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.convert import from_jax_state_dict
from paddle_tpu_torch.text.models import gpt as tgpt
from _torch_threads import one_torch_thread  # noqa: F401

CFG = dict(vocab_size=128, hidden_size=48, num_layers=2, num_heads=4,
           max_position_embeddings=64)
B, PROMPT, NEW = 3, 7, 9


@pytest.fixture(scope="module")
def pair():
    paddle.seed(5)
    jm = JaxGPT(jax_gpt_tiny(**CFG))
    jm.eval()
    tm = tgpt.GPTForCausalLM(tgpt.gpt_tiny(**CFG), device="cpu")
    tm.load_state_dict(from_jax_state_dict(
        {k: np.asarray(v) for k, v in jm.state_dict().items()}))
    return jm, tm.eval()


@pytest.fixture(scope="module")
def prompt():
    return np.random.default_rng(0).integers(0, CFG["vocab_size"],
                                             (B, PROMPT))


def jax_draws(seed, n, shape, dtype=jnp.float32):
    """The Gumbel draws JAX's ``generate`` adds to its logits: one for the
    first token, one for each step after, from the same key chain."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.gumbel(sub, shape, dtype)))
    return out


def run_pair(pair, prompt, monkeypatch, **kw):
    """JAX's ``generate`` (jitted) and the port's on JAX's draws; returns
    both token arrays and how many draws the port took."""
    jm, tm = pair
    want = np.asarray(jax.jit(lambda ids: jm.generate(
        ids, max_new_tokens=NEW, **kw))(jnp.asarray(prompt)))
    draws = jax_draws(kw.get("seed", 0), NEW, (B, CFG["vocab_size"]))
    taken = []

    def handed(shape, dtype, generator):
        assert tuple(shape) == draws[len(taken)].shape
        taken.append(1)
        return torch.from_numpy(np.array(draws[len(taken) - 1])).to(dtype)

    monkeypatch.setattr(tgpt, "gumbel_noise", handed)
    got = tm.generate(torch.from_numpy(prompt), max_new_tokens=NEW,
                      **kw).numpy()
    return want, got, len(taken)


MODES = {
    "greedy": dict(),
    "greedy_temperature": dict(temperature=0.5),
    "temperature": dict(do_sample=True, temperature=0.7, seed=3),
    "top_k": dict(do_sample=True, top_k=5, seed=4),
    "top_p": dict(do_sample=True, top_p=0.8, seed=5),
    "top_k_top_p": dict(do_sample=True, temperature=0.8, top_k=20,
                        top_p=0.9, seed=6),
    "eos": dict(do_sample=True, temperature=1.3, seed=7),
    "top_p_edge": dict(do_sample=True, top_p=1.0 - 1e-9, seed=8),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_generate_matches_jax_under_shared_draws(pair, prompt, mode,
                                                 monkeypatch):
    """Token for token equal to JAX's ``generate``. Greedy draws nothing;
    sampling draws once a token. For ``eos`` the eos id is the token the
    free run emits second in row 0, so rows finish at different steps and
    are padded with it after."""
    kw = dict(MODES[mode])
    if mode == "eos":
        free, _, _ = run_pair(pair, prompt, monkeypatch, **kw)
        kw["eos_token_id"] = int(free[0, PROMPT + 1])
    want, got, taken = run_pair(pair, prompt, monkeypatch, **kw)
    np.testing.assert_array_equal(got, want)
    assert taken == (NEW if kw.get("do_sample") else 0)
    if mode == "eos":
        row = got[0, PROMPT:]
        first = int(np.argmax(row == kw["eos_token_id"]))
        assert (row[first:] == kw["eos_token_id"]).all()


def test_sampling_is_seeded(pair, prompt):
    """The port's own draws: the same seed gives the same tokens, another
    seed others; greedy ignores the seed and equals ``do_sample=False`` at
    temperature 1 from before sampling (the argmax of the raw logits)."""
    _, tm = pair
    ids = torch.from_numpy(prompt)
    kw = dict(max_new_tokens=NEW, do_sample=True, top_k=50, top_p=0.95)
    a = tm.generate(ids, seed=11, **kw)
    assert torch.equal(a, tm.generate(ids, seed=11, **kw))
    assert not torch.equal(a, tm.generate(ids, seed=12, **kw))
    greedy = tm.generate(ids, max_new_tokens=NEW, seed=13)
    assert torch.equal(greedy, tm.generate(ids, max_new_tokens=NEW))
    out, cache = [ids], tm.gpt.init_cache(B, PROMPT + NEW)
    with torch.no_grad():
        hidden, cache = tm.gpt.decode(ids, cache, 0)
        tok = torch.argmax(tm.logits(hidden[:, -1:])[:, 0], -1)
        for off in range(PROMPT, PROMPT + NEW):
            out.append(tok[:, None])
            if off == PROMPT + NEW - 1:
                break
            hidden, cache = tm.gpt.decode(tok[:, None], cache, off)
            tok = torch.argmax(tm.logits(hidden)[:, 0], -1)
    assert torch.equal(greedy, torch.cat(out, 1))


def jax_filter(logits, top_k, top_p):
    """``paddle_tpu/text/models/gpt.py:386-401`` on its own: the filters
    JAX's ``pick`` applies before the draw, and the top-p cutoff index."""
    cutoff_idx = None
    if top_k:
        kth = jax.lax.top_k(logits, top_k)[0][..., -1:]
        logits = jnp.where(logits < kth, -jnp.inf, logits)
    if top_p < 1.0:
        sorted_logits = jnp.sort(logits, axis=-1)[..., ::-1]
        probs = jax.nn.softmax(sorted_logits, axis=-1)
        cum = jnp.cumsum(probs, axis=-1)
        cutoff_idx = jnp.sum(cum < top_p, axis=-1, keepdims=True)
        cutoff = jnp.take_along_axis(sorted_logits, cutoff_idx, axis=-1)
        logits = jnp.where(logits < cutoff, -jnp.inf, logits)
    return logits, cutoff_idx


def test_top_k_keeps_ties_at_the_kth_value():
    """Logits ``>=`` the k-th largest survive: three tied at the 2nd value
    with ``top_k=2`` keep four logits, as in JAX."""
    x = np.array([[3.0, 1.0, 1.0, 0.5, 1.0, -2.0]], np.float32)
    want, _ = jax_filter(jnp.asarray(x), 2, 1.0)
    got = tgpt.filter_logits(torch.from_numpy(x), 2, 1.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(torch.isfinite(got).sum()) == 4


@pytest.mark.parametrize("top_k", [0, 61])
def test_top_p_past_the_end_cuts_nothing(top_k):
    """61 tied logits (with ``top_k=61`` among 128, the rest cut to
    ``-inf``): in float32 their softmax sums to 0.99999994 in both
    packages, so with ``top_p`` just under 1 (1.0 in float32) no prefix
    reaches it and the cutoff index is the vocabulary size. JAX's
    ``take_along_axis`` gives NaN there and ``logits < NaN`` cuts
    nothing; the port gives the same logits (no out-of-range gather)."""
    v = 128 if top_k else 61
    x = np.full((2, v), -3.0, np.float32)
    x[:, :61] = 0.0
    x[1, 61:] = -50.0
    want, idx = jax_filter(jnp.asarray(x), top_k, 1.0 - 1e-9)
    assert (np.asarray(idx) == v).all()
    got = tgpt.filter_logits(torch.from_numpy(x), top_k, 1.0 - 1e-9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_top_p_keeps_the_token_that_crosses():
    """The smallest prefix whose probability reaches ``top_p`` survives,
    the token crossing it included."""
    x = np.log(np.array([[0.5, 0.3, 0.15, 0.05]], np.float32))
    for p in (0.5, 0.79, 0.81, 0.96):
        want, _ = jax_filter(jnp.asarray(x), 0, p)
        got = tgpt.filter_logits(torch.from_numpy(x), 0, p)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gumbel_noise_draws():
    """The port's draw: finite in float32 and bf16 (a 16-bit u never
    rounds up to 1), seeded, and a standard Gumbel (mean 0.5772, variance
    pi²/6 within sampling error over 2^16 draws)."""
    g = torch.Generator().manual_seed(0)
    a = tgpt.gumbel_noise((256, 256), torch.float32, g)
    g2 = torch.Generator().manual_seed(0)
    assert torch.equal(a, tgpt.gumbel_noise((256, 256), torch.float32, g2))
    assert bool(torch.isfinite(a).all())
    assert abs(float(a.mean()) - 0.5772) < 0.02
    assert abs(float(a.var()) - np.pi ** 2 / 6) < 0.05
    b = tgpt.gumbel_noise((256, 256), torch.bfloat16, g)
    assert b.dtype == torch.bfloat16 and bool(torch.isfinite(b).all())
