"""Port parity: activation recompute — ``GPTConfig(recompute=True)`` under
each of the JAX package's six policy names, ``recompute()``,
``recompute_sequential()``, ``PipelineLayer(recompute_interval=1)`` — and
the other ``GPTConfig`` fields (``use_flash_attention``,
``sequence_parallel``, ``context_parallel``) against the JAX package.

- At dropout 0 the port's recomputed GPT gives JAX's recomputed loss and
  gradients within ``test_gpt_grads_match_jax``'s atol 2e-6 (f32; the same
  sums in other orders).
- At hidden and attention dropout 0.1 the draws are pinned on both sides,
  as ``tests/test_torch_dropout.py`` pins them, and held to that file's GPT
  tolerances (loss within 1e-5, gradients within 1e-4·max|ref|). The port
  pins by key: a recomputed forward asks for the forward's keys again and
  gets the same masks only if it replays the key stream.
- With its own draws the port's recompute must be bit-equal to the port
  without it; a plain ``torch.utils.checkpoint`` (no replay) misses by far
  more than rounding.
- K1 under the policy: ``dots_and_flash_saveable`` keeps its ``(o, lse)``,
  so the backward calls no K1 forward; full recompute calls one a layer.
"""

import contextlib
import importlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.functional import functional_call, get_params
from paddle_tpu.text.models import gpt as jgpt
from paddle_tpu_torch.convert import from_jax_state_dict, to_jax_state_dict
from paddle_tpu_torch.distributed.fleet.utils import (RecomputePolicy,
                                                      recompute,
                                                      recompute_sequential)
from paddle_tpu_torch.text.models import gpt as tgpt

hfa = importlib.import_module("paddle_tpu_torch.ops._hopper.flash_attention")
TF = importlib.import_module("paddle_tpu_torch.nn.functional")
trandom = importlib.import_module("paddle_tpu_torch.core.random")
trecompute = importlib.import_module(
    "paddle_tpu_torch.distributed.fleet.utils.recompute")

POLICIES = list(RecomputePolicy.NAMES)
DROP = dict(hidden_dropout=0.1, attention_dropout=0.1)


def batch(b=2, s=32, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 1024, (b, s)).astype(np.int32)
    return ids, np.roll(ids, -1, axis=1)


def carried(seed=11, **over):
    """(JAX GPT, the port's with its weights), f32 on the CPU."""
    paddle.seed(seed)
    jm = jgpt.GPTForCausalLM(jgpt.gpt_tiny(**over))
    tm = tgpt.GPTForCausalLM(tgpt.gpt_tiny(**over), device="cpu")
    tm.load_state_dict(from_jax_state_dict(
        {k: np.asarray(v) for k, v in jm.state_dict().items()}), strict=True)
    return jm, tm


def jax_grads(jm, ids, labels):
    """JAX's loss and gradients, jitted (a fresh trace: the policy and the
    pinned draws are read when it is traced)."""
    loss, grads = jax.jit(jax.value_and_grad(lambda p, i, l: functional_call(
        jm, p, i, l, training=True)))(get_params(jm), jnp.asarray(ids),
                                      jnp.asarray(labels))
    return float(loss), {n: np.asarray(g) for n, g in grads.items()}


def port_grads(tm, ids, labels):
    tm.train()
    tm.zero_grad(set_to_none=True)
    loss = tm(torch.from_numpy(ids).long(), torch.from_numpy(labels).long())
    loss.backward()
    return float(loss.detach()), to_jax_state_dict(
        {n: p.grad for n, p in tm.named_parameters()})


@contextlib.contextmanager
def pinned_draws(monkeypatch, masks, seeds):
    """The same hidden-dropout masks and attention-dropout seeds on both
    sides. JAX takes them in call order (its recompute replays the traced
    draws); the port by key, in the order keys first appear, so a draw
    under a key seen before gets what that key got."""
    jmasks, jseeds = list(masks), list(seeds)
    by_key, seed_by_key = {}, {}
    tmasks, tseeds = list(masks), list(seeds)

    def jax_bernoulli(key, p, shape):
        m = jmasks.pop(0)
        assert tuple(shape) == m.shape
        return jnp.asarray(m)

    def jax_randint(key, shape, lo, hi, dtype=None):
        return jnp.full(shape, jseeds.pop(0), jnp.int32)

    def port_mask(key, shape, keep, device):
        if key not in by_key:
            by_key[key] = tmasks.pop(0)
        assert tuple(shape) == by_key[key].shape
        return torch.from_numpy(by_key[key])

    def port_seed(key=None):
        key = trandom.next_key() if key is None else key
        if key not in seed_by_key:
            seed_by_key[key] = tseeds.pop(0)
        return seed_by_key[key]

    with monkeypatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", jax_bernoulli)
        mp.setattr(jax.random, "randint", jax_randint)
        mp.setattr(TF, "_keep_mask", port_mask)
        mp.setattr(trandom, "draw_seed", port_seed)
        yield jmasks, jseeds, tmasks, tseeds


@pytest.fixture(scope="module")
def rate0_pair():
    return carried(recompute=True)


@pytest.fixture(scope="module")
def dropout_pair():
    return carried(recompute=True, **DROP)


def _hold(got, want, loss_tol, grad_scale):
    assert abs(got[0] - want[0]) <= loss_tol
    assert set(got[1]) == set(want[1])
    for name, g in got[1].items():
        w = want[1][name]
        np.testing.assert_allclose(
            g, w, atol=grad_scale(w), rtol=0, err_msg=name)


@pytest.mark.parametrize("policy", POLICIES)
def test_recompute_matches_jax_at_rate0(rate0_pair, policy):
    """Loss and every gradient within 2e-6 of JAX's recomputed GPT."""
    jm, tm = rate0_pair
    jm.cfg.recompute_policy = tm.cfg.recompute_policy = policy
    ids, labels = batch()
    _hold(port_grads(tm, ids, labels), jax_grads(jm, ids, labels), 2e-6,
          lambda w: 2e-6)


@pytest.mark.parametrize("policy", POLICIES)
def test_recompute_matches_jax_with_pinned_dropout(monkeypatch, dropout_pair,
                                                   policy):
    """Hidden and attention dropout 0.1, the draws pinned: loss within
    1e-5, gradients within 1e-4·max|ref| (test_torch_dropout.py's GPT
    tolerances). Every mask and seed is drawn on both sides."""
    jm, tm = dropout_pair
    jm.cfg.recompute_policy = tm.cfg.recompute_policy = policy
    ids, labels = batch(seed=1)
    rng = np.random.default_rng(2)
    # the embeddings', then each layer's attention-output and MLP dropout
    masks = [rng.random((2, 32, 128)) >= 0.1 for _ in range(5)]
    with pinned_draws(monkeypatch, masks, [101, 202]) as left:
        want = jax_grads(jm, ids, labels)
        got = port_grads(tm, ids, labels)
    assert all(not q for q in left)
    _hold(got, want, 1e-5,
          lambda w: 1e-4 * float(np.abs(w).max()) + 1e-9)


def _own_draws(cfg, ids, labels, seed=3):
    tm = tgpt.GPTForCausalLM(cfg, device="cpu", seed=seed)
    with trandom.rng_scope(trandom.make_key(5)):
        return port_grads(tm, ids, labels)


@pytest.mark.parametrize("policy", POLICIES)
def test_recompute_replays_the_port_s_own_draws(policy):
    """Dropout 0.1 from the port's own keys (a train step's scope): the
    recomputed model's loss and gradients equal the model without
    recompute bit for bit."""
    ids, labels = batch(seed=4)
    want = _own_draws(tgpt.gpt_tiny(**DROP), ids, labels)
    got = _own_draws(tgpt.gpt_tiny(recompute=True, recompute_policy=policy,
                                   **DROP), ids, labels)
    assert got[0] == want[0]
    for name, g in got[1].items():
        assert np.array_equal(g, want[1][name]), name


def test_recompute_without_replay_differs(monkeypatch):
    """The check above has teeth: with the replay taken out (a plain
    checkpoint) the recomputed masks are new and the gradients part from
    the model without recompute by far more than rounding; outside a
    scope, on the global generator, the replay holds too."""
    ids, labels = batch(seed=4)
    want = _own_draws(tgpt.gpt_tiny(**DROP), ids, labels)
    cfg = tgpt.gpt_tiny(recompute=True, **DROP)
    with monkeypatch.context() as mp:
        mp.setattr(trecompute, "_replaying", lambda fn: fn)
        got = _own_draws(cfg, ids, labels)
    assert got[0] == want[0]   # the forward is the same
    assert max(float(np.abs(g - want[1][n]).max())
               for n, g in got[1].items()) > 1e-2
    runs = []
    for c in (tgpt.gpt_tiny(**DROP), cfg):
        trandom.seed(8)
        tm = tgpt.GPTForCausalLM(c, device="cpu", seed=3)
        runs.append(port_grads(tm, ids, labels))
        runs[-1] += (trandom.get_rng_state(),)
    assert runs[0][0] == runs[1][0] and runs[0][2] == runs[1][2]
    for name, g in runs[1][1].items():
        assert np.array_equal(g, runs[0][1][name]), name


def _o1_grads_backward_on_another_thread(cfg, ids, labels, dtype):
    """Loss and gradients of the port's GPT under ``auto_cast`` O1, with
    the forward on this thread and the backward on another, as autograd
    runs a CUDA backward on a device thread of its own."""
    from paddle_tpu_torch import amp as tamp
    tm = tgpt.GPTForCausalLM(cfg, device="cpu", seed=3)
    tm.train()
    with trandom.rng_scope(trandom.make_key(5)), \
            tamp.auto_cast(level="O1", dtype=dtype):
        loss = tm(torch.from_numpy(ids).long(),
                  torch.from_numpy(labels).long())
    errors = []

    def backward():
        try:
            loss.backward()
        except BaseException as e:  # noqa: BLE001  (re-raised below)
            errors.append(e)

    worker = threading.Thread(target=backward)
    worker.start()
    worker.join()
    if errors:
        raise errors[0]
    return float(loss.detach()), to_jax_state_dict(
        {n: p.grad for n, p in tm.named_parameters()})


@pytest.mark.parametrize("policy", ["dots_and_flash_saveable", None])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_o1_recompute_on_a_backward_thread(policy, dtype):
    """O1 with recompute, the backward on a thread where no ``auto_cast``
    is active: the recompute runs under the forward's AMP state, so the
    recomputed products are cast as the forward's were and the loss and
    gradients equal the same run without recompute bit for bit."""
    ids, labels = batch(seed=6)
    want = _o1_grads_backward_on_another_thread(
        tgpt.gpt_tiny(**DROP), ids, labels, dtype)
    got = _o1_grads_backward_on_another_thread(
        tgpt.gpt_tiny(recompute=True, recompute_policy=policy, **DROP),
        ids, labels, dtype)
    assert got[0] == want[0]
    for name, g in got[1].items():
        assert np.array_equal(g, want[1][name]), name


@pytest.mark.parametrize("policy,backward_calls", [
    ("dots_and_flash_saveable", 0), (None, 1), ("nothing_saveable", 1),
    ("dots_saveable", 1), ("everything_saveable", 0)])
def test_k1_forward_calls_in_the_backward(monkeypatch, policy,
                                          backward_calls):
    """At head dim 128 attention runs K1 (its plain version here). The
    default policy keeps K1's (o, lse): no K1 forward in the backward;
    full recompute runs one a layer, as ``dots_saveable`` does (JAX's dots
    policy does not name the flash residuals)."""
    calls = []
    orig = hfa.flash_fwd_reference

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return orig(*args, **kwargs)

    monkeypatch.setattr(hfa, "flash_fwd_reference", spy)
    cfg = tgpt.gpt_tiny(hidden_size=256, num_heads=2, recompute=True,
                        recompute_policy=policy, attention_dropout=0.1)
    tm = tgpt.GPTForCausalLM(cfg, device="cpu")
    ids, labels = batch(s=64, seed=5)
    loss = tm(torch.from_numpy(ids).long(), torch.from_numpy(labels).long())
    assert len(calls) == cfg.num_layers
    loss.backward()
    assert len(calls) == cfg.num_layers * (1 + backward_calls)


def test_unknown_policy_raises():
    tm = tgpt.GPTForCausalLM(tgpt.gpt_tiny(num_layers=1, recompute=True,
                                           recompute_policy="dots"),
                             device="cpu")
    with pytest.raises(ValueError, match="unknown recompute policy"):
        tm(torch.zeros((1, 8), dtype=torch.long))


@pytest.mark.parametrize("kind,policy", [
    ("recompute", None), ("recompute", "dots_saveable"),
    ("sequential", None)])
def test_recompute_and_recompute_sequential_match_jax(kind, policy):
    """Four tanh layers through JAX's ``recompute`` (under a policy) or
    ``recompute_sequential`` (two segments) and the port's, on the same
    weights (the port's ``nn.Linear``): the output within 1e-6 and the
    input and weight gradients within 1e-5 (f32)."""
    from paddle_tpu_torch import nn as tnn
    jrc = importlib.import_module(
        "paddle_tpu.distributed.fleet.utils.recompute")
    rng = np.random.default_rng(6)
    ws = [(rng.standard_normal((16, 16)).astype(np.float32) / 4,
           rng.standard_normal(16).astype(np.float32)) for _ in range(4)]
    x = rng.standard_normal((3, 16)).astype(np.float32)

    def jloss(xx, params):
        fns = [lambda h, w=w, b=b: jnp.tanh(h @ w + b) for w, b in params]
        if kind == "sequential":
            return jnp.sum(jrc.recompute_sequential({"segments": 2}, fns,
                                                    xx) ** 2)

        def chain(h):
            for fn in fns:
                h = fn(h)
            return h
        return jnp.sum(jrc.recompute(chain, xx, policy=policy) ** 2)

    out, (gx, gw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), [(jnp.asarray(w), jnp.asarray(b)) for w, b in ws])
    want = [np.asarray(gx)] + [np.asarray(g[0]).T for g in gw]
    layers = []
    for w, b in ws:
        layer = tnn.Linear(16, 16, device="cpu")
        layer.load_state_dict({"weight": torch.from_numpy(w.T.copy()),
                               "bias": torch.from_numpy(b)})
        layers.append(torch.nn.Sequential(layer, torch.nn.Tanh()))
    xt = torch.from_numpy(x).requires_grad_()
    if kind == "sequential":
        y = recompute_sequential({"segments": 2}, layers, xt)
    else:
        y = recompute(torch.nn.Sequential(*layers), xt, policy=policy)
    got_out = torch.sum(y ** 2)
    got_out.backward()
    got = [xt.grad.numpy()] + [seq[0].weight.grad.numpy() for seq in layers]
    assert abs(float(got_out) - float(out)) <= 1e-6 * max(1.0, abs(float(out)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


# -- the other GPTConfig fields ------------------------------------------------

@pytest.mark.parametrize("over", [
    {}, {"num_kv_heads": 2},
    {"sequence_parallel": True, "context_parallel": "ring"}],
    ids=["mha", "gqa", "sp_cp"])
def test_sdpa_route_and_mesh_fields_match_jax(over):
    """``use_flash_attention=False`` runs SDPA over repeated KV heads in
    both packages (MHA, and GQA where the repeat is real); with
    ``sequence_parallel`` and ``context_parallel`` set there is no mesh on
    either side, so both compute the plain model. Loss and gradients
    within 2e-6 of JAX's (f32)."""
    jm, tm = carried(use_flash_attention=False, **over)
    ids, labels = batch(seed=7)
    _hold(port_grads(tm, ids, labels), jax_grads(jm, ids, labels), 2e-6,
          lambda w: 2e-6)


def test_flash_and_sdpa_routes_agree_at_a_kernel_head_dim(monkeypatch):
    """At head dim 128 (MHA, S = 128) SDPA's route is K1's, so the two
    settings of ``use_flash_attention`` give bit-equal loss and
    gradients; both run K1 once a layer."""
    calls = []
    orig = hfa.flash_fwd_reference
    monkeypatch.setattr(hfa, "flash_fwd_reference", lambda *a, **k: (
        calls.append(1), orig(*a, **k))[1])
    ids, labels = batch(s=128, seed=8)
    runs = []
    for flash in (True, False):
        cfg = tgpt.gpt_tiny(hidden_size=256, num_heads=2,
                            use_flash_attention=flash)
        runs.append(port_grads(tgpt.GPTForCausalLM(cfg, device="cpu"),
                               ids, labels))
    assert len(calls) == 2 * 2
    assert runs[0][0] == runs[1][0]
    for name, g in runs[0][1].items():
        assert np.array_equal(g, runs[1][1][name]), name


def test_ernie_pipeline_with_recompute_interval_matches_jax():
    """``PipelineLayer(recompute_interval=1)`` builds as JAX's does, and two
    one-stage ``make_pipeline_train_step`` steps (JAX's ``loss_fallback``,
    which does not read the interval) give JAX's losses within 1e-5 and
    parameters within 1e-5 (f32)."""
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.distributed.fleet.meta_parallel.pp_layers import \
        PipelineLayer as JaxPipelineLayer
    from paddle_tpu.distributed.pipeline_schedule import \
        make_pipeline_train_step as jax_step_of
    from paddle_tpu.text.models import ernie as jernie
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import make_pipeline_train_step
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        PipelineLayer
    from paddle_tpu_torch.text.models import ernie as ternie
    from test_torch_ernie import TINY, batch as ernie_batch, jax_loss_fn, \
        port_loss_fn
    paddle.seed(13)
    jp = JaxPipelineLayer(jernie.ernie_pipeline_descs(jernie.ernie_tiny(
        **TINY)), num_stages=1, loss_fn=jax_loss_fn, recompute_interval=1)
    tp = PipelineLayer(ternie.ernie_pipeline_descs(ternie.ernie_tiny(**TINY),
                                                   device="cpu"),
                       num_stages=1, loss_fn=port_loss_fn,
                       recompute_interval=1)
    assert tp.recompute_interval == jp.recompute_interval == 1
    tp.load_state_dict(from_jax_state_dict(
        {k: np.asarray(v) for k, v in jp.state_dict().items()}), strict=True)
    ids, _, labels, _ = ernie_batch(seed=4)
    labels = np.where(labels < 0, 0, labels).astype(np.int32)
    lr = 1e-3
    jo = jopt.AdamW(learning_rate=lr)
    jstep = jax_step_of(jp, jo, n_microbatch=2)
    jparams = get_params(jp)
    jstate = jo.init(jparams)
    to = topt.AdamW(learning_rate=lr)
    step = make_pipeline_train_step(tp, to, n_microbatch=2)
    params = dict(tp.named_parameters())
    state = to.init(params)
    for _ in range(2):
        jparams, jstate, jloss = jstep(jparams, jstate, jnp.asarray(ids),
                                       jnp.asarray(labels), jnp.float32(lr))
        params, state, loss = step(params, state,
                                   torch.from_numpy(ids).long(),
                                   torch.from_numpy(labels).long(), lr)
        assert abs(float(loss) - float(jloss)) <= 1e-5
    final = to_jax_state_dict(params)
    for name, p in final.items():
        # the key bias's gradient is rounding noise: AdamW moves it by up to
        # lr a step either way (as test_torch_ernie.py holds it)
        atol = 2 * 2 * lr if name.endswith("k_proj.bias") else 1e-5
        np.testing.assert_allclose(p, np.asarray(jparams[name]), atol=atol,
                                   rtol=0, err_msg=name)
