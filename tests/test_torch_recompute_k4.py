"""K4 under activation recompute's policy: K4's forward is the operator
``torch.ops.paddle_tpu_torch.flash_packed_fwd``, so the default policy
(``dots_and_flash_saveable``) keeps its ``(o, lse)`` as JAX's keeps
``flash_out``/``flash_lse``, and the backward does not run K4's forward
again; full recompute (``None``) does.

A head-dim-64 GPT cut (``gpt_tiny(num_heads=2)``: 2 layers, 2 heads of 64)
on the CPU, at S = 128 (K4a-direct and K4b-fused by ``plan``) and at S =
1024 (the streamed forward, dq and dk/dv). The operator's calls are counted
by a dispatch-mode spy around the forward and the backward: with the
policy's cache hit the recompute asks for no call. Gradients with
recompute must equal those without it bit for bit (the same plain-version
sums, the replayed key stream), at attention and hidden dropout 0.1.
"""

import importlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from paddle_tpu_torch.core import random as trandom
from paddle_tpu_torch.text.models import gpt as tgpt
from _torch_threads import one_torch_thread  # noqa: F401

hfp = importlib.import_module(
    "paddle_tpu_torch.ops._hopper.flash_attention_packed")
hfa = importlib.import_module("paddle_tpu_torch.ops._hopper.flash_attention")
trecompute = importlib.import_module(
    "paddle_tpu_torch.distributed.fleet.utils.recompute")

OP = torch.ops.paddle_tpu_torch.flash_packed_fwd.default
LAYERS = 2
DROP = dict(hidden_dropout=0.1, attention_dropout=0.1)


class OpSpy(TorchDispatchMode):
    """Counts the K4 forward operator's calls that reach the dispatcher's
    kernels (a recompute served from the policy's cache makes none)."""

    def __init__(self):
        super().__init__()
        self.calls = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is OP:
            self.calls += 1
        return func(*args, **(kwargs or {}))


def batch(s, seed=0):
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(0, 1024, (1, s))).long()
    return ids, torch.roll(ids, -1, dims=1)


def cfg(s, recompute, policy="dots_and_flash_saveable", **over):
    return tgpt.gpt_tiny(num_heads=2, max_position_embeddings=max(s, 256),
                         recompute=recompute, recompute_policy=policy,
                         **over)


@pytest.mark.parametrize("s,form", [(128, "direct"), (1024, "stream")])
def test_the_cut_runs_the_k4_form(s, form):
    assert hfp.plan(s, s, 2).fwd == form


@pytest.mark.parametrize("s", [128, 1024])
@pytest.mark.parametrize("policy,per_layer", [
    ("dots_and_flash_saveable", 1), (None, 2), ("nothing_saveable", 2),
    ("dots_saveable", 2), ("everything_saveable", 1)])
def test_k4_forward_calls_a_step(s, policy, per_layer):
    """One operator call a layer in the forward; the backward adds none
    under the default policy (and ``everything_saveable``, which recomputes
    nothing), one a layer where the policy does not name the flash
    residuals (full recompute, ``nothing_saveable``, ``dots_saveable``, as
    JAX's dots policy does not)."""
    model = tgpt.GPTForCausalLM(cfg(s, True, policy), device="cpu", seed=1)
    ids, labels = batch(s)
    spy = OpSpy()
    with spy:
        loss = model(ids, labels)
        assert spy.calls == LAYERS
        loss.backward()
    assert spy.calls == LAYERS * per_layer


def test_without_recompute_the_backward_calls_no_forward():
    model = tgpt.GPTForCausalLM(cfg(128, False), device="cpu", seed=1)
    spy = OpSpy()
    with spy:
        model(*batch(128)).backward()
    assert spy.calls == LAYERS


def _grads(c, ids, labels):
    model = tgpt.GPTForCausalLM(c, device="cpu", seed=3)
    model.train()
    with trandom.rng_scope(trandom.make_key(7)):
        loss = model(ids, labels)
        loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in
                                  model.named_parameters()}


@pytest.mark.parametrize("s", [128, 1024])
@pytest.mark.parametrize("policy", ["dots_and_flash_saveable", None])
def test_gradients_bit_equal_with_and_without_recompute(s, policy):
    """Attention and hidden dropout 0.1 under one key stream: the loss and
    every gradient equal the model's without recompute bit for bit, under
    the policy (K4's outputs kept, the dropout seed drawn once) and under
    full recompute (K4's forward run again with the replayed seed)."""
    ids, labels = batch(s, seed=4)
    want = _grads(cfg(s, False, **DROP), ids, labels)
    got = _grads(cfg(s, True, policy, **DROP), ids, labels)
    assert got[0] == want[0]
    assert set(got[1]) == set(want[1])
    for name, g in got[1].items():
        assert torch.equal(g, want[1][name]), name


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_operator_is_the_forward_of_its_form(stream, masked):
    """On CPU tensors the operator returns the plain version's ``(o,
    lse)`` of its form bit for bit, lse in float32, masks and dropout
    included; it is differentiable only through ``flash_attention_packed``
    (whose forward calls it)."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 256, 2, 64, generator=g) for _ in range(3))
    bias = seg_q = seg_k = None
    if masked:
        bias = torch.zeros(2, 256)
        bias[1, 200:] = -1e9
        seg_q = torch.ones(2, 256, dtype=torch.int32)
        seg_k = seg_q.clone()
        seg_k[0, 240:] = 0
    o, lse = torch.ops.paddle_tpu_torch.flash_packed_fwd(
        q, k, v, seg_q, seg_k, bias, True, 0.125, stream, 0.1, 1234)
    ref = (hfp.flash_packed_fwd_stream_reference if stream else
           hfp.flash_packed_fwd_reference)(
        q, k, v, True, 0.125, (seg_q, seg_k, bias),
        hfa.AttnDropout(0.1, 1234))
    assert lse.dtype == torch.float32
    assert torch.equal(o, ref[0]) and torch.equal(lse, ref[1])


def test_policy_names_the_k4_operator():
    saved = trecompute.RecomputePolicy.resolve("dots_and_flash_saveable")
    assert OP in saved
    assert OP not in trecompute.RecomputePolicy.resolve("dots_saveable")
