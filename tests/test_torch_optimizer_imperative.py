"""Port parity: the imperative optimizer — ``Optimizer(parameters=...)``
with ``step()``, ``minimize()``, ``clear_grad()`` and
``state_dict()``/``set_state_dict()`` — the regularizers ``L1Decay`` and
``L2Decay``, and ``ClipGradByNorm``/``ClipGradByValue``, against the JAX
package. (The six optimizers the port gained with them are cases of
``tests/test_torch_train.py::test_optimizer_matches_jax_apply_gradients``.)

Weights go across with ``convert.from_jax_state_dict``; gradients are made
with numpy from a seed or taken by ``jax.grad``/``backward`` on the same
batch. float32 throughout: the same elementwise math in another order, so
rtol 1e-5 unless a comparison says otherwise.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu import regularizer as jreg
from paddle_tpu.framework.functional import functional_call, get_params
from paddle_tpu.text.models import gpt as jgpt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.convert import from_jax_state_dict, to_jax_state_dict
from paddle_tpu_torch.text.models import gpt as tgpt

jclip = importlib.import_module("paddle_tpu.nn.clip")


def test_imperative_adamw_loop_matches_jax():
    """Two steps of ``loss.backward(); opt.step(); opt.clear_grad()``
    with ``AdamW(parameters=model.named_parameters())`` on a 1-layer GPT,
    against JAX's imperative AdamW fed ``jax.grad``'s gradients: losses
    within 1e-5; the state under JAX's ``"<name>@<key>"`` keys, moments
    within rtol 1e-5 (transposed with their Linear weights); the final
    parameters within 2e-3 and 99.9% of them within 1e-5 (Adam's
    normalised step turns a rounding difference in a near-zero gradient
    into a step of up to lr, as ``test_train_step_loss_curve_matches_jax_
    loop`` holds it)."""
    paddle.seed(2)
    jm = jgpt.GPTForCausalLM(jgpt.gpt_tiny(num_layers=1))
    tm = tgpt.GPTForCausalLM(tgpt.gpt_tiny(num_layers=1), device="cpu")
    tm.load_state_dict(from_jax_state_dict(
        {k: np.asarray(v) for k, v in jm.state_dict().items()}), strict=True)
    jo = jopt.AdamW(1e-3, weight_decay=0.01, parameters=jm.parameters())
    to = topt.AdamW(1e-3, weight_decay=0.01,
                    parameters=tm.named_parameters())
    ids = np.random.default_rng(0).integers(0, 1024, (2, 16)).astype(
        np.int32)
    labels = np.roll(ids, -1, axis=1)
    grad_fn = jax.jit(jax.value_and_grad(lambda p, i, lab: functional_call(
        jm, p, i, lab, training=True)))
    for _ in range(2):
        want, grads = grad_fn(get_params(jm), jnp.asarray(ids),
                              jnp.asarray(labels))
        for name, ref in jm.named_parameters():
            ref.grad = grads[name]
        jo.step()
        jo.clear_grad()
        loss = tm(torch.from_numpy(ids).long(),
                  torch.from_numpy(labels).long())
        loss.backward()
        to.minimize(loss)
        to.clear_gradients()
        assert all(p.grad is None for p in tm.parameters())
        assert abs(float(loss.detach()) - float(want)) <= 1e-5
    jsd, tsd = jo.state_dict(), to.state_dict()
    assert set(tsd) == set(jsd)
    assert int(tsd["step"]) == int(jsd["step"]) == 2
    for key, v in jsd.items():
        if key == "step":
            continue
        name = key.rpartition("@")[0]
        ref = from_jax_state_dict({name: np.asarray(v)})[name].numpy()
        np.testing.assert_allclose(tsd[key].numpy(), ref, rtol=1e-5,
                                   atol=1e-7, err_msg=key)
    final = to_jax_state_dict(dict(tm.named_parameters()))
    diff = np.concatenate([np.abs(final[n] - np.asarray(p.value)).ravel()
                           for n, p in jm.named_parameters()])
    assert diff.max() <= 2e-3 and np.mean(diff <= 1e-5) >= 0.999


def test_state_dict_resumes_and_bare_parameters_are_named_by_position():
    """``set_state_dict`` of a ``state_dict`` (tensors or numpy) continues
    the run exactly; bare ``model.parameters()`` are named ``"0"``, ``"1"``,
    ... in order; a parameter without ``.grad`` is left alone, and one
    whose gradient first comes later gets its state then; ``step()``
    without ``parameters=`` raises."""
    torch.manual_seed(0)
    grads = [[torch.randn(3, 4), torch.randn(3)] for _ in range(6)]

    def run(opt_of, layer, steps, state=None):
        opt = opt_of(layer)
        if state is not None:
            opt.set_state_dict(state)
        for g in steps:
            layer.weight.grad, layer.bias.grad = g[0].clone(), g[1].clone()
            opt.step()
            opt.clear_grad()
        return opt

    def fresh():
        layer = tnn.Linear(4, 3, device="cpu")
        with torch.no_grad():
            layer.weight.copy_(torch.arange(12.0).reshape(3, 4) / 10)
            layer.bias.zero_()
        return layer

    def opt_of(layer):
        return topt.Adam(1e-2, parameters=layer.parameters(),
                         weight_decay=treg.L2Decay(0.01))

    full = fresh()
    run(opt_of, full, grads)
    half = fresh()
    opt = run(opt_of, half, grads[:3])
    sd = opt.state_dict()
    assert sorted(sd) == ["0@moment1", "0@moment2", "1@moment1",
                          "1@moment2", "step"]
    as_numpy = {k: np.asarray(v) for k, v in sd.items()}
    run(opt_of, half, grads[3:], state=as_numpy)
    assert torch.equal(half.weight, full.weight)
    assert torch.equal(half.bias, full.bias)
    late = fresh()
    opt = topt.SGD(0.1, parameters=late.named_parameters())
    late.weight.grad = torch.ones(3, 4)
    opt.step()
    assert torch.equal(late.bias, torch.zeros(3))
    assert set(opt.state_dict()) == {"step"}   # SGD keeps no state
    late.bias.grad = torch.ones(3)
    opt.step()
    assert torch.allclose(late.bias, torch.full((3,), -0.1))
    with pytest.raises(RuntimeError, match="parameters="):
        topt.SGD(0.1).step()


@pytest.mark.parametrize("reg", ["l1", "l2"])
@pytest.mark.parametrize("name", ["sgd", "momentum", "adam"])
def test_regularizers_match_jax(name, reg):
    """``weight_decay=L1Decay(c)`` (``c·sign(p)`` added to the gradient)
    and ``L2Decay(c)`` (the coupled decay) through ``apply_gradients``,
    three steps: parameters and state within rtol 1e-5 of JAX's."""
    rng = np.random.default_rng(7)
    init = {"w": rng.standard_normal((5, 3)).astype(np.float32),
            "b": rng.standard_normal(3).astype(np.float32)}
    made = []
    for mod, rmod in ((jopt, jreg), (topt, treg)):
        wd = (rmod.L1Decay if reg == "l1" else rmod.L2Decay)(0.05)
        if name == "sgd":
            made.append(mod.SGD(0.1, weight_decay=wd))
        elif name == "momentum":
            made.append(mod.Momentum(0.1, momentum=0.9, weight_decay=wd))
        else:
            made.append(mod.Adam(1e-2, weight_decay=wd))
    jo, to = made
    assert to.l1_decay == jo.l1_decay and to.weight_decay == jo.weight_decay
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(3):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in init.items()}
        jp, js = jo.apply_gradients(jp, {k: jnp.asarray(v)
                                         for k, v in g.items()}, js)
        to.apply_gradients(tp, {k: torch.from_numpy(v)
                                for k, v in g.items()}, ts)
    for k in init:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-7)
        for sk, v in js["param_states"][k].items():
            np.testing.assert_allclose(ts["param_states"][k][sk].numpy(),
                                       np.asarray(v), rtol=1e-5, atol=1e-7)
    x = torch.tensor([-2.0, 0.0, 3.0])
    grad = torch.ones(3)
    assert torch.equal(treg.L1Decay(0.5)(grad, x),
                       torch.tensor([0.5, 1.0, 1.5]))
    assert torch.equal(treg.L2Decay(0.5)(grad, x),
                       torch.tensor([0.0, 1.0, 2.5]))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("clip", ["norm", "value"])
def test_clip_grad_by_norm_and_value_match_jax(clip, dtype):
    """Per-tensor norm clipping (the norm in float32, each gradient scaled
    and cast back) and value clipping: f32 within 1e-6, bf16 the same
    float32 product rounded (within 1e-2); as an optimizer's
    ``grad_clip`` the update matches JAX's."""
    rng = np.random.default_rng(8)
    grads = {"a": rng.standard_normal((4, 5)).astype(np.float32) * 3,
             "b": rng.standard_normal(5).astype(np.float32) * 0.1}
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    if clip == "norm":
        jc, tc = jclip.ClipGradByNorm(1.0), tnn.ClipGradByNorm(1.0)
    else:
        jc, tc = jclip.ClipGradByValue(0.5, -0.2), tnn.ClipGradByValue(0.5,
                                                                      -0.2)
    want = jc({k: jnp.asarray(v, jdt) for k, v in grads.items()})
    got = tc({k: torch.from_numpy(v).to(tdt) for k, v in grads.items()})
    for k in grads:
        assert got[k].dtype == tdt
        np.testing.assert_allclose(
            got[k].float().numpy(), np.asarray(want[k].astype(jnp.float32)),
            atol=1e-6 if dtype == "f32" else 1e-2, rtol=0)
    assert tc([None, torch.ones(2)])[0] is None
    p = {k: torch.zeros(v.shape) for k, v in grads.items()}
    opt = topt.SGD(1.0, grad_clip=tc)
    opt.apply_gradients(p, {k: torch.from_numpy(v).to(tdt)
                            for k, v in grads.items()}, opt.init(p))
    for k in grads:
        np.testing.assert_allclose(
            -p[k].numpy(), np.asarray(want[k].astype(jnp.float32)),
            atol=1e-6 if dtype == "f32" else 1e-2, rtol=0)
