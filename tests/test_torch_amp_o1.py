"""Port parity: AMP O1 — ``amp.auto_cast`` with its op lists, the port's
``nn.Linear`` consulting it, ``decorate(level="O1")`` and the dynamic loss
scaler ``GradScaler`` — against the JAX package.

The models keep float32 parameters; under O1 each Linear casts its input,
weight and bias to the AMP dtype, and everything else (embeddings, the
residual stream, LayerNorm, the tied logits, the loss) stays float32, in
both packages. Tolerances are the port's existing 16-bit ones: bf16 within
2e-2 + 2e-2·|ref| (``tests/test_torch_dropout.py``), the loss within 2e-2
(the O2 train-step test); float16 the same scaled to its ulp (/8, as
``chip_smoke.py``'s ``REL16``). Both frameworks round the 16-bit products
and the bias sums at other points.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.framework.functional import functional_call, get_params
from paddle_tpu.text.models import gpt as jgpt
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import from_jax_state_dict, to_jax_state_dict
from paddle_tpu_torch.text.models import gpt as tgpt
from _torch_threads import one_torch_thread  # noqa: F401

jauto_cast = importlib.import_module("paddle_tpu.amp.auto_cast")
jgs = importlib.import_module("paddle_tpu.amp.grad_scaler")
tgs = importlib.import_module("paddle_tpu_torch.amp.grad_scaler")

TOL = {"bfloat16": 2e-2, "float16": 2e-2 / 8}


@pytest.fixture(scope="module")
def pair():
    paddle.seed(11)
    jm = jgpt.GPTForCausalLM(jgpt.gpt_tiny())
    tm = tgpt.GPTForCausalLM(tgpt.gpt_tiny(), device="cpu")
    tm.load_state_dict(from_jax_state_dict(
        {k: np.asarray(v) for k, v in jm.state_dict().items()}), strict=True)
    return jm, tm


def batch(seed=0):
    ids = np.random.default_rng(seed).integers(0, 1024, (2, 32)).astype(
        np.int32)
    return ids, np.roll(ids, -1, axis=1)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_o1_gpt_forward_loss_and_grads_match_jax(pair, dtype):
    """``auto_cast(level="O1", dtype=...)`` around the forward in both
    packages: logits (float32, from the uncast tied product), loss and
    every float32 gradient within the dtype's tolerance."""
    jm, tm = pair
    ids, labels = batch()

    def f(p, i, lab):
        return functional_call(jm, p, i, lab, training=True), \
            functional_call(jm, p, i, training=True)

    with paddle.amp.auto_cast(level="O1", dtype=dtype):
        (loss, logits), grads = jax.jit(jax.value_and_grad(
            f, has_aux=True))(get_params(jm), jnp.asarray(ids),
                              jnp.asarray(labels))
    tm.train()
    tm.zero_grad(set_to_none=True)
    with tamp.auto_cast(level="O1", dtype=dtype):
        got_logits = tm(torch.from_numpy(ids).long())
        got_loss = tm(torch.from_numpy(ids).long(),
                      torch.from_numpy(labels).long())
        # the projections ran in the AMP dtype
        x = torch.zeros(1, 128)
        assert tm.gpt.h[0].mlp.up(x).dtype == getattr(torch, dtype)
    got_loss.backward()
    tol = TOL[dtype]
    assert got_logits.dtype == torch.float32
    np.testing.assert_allclose(got_logits.detach().numpy(),
                               np.asarray(logits), atol=tol, rtol=tol)
    assert abs(float(got_loss.detach()) - float(loss)) <= tol
    got = to_jax_state_dict({n: p.grad for n, p in tm.named_parameters()})
    assert set(got) == set(grads)
    for name, g in got.items():
        assert tm.get_parameter(name).grad.dtype == torch.float32
        np.testing.assert_allclose(g, np.asarray(grads[name]), atol=tol,
                                   rtol=tol, err_msg=name)


def test_should_cast_and_maybe_cast_input_match_jax():
    """The op lists, custom lists, levels and nesting give JAX's answers,
    and ``maybe_cast_input`` casts only float32 tensors."""
    ops = sorted(jauto_cast.WHITE_LIST | jauto_cast.BLACK_LIST |
                 {"relu", "gelu"})
    cases = [dict(level="O1"), dict(level="O2"), dict(enable=False),
             dict(level="O1", custom_white_list={"gelu"},
                  custom_black_list={"linear"}),
             dict(level="O2", custom_black_list={"relu"})]
    assert tamp.white_list() == jauto_cast.white_list()
    assert tamp.black_list() == jauto_cast.black_list()
    for kw in cases:
        with paddle.amp.auto_cast(dtype="bfloat16", **kw):
            want = [jauto_cast.get_amp_state().should_cast(o) for o in ops]
        with tamp.auto_cast(dtype="bfloat16", **kw):
            st = tamp.get_amp_state()
            assert [st.should_cast(o) for o in ops] == want, kw
            assert st.level == ("O0" if kw.get("enable") is False
                                else kw["level"])
    assert not tamp.get_amp_state().enable   # restored on exit
    f32, i64 = torch.ones(2), torch.ones(2, dtype=torch.long)
    with tamp.amp_guard(level="O1", dtype="float16"):
        with tamp.auto_cast(enable=False):
            assert tamp.maybe_cast_input("linear", f32).dtype == torch.float32
        x, n, i = tamp.maybe_cast_input("linear", f32, None, i64)
        assert (x.dtype, n, i.dtype) == (torch.float16, None, torch.long)
        assert tamp.maybe_cast_input("layer_norm", f32) is f32
    with pytest.raises(ValueError, match="level"):
        tamp.decorate(torch.nn.Linear(2, 2), level="O3")


def _scaler_pair(**kw):
    return jgs.GradScaler(**kw), tamp.GradScaler(**kw)


def test_grad_scaler_functional_core_matches_jax():
    """``init_state``/``update_state`` and ``unscale_and_check`` over a
    sequence of good and bad steps (incr every 3, decr every 2, the floor
    of 1 reached): the same scales, counters and found_inf as JAX's, the
    unscaled gradients equal (float32 and bf16)."""
    js, ts = _scaler_pair(init_loss_scaling=4.0, incr_every_n_steps=3,
                          decr_every_n_nan_or_inf=2)
    jst, tst = js.init_state(), ts.init_state()
    rng = np.random.default_rng(0)
    for found in [False, False, False, True, True, True, True, True, True,
                  False, True, False, False, False]:
        jst = js.update_state(jst, jnp.asarray(found))
        tst = ts.update_state(tst, torch.tensor(found))
        assert float(tst["scale"]) == float(jst["scale"])
        assert (int(tst["good"]), int(tst["bad"])) == \
            (int(jst["good"]), int(jst["bad"]))
    assert float(tst["scale"]) == 2.0
    for bad in (None, "inf", "nan"):
        g = {"a": rng.standard_normal((3, 4)).astype(np.float32) * 1e3,
             "b": rng.standard_normal(5).astype(np.float32)}
        if bad:
            g["b"][2] = np.inf if bad == "inf" else np.nan
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.bfloat16, torch.bfloat16)):
            want, jfound = jgs.unscale_and_check(
                {k: jnp.asarray(v, jdt) for k, v in g.items()},
                jnp.float32(1024.0))
            got, tfound = tgs.unscale_and_check(
                {k: torch.from_numpy(v).to(tdt) for k, v in g.items()},
                torch.tensor(1024.0))
            assert bool(tfound) == bool(jfound) == (bad is not None)
            for k in g:
                assert got[k].dtype == tdt
                np.testing.assert_array_equal(
                    got[k].float().numpy(),
                    np.asarray(want[k].astype(jnp.float32)))


def test_grad_scaler_imperative_loop_matches_jax():
    """The imperative surface on both sides: a Linear's gradients set by
    hand (those of the scaled loss, one step with an inf), then
    ``scaler.step(opt)`` and ``scaler.update()`` with an imperative SGD.
    The scale after each step, the skipped step and the parameters equal
    JAX's (f32); ``state_dict`` round-trips."""
    from paddle_tpu import nn as jnn
    from paddle_tpu_torch import nn as tnn
    paddle.seed(5)
    jl = jnn.Linear(4, 3)
    tl = tnn.Linear(4, 3, device="cpu")
    sd = from_jax_state_dict({f"fc.{k}": np.asarray(v)
                              for k, v in jl.state_dict().items()})
    tl.load_state_dict({k[3:]: v for k, v in sd.items()})
    jo = jopt.SGD(0.1, parameters=jl.parameters())
    to = topt.SGD(0.1, parameters=tl.named_parameters())
    js, ts = _scaler_pair(init_loss_scaling=8.0, incr_every_n_steps=2,
                          decr_every_n_nan_or_inf=1)
    rng = np.random.default_rng(1)
    for step in range(5):
        gw = rng.standard_normal((4, 3)).astype(np.float32) * 8
        gb = rng.standard_normal(3).astype(np.float32) * 8
        if step == 2:
            gb[0] = np.inf
        refs = {r.name: r for r in jl.parameters()}
        refs["weight"].grad = jnp.asarray(gw)
        refs["bias"].grad = jnp.asarray(gb)
        tl.weight.grad = torch.from_numpy(gw.T.copy())
        tl.bias.grad = torch.from_numpy(gb)
        js.step(jo)
        js.update()
        ts.minimize(to)
        jo.clear_grad()
        to.clear_grad()
        assert tl.weight.grad is None
        assert float(ts.get_loss_scaling()) == float(js.get_loss_scaling())
        np.testing.assert_allclose(tl.weight.detach().numpy().T,
                                   np.asarray(jl.weight), rtol=1e-6)
        np.testing.assert_allclose(tl.bias.detach().numpy(),
                                   np.asarray(jl.bias), rtol=1e-6)
    assert float(ts.get_loss_scaling()) == 16.0   # x2, /2 at the inf, x2
    loss = torch.tensor(3.0)
    assert float(ts.scale(loss)) == 48.0
    fresh = tamp.GradScaler()
    fresh.load_state_dict(ts.state_dict())
    assert fresh.state_dict()["scale"] == ts.state_dict()["scale"]
    assert fresh.state_dict()["good_steps"] == ts.state_dict()["good_steps"]


def test_o1_float16_user_loop_matches_jax(pair):
    """The dygraph loop as a Paddle user writes it, on gpt_tiny in float16
    O1: ``with auto_cast(...): loss = model(ids, labels)``, then
    ``scaler.scale(loss).backward(); scaler.step(opt); scaler.update();
    opt.clear_grad()`` with ``GradScaler()`` and ``AdamW(parameters=
    model.parameters())``. JAX takes the gradients of the scaled loss by
    ``jax.grad`` and the same scaler and imperative AdamW. Two steps: the
    scale at 2^15 throughout and the losses within float16's tolerance."""
    jm0, tm0 = pair
    paddle.seed(11)
    jm = jgpt.GPTForCausalLM(jgpt.gpt_tiny())
    jm.set_state_dict(jm0.state_dict())
    tm = tgpt.GPTForCausalLM(tgpt.gpt_tiny(), device="cpu")
    tm.load_state_dict(tm0.state_dict())
    jo = jopt.AdamW(1e-3, parameters=jm.parameters())
    to = topt.AdamW(1e-3, parameters=tm.parameters())
    js, ts = _scaler_pair()
    ids, labels = batch(seed=3)

    with paddle.amp.auto_cast(level="O1", dtype="float16"):
        grad_fn = jax.jit(jax.value_and_grad(
            lambda p, s, i, lab: functional_call(jm, p, i, lab,
                                                 training=True) * s))
    want, got = [], []
    for _ in range(2):
        scaled, grads = grad_fn(get_params(jm), js.get_loss_scaling(),
                                jnp.asarray(ids), jnp.asarray(labels))
        for name, ref in jm.named_parameters():
            ref.grad = grads[name]
        js.step(jo)
        js.update()
        jo.clear_grad()
        want.append(float(scaled) / 2.0 ** 15)
        with tamp.auto_cast(level="O1", dtype="float16"):
            loss = tm(torch.from_numpy(ids).long(),
                      torch.from_numpy(labels).long())
        ts.scale(loss).backward()
        ts.step(to)
        ts.update()
        to.clear_grad()
        got.append(float(loss.detach()))
        assert float(ts.get_loss_scaling()) == \
            float(js.get_loss_scaling()) == 2.0 ** 15
    assert got[-1] < got[0]
    np.testing.assert_allclose(got, want, atol=TOL["float16"])
