"""Port parity: ``nn/rnn.py``, the cells, ``RNN``, ``BiRNN`` and the stacked
``SimpleRNN``/``LSTM``/``GRU``, against the JAX package on the CPU.

JAX's weights are carried into the port by ``convert.from_jax_state_dict(
..., module=)`` (the cells' ``[gates·hidden, in]`` weights copy as they
are: no cell is a Linear), the same numpy inputs and initial states go
through both, and the outputs, final states and the gradients of a
weighted sum of the outputs (to the input and every parameter, JAX's by
``jax.grad`` through ``functional_call``) are compared. The stacked
layers run torch's fused recurrence, JAX's ``lax.scan``. float32: outputs
and states within 1e-5 + 1e-5·|ref|, gradients within 1e-4 + 1e-4·|ref|.
Dropout between layers is held by determinism under the seed, its rate
and its being off in eval mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn as jnn
import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.nn as tnn
from paddle_tpu.framework.functional import functional_call, get_params
from paddle_tpu_torch.convert import from_jax_state_dict
from paddle_tpu_torch.core.device import device_guard
from _torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def cpu_device():
    with device_guard("cpu"):
        yield


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) *
            scale).astype(np.float32)


def _close(got, want, tol=1e-5):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, tol)
        return
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _carry(jl, tl):
    sd = {k: np.asarray(v) for k, v in jl.state_dict().items()}
    assert list(sd) == list(tl.state_dict())
    tl.load_state_dict(from_jax_state_dict(sd, module=tl), strict=True)
    return tl


def _to(tree, conv):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to(t, conv) for t in tree)
    return conv(tree)


def _grads_match(jl, tl, x, states, w_out, tol=1e-4):
    """The gradients of ``sum(out · w_out)`` to the input and every
    parameter, JAX (``jax.grad`` of ``functional_call``) against the
    port (autograd)."""
    params = get_params(jl)

    def loss(p, xx):
        out, _ = functional_call(jl, p, xx, _to(states, jnp.asarray))
        return jnp.sum(out * jnp.asarray(w_out))

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out, _ = tl(xt, _to(states, torch.from_numpy))
    (out * torch.from_numpy(w_out)).sum().backward()
    _close(xt.grad, gx, tol)
    for name, p in tl.named_parameters():
        _close(p.grad, gp[name], tol)


# -- cells -------------------------------------------------------------------

CELLS = [("SimpleRNNCell", {}), ("SimpleRNNCell", {"activation": "relu"}),
         ("LSTMCell", {}), ("GRUCell", {}),
         ("GRUCell", {"bias_ih_attr": False}),
         ("LSTMCell", {"bias_hh_attr": False})]


@pytest.mark.parametrize("case", CELLS, ids=lambda c: c[0] + "".join(
    f"-{k}" for k in c[1]))
def test_cell_step(case):
    name, kw = case
    jc = getattr(jnn, name)(6, 8, **kw)
    tc = _carry(jc, getattr(tnn, name)(6, 8, **kw))
    x = _x((3, 6), 1)
    h0 = _x((3, 8), 2)
    st = (h0, _x((3, 8), 3)) if name == "LSTMCell" else h0
    jout, jst = jc(jnp.asarray(x), _to(st, jnp.asarray))
    tout, tst = tc(torch.from_numpy(x), _to(st, torch.from_numpy))
    _close(tout, jout)
    _close(tst, jst)
    # no state: zeros, as JAX's get_initial_states
    _close(tc(torch.from_numpy(x))[0], jc(jnp.asarray(x))[0])


@pytest.mark.parametrize("name", ["SimpleRNNCell", "LSTMCell", "GRUCell"])
@pytest.mark.parametrize("reverse", [False, True])
def test_rnn_wrapper(name, reverse):
    jc = getattr(jnn, name)(5, 7)
    tc = _carry(jc, getattr(tnn, name)(5, 7))
    jr, tr = jnn.RNN(jc, is_reverse=reverse), tnn.RNN(tc, is_reverse=reverse)
    x = _x((2, 6, 5), 4)
    jout, jfin = jr(jnp.asarray(x))
    tout, tfin = tr(torch.from_numpy(x))
    _close(tout, jout)
    _close(tfin, jfin)
    # time-major
    jr.time_major = tr.time_major = True
    xt = np.swapaxes(x, 0, 1).copy()
    _close(tr(torch.from_numpy(xt))[0], jr(jnp.asarray(xt))[0])
    jr.time_major = tr.time_major = False
    st = (_x((2, 7), 5), _x((2, 7), 6)) if name == "LSTMCell" else \
        _x((2, 7), 5)
    _grads_match(jr, tr, x, st, _x((2, 6, 7), 7))


@pytest.mark.parametrize("name", ["SimpleRNNCell", "LSTMCell", "GRUCell"])
def test_birnn(name):
    jf, jb = getattr(jnn, name)(5, 4), getattr(jnn, name)(5, 4)
    tf, tb = getattr(tnn, name)(5, 4), getattr(tnn, name)(5, 4)
    jl, tl = jnn.BiRNN(jf, jb), tnn.BiRNN(tf, tb)
    _carry(jl, tl)
    x = _x((3, 6, 5), 8)
    jout, jfin = jl(jnp.asarray(x))
    tout, tfin = tl(torch.from_numpy(x))
    _close(tout, jout)
    _close(tfin, jfin)
    one = (_x((3, 4), 9), _x((3, 4), 10)) if name == "LSTMCell" else \
        _x((3, 4), 9)
    _grads_match(jl, tl, x, (one, one), _x((3, 6, 8), 11))


# -- the stacked layers ------------------------------------------------------

STACKED = [("SimpleRNN", 1, "forward", {}),
           ("SimpleRNN", 2, "bidirect", {"activation": "relu"}),
           ("LSTM", 1, "forward", {}), ("LSTM", 2, "forward", {}),
           ("LSTM", 2, "bidirectional", {}),
           ("GRU", 2, "forward", {}), ("GRU", 2, "bidirect", {}),
           ("GRU", 1, "forward", {"bias_ih_attr": False}),
           ("LSTM", 2, "bidirect", {"time_major": True})]


def _states(name, n, b, h, seed):
    if name == "LSTM":
        return (_x((n, b, h), seed), _x((n, b, h), seed + 1))
    return _x((n, b, h), seed)


@pytest.mark.parametrize("case", STACKED,
                         ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}" + "".join(
                             f"-{k}" for k in c[3]))
def test_stacked(case):
    name, layers, direction, kw = case
    jl = getattr(jnn, name)(5, 6, num_layers=layers, direction=direction,
                            **kw)
    tl = _carry(jl, getattr(tnn, name)(5, 6, num_layers=layers,
                                       direction=direction, **kw))
    n_dir = 1 if direction == "forward" else 2
    b, t = 3, 7
    x = _x((t, b, 5) if kw.get("time_major") else (b, t, 5), 20)
    fwd = jax.jit(lambda p, xx, st: functional_call(jl, p, xx, st))
    params = get_params(jl)
    for st in (None, _states(name, layers * n_dir, b, 6, 21)):
        jout, jfin = fwd(params, jnp.asarray(x),
                         None if st is None else _to(st, jnp.asarray))
        tout, tfin = tl(torch.from_numpy(x),
                        None if st is None else _to(st, torch.from_numpy))
        _close(tout, jout)
        _close(tfin, jfin)
    out_shape = tuple(tout.shape)
    _grads_match(jl, tl, x, _states(name, layers * n_dir, b, 6, 22),
                 _x(out_shape, 23))


def test_stacked_dropout_and_keys():
    """Dropout between layers: off in eval mode (the output equals JAX's
    eval output), drawn from the key stream in training (the same draw
    under one seed, about the rate's share of the first layer's outputs
    zeroed)."""
    jl = jnn.LSTM(4, 32, num_layers=2, dropout=0.5)
    tl = _carry(jl, tnn.LSTM(4, 32, num_layers=2, dropout=0.5))
    assert list(tl.state_dict())[:4] == [
        "cells.0.weight_ih", "cells.0.weight_hh", "cells.0.bias_ih",
        "cells.0.bias_hh"]
    x = _x((4, 9, 4), 30)
    jl.eval()
    tl.eval()
    _close(tl(torch.from_numpy(x))[0], jl(jnp.asarray(x))[0])
    tl.train()
    tpaddle.seed(3)
    a = tl(torch.from_numpy(x))[0]
    tpaddle.seed(3)
    b = tl(torch.from_numpy(x))[0]
    np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy())
    tpaddle.seed(4)
    c = tl(torch.from_numpy(x))[0]
    assert not torch.equal(a, c)
    seen = []
    orig = tnn.functional.dropout

    def spy(t, p, training=True, **kw):
        out = orig(t, p, training=training, **kw)
        seen.append(float((out == 0).float().mean()))
        return out

    import paddle_tpu_torch.nn.rnn as trnn
    trnn.F.dropout = spy
    try:
        tl(torch.from_numpy(x))
    finally:
        trnn.F.dropout = orig
    assert len(seen) == 1 and abs(seen[0] - 0.5) < 0.1
