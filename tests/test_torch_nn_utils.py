"""Port parity: ``nn.utils`` against the JAX package on the CPU.

- ``weight_norm`` and ``remove_weight_norm`` on a Linear (both of JAX's
  axes) and a Conv2D: ``weight_g``/``weight_v`` carried from JAX by
  ``convert.from_jax_state_dict(..., module=)`` (a Linear's in the port's
  transposed layout), then the same outputs and the gradients to g and v;
- ``spectral_norm`` on a Linear and a Conv2D with JAX's power-iteration
  vectors carried, in training (the vectors move) and eval;
- ``parameters_to_vector`` gives JAX's vector (a Linear weight flattened
  in ``[in, out]`` order) and ``vector_to_parameters`` inverts it;
- ``clip_grad_norm_`` (2, 1, inf) and ``clip_grad_value_`` in JAX's
  functional form.

float32, within 1e-5 + 1e-5·|ref| (gradients 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn as jnn
import paddle_tpu.nn.utils as JU
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.utils as TU
from paddle_tpu.framework.functional import functional_call, get_params
from paddle_tpu_torch.convert import from_jax_state_dict, to_jax_state_dict
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
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _carry(jl, tl):
    sd = {k: np.asarray(v) for k, v in jl.state_dict().items()}
    assert sorted(sd) == sorted(tl.state_dict())
    tl.load_state_dict(from_jax_state_dict(sd, module=tl), strict=True)
    return tl


def _pair(kind):
    if kind == "linear":
        return jnn.Linear(5, 3), tnn.Linear(5, 3), _x((4, 5), 1)
    return jnn.Conv2D(3, 4, 3), tnn.Conv2D(3, 4, 3), _x((2, 3, 6, 6), 1)


@pytest.mark.parametrize("kind,dim", [("linear", 0), ("linear", 1),
                                      ("conv", 0), ("conv", 1)])
def test_weight_norm(kind, dim):
    jl, tl, x = _pair(kind)
    tl.load_state_dict(from_jax_state_dict(
        {k: np.asarray(v) for k, v in jl.state_dict().items()}, module=tl))
    JU.weight_norm(jl, dim=dim)
    TU.weight_norm(tl, dim=dim)
    assert list(tl.state_dict()) == list(jl.state_dict())
    # JAX's g is ||w|| over every axis but dim: keepdims, in JAX's layout
    g_t = tl.weight_g.detach().numpy()
    g_j = np.asarray(jl.weight_g)
    _close(g_t.T if kind == "linear" else g_t, g_j)
    _close(tl(torch.from_numpy(x)), jl(jnp.asarray(x)))
    # change g and v on the JAX side and carry them: still the same outputs
    jl.weight_g = jnn.Parameter(jl.weight_g * 1.5)
    jl.weight_v = jnn.Parameter(jl.weight_v + 0.1)
    _carry(jl, tl)
    _close(tl(torch.from_numpy(x)), jl(jnp.asarray(x)))
    # gradients to g and v
    w_out = _x(tuple(tl(torch.from_numpy(x)).shape), 2)
    params = get_params(jl)
    grads = jax.grad(lambda p: jnp.sum(functional_call(
        jl, p, jnp.asarray(x)) * jnp.asarray(w_out)))(params)
    (tl(torch.from_numpy(x)) * torch.from_numpy(w_out)).sum().backward()
    for name in ("weight_g", "weight_v"):
        g = getattr(tl, name).grad.numpy()
        _close(g.T if kind == "linear" else g, grads[name], 1e-4)
    # and the carried dict round-trips to JAX's layout
    back = to_jax_state_dict(tl.state_dict(), module=tl)
    for k, v in jl.state_dict().items():
        _close(back[k], v)
    JU.remove_weight_norm(jl)
    TU.remove_weight_norm(tl)
    assert sorted(tl.state_dict()) == sorted(jl.state_dict()) == \
        ["bias", "weight"]
    _close(tl(torch.from_numpy(x)), jl(jnp.asarray(x)))
    w = tl.weight.detach().numpy()
    _close(w.T if kind == "linear" else w, jl.weight)


@pytest.mark.parametrize("kind,dim,iters", [("linear", 0, 1),
                                            ("linear", 1, 2),
                                            ("conv", 0, 3)])
def test_spectral_norm(kind, dim, iters):
    jl, tl, x = _pair(kind)
    JU.spectral_norm(jl, n_power_iterations=iters, dim=dim)
    TU.spectral_norm(tl, n_power_iterations=iters, dim=dim)
    assert sorted(tl.state_dict()) == sorted(jl.state_dict())
    _carry(jl, tl)
    for training in (True, False):
        if not training:
            jl.eval()
            tl.eval()
        _close(tl(torch.from_numpy(x)), jl(jnp.asarray(x)))
        _close(tl._spectral_norm.weight_u, jl._spectral_norm.weight_u)
        _close(tl._spectral_norm.weight_v, jl._spectral_norm.weight_v)


def test_parameters_to_vector():
    """JAX's vector, a Linear weight in ``[in, out]`` order."""
    jm = jnn.Sequential(jnn.Linear(3, 4), jnn.ReLU(), jnn.Conv2D(2, 3, 2),
                        jnn.Linear(4, 2, bias_attr=False))
    tm = _carry(jm, tnn.Sequential(tnn.Linear(3, 4), tnn.ReLU(),
                                   tnn.Conv2D(2, 3, 2),
                                   tnn.Linear(4, 2, bias_attr=False)))
    jvec = JU.parameters_to_vector([r.value for r in jm.parameters()])
    tvec = TU.parameters_to_vector(tm.parameters())
    _close(tvec, jvec, 0)
    new = np.arange(tvec.numel(), dtype=np.float32)
    got = TU.vector_to_parameters(torch.from_numpy(new), tm.parameters())
    want = JU.vector_to_parameters(jnp.asarray(new),
                                   [r.value for r in jm.parameters()])
    for (name, p), g, w in zip(tm.named_parameters(), got, want):
        assert g.shape == p.shape
        g = g.numpy()
        _close(g.T if getattr(p, "paddle_transposed", False) else g, w, 0)
    # weight norm's g and v of a Linear are flattened in JAX's order too
    JU.weight_norm(jm[0])
    TU.weight_norm(tm[0])
    _carry(jm, tm)
    _close(TU.parameters_to_vector(tm.parameters()),
           JU.parameters_to_vector([r.value for r in jm.parameters()]), 0)


@pytest.mark.parametrize("norm_type", [2.0, 1.0, 3.0, float("inf")])
@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_grad(norm_type, max_norm):
    gs = [_x((3, 4), 10, 2.0), _x((5,), 11, 2.0), _x((2, 2, 2), 12, 2.0)]
    got, total = TU.clip_grad_norm_(map(torch.from_numpy, gs), max_norm,
                                    norm_type)
    want, jtotal = JU.clip_grad_norm_(list(map(jnp.asarray, gs)), max_norm,
                                      norm_type)
    _close(total, jtotal)
    for g, w in zip(got, want):
        _close(g, w)
    for g, w in zip(TU.clip_grad_value_(map(torch.from_numpy, gs), 0.7),
                    JU.clip_grad_value_(list(map(jnp.asarray, gs)), 0.7)):
        _close(g, w, 0)


def test_clip_grad_nonfinite():
    gs = [torch.tensor([1.0, float("inf")])]
    with pytest.raises(RuntimeError, match="non-finite"):
        TU.clip_grad_norm_(gs, 1.0, error_if_nonfinite=True)
    _, total = TU.clip_grad_norm_(gs, 1.0)
    assert not torch.isfinite(total)
