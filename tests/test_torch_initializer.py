"""Port parity: ``nn.initializer`` and ``ParamAttr`` against the JAX
package.

- The deterministic initializers (``Constant``, ``Assign``, ``Dirac``,
  ``Bilinear``), ``calculate_gain`` and the fans give JAX's values exactly.
- The random ones draw from the port's own key stream (other bits than
  threefry's), so each is held to its distribution: every value inside the
  bounds, and the sample mean and standard deviation of 2^17 draws within
  6 standard errors of the distribution's (the mean's error is
  ``std / sqrt(n)``, the standard deviation's about ``std / sqrt(2 n)``;
  a wrong formula, a swapped fan or a missing gain misses by far more).
  JAX's draw is held to the same check, so both sides are seen to draw from
  one distribution.
- ``ParamAttr``: the explicit initializer wins over the global one, the
  global one over the layer's default, and ``trainable=False`` leaves the
  parameter out of ``TrainStep``, as JAX leaves it out of its trainable
  parameters.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.framework.functional import get_params
from paddle_tpu.nn import initializer as JI
from paddle_tpu_torch import ParamAttr as RootParamAttr
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.framework import make_sharded_train_step
from paddle_tpu_torch.nn import initializer as TI
from paddle_tpu_torch.nn.layer import ParamAttr, create_parameter
from _torch_threads import one_torch_thread  # noqa: F401

SHAPE = (256, 512)     # 2^17 draws; a Linear weight [in, out]
N = SHAPE[0] * SHAPE[1]


def both(name, *args, shape=SHAPE, **kwargs):
    """(JAX's value, the port's) of one initializer on ``shape``, f32."""
    paddle.seed(0)
    j = np.asarray(getattr(JI, name)(*args, **kwargs)(shape))
    t = getattr(TI, name)(*args, **kwargs)(shape, device="cpu").numpy()
    assert t.shape == j.shape and t.dtype == j.dtype == np.float32
    return j, t


@pytest.mark.parametrize("name,args,shape", [
    ("Constant", (0.25,), (3, 5)),
    ("Assign", (np.arange(12.0).reshape(3, 4),), (3, 4)),
    ("Assign", (np.arange(12.0),), (4, 3)),        # reshaped, as in JAX
    ("Dirac", (), (6, 3, 3, 3)),
    ("Dirac", (2,), (4, 4, 3, 3)),
    ("Bilinear", (), (2, 1, 4, 4)),
    ("Bilinear", (), (1, 1, 3, 5)),
])
def test_deterministic_initializers_equal_jax(name, args, shape):
    j, t = both(name, *args, shape=shape)
    np.testing.assert_array_equal(t, j)


def test_assign_of_a_tensor_and_the_dtype():
    v = torch.arange(6.0).reshape(2, 3)
    out = TI.Assign(v)((2, 3), dtype="bfloat16", device="cpu")
    assert out.dtype == torch.bfloat16 and torch.equal(out.float(), v)
    assert TI.Constant(2.0)((2,), dtype=torch.float16,
                            device="cpu").dtype == torch.float16


@pytest.mark.parametrize("nl,param", [
    ("sigmoid", None), ("linear", None), ("conv2d", None), ("tanh", None),
    ("relu", None), ("leaky_relu", None), ("leaky_relu", 0.2),
    ("leaky_relu", math.sqrt(5)), ("selu", None)])
def test_calculate_gain_equals_jax(nl, param):
    assert TI.calculate_gain(nl, param) == JI.calculate_gain(nl, param)


def test_unknown_gain_raises_as_in_jax():
    for mod in (JI, TI):
        with pytest.raises(ValueError, match="Unsupported"):
            mod.calculate_gain("swish")


@pytest.mark.parametrize("shape", [(), (7,), (3, 5), (8, 4, 3, 3),
                                   (6, 2, 5), (2, 3, 2, 2, 2)])
def test_fans_equal_jax(shape):
    assert TI._fan_in_out(shape) == JI._fan_in_out(shape)


def _normal_moments(x, mean, std):
    assert abs(float(x.mean()) - mean) <= 6 * std / math.sqrt(x.size)
    assert abs(float(x.std()) - std) <= 6 * std / math.sqrt(2 * x.size)


def _uniform_check(x, low, high):
    assert float(x.min()) >= low and float(x.max()) <= high
    mean, std = (low + high) / 2, (high - low) / math.sqrt(12)
    # the uniform's std of the sample std is std * sqrt(0.8 / (4 n))
    assert abs(float(x.mean()) - mean) <= 6 * std / math.sqrt(x.size)
    assert abs(float(x.std()) - std) <= 6 * std * math.sqrt(0.2 / x.size)


FI, FO = SHAPE


@pytest.mark.parametrize("name,args,kwargs,mean,std", [
    ("Normal", (0.5, 2.0), {}, 0.5, 2.0),
    ("XavierNormal", (), {}, 0.0, math.sqrt(2.0 / (FI + FO))),
    ("XavierNormal", (), {"fan_in": 10, "fan_out": 30, "gain": 2.0}, 0.0,
     2.0 * math.sqrt(2.0 / 40)),
    ("KaimingNormal", (), {}, 0.0, math.sqrt(2.0) / math.sqrt(FI)),
    ("KaimingNormal", (), {"fan_in": 50, "negative_slope": 0.2,
                           "nonlinearity": "leaky_relu"}, 0.0,
     math.sqrt(2.0 / 1.04) / math.sqrt(50)),
])
def test_normal_initializers_draw_their_distribution(name, args, kwargs,
                                                     mean, std):
    for x in both(name, *args, **kwargs):
        _normal_moments(x, mean, std)


@pytest.mark.parametrize("name,args,kwargs,limit", [
    ("Uniform", (-0.3, 0.7), {}, None),
    ("XavierUniform", (), {}, math.sqrt(6.0 / (FI + FO))),
    ("KaimingUniform", (), {}, math.sqrt(2.0) * math.sqrt(3.0 / FI)),
    ("KaimingUniform", (), {"fan_in": 27, "negative_slope": math.sqrt(5),
                            "nonlinearity": "leaky_relu"},
     1 / math.sqrt(27)),
])
def test_uniform_initializers_draw_their_distribution(name, args, kwargs,
                                                      limit):
    low, high = (-0.3, 0.7) if limit is None else (-limit, limit)
    for x in both(name, *args, **kwargs):
        _uniform_check(x, low, high)


def test_truncated_normal_draws_its_distribution():
    """mean 1, std 0.5, cut at [-2, 2] standard deviations: every value in
    [0, 2], and the truncated law's moments (std 0.8796 of the untruncated
    one)."""
    a, b = -2.0, 2.0
    phi = lambda t: math.exp(-t * t / 2) / math.sqrt(2 * math.pi)  # noqa
    z = math.erf(b / math.sqrt(2))
    tstd = math.sqrt(1 - 2 * b * phi(b) / z)
    for x in both("TruncatedNormal", 1.0, 0.5, a, b):
        assert float(x.min()) >= 0.0 and float(x.max()) <= 2.0
        _normal_moments(x, 1.0, 0.5 * tstd)


@pytest.mark.parametrize("shape", [(64, 32), (32, 64), (16, 4, 3, 3)])
def test_orthogonal_is_orthogonal_as_in_jax(shape):
    for x in both("Orthogonal", 1.5, shape=shape):
        m = x.reshape(shape[0], -1)
        gram = m @ m.T if m.shape[0] <= m.shape[1] else m.T @ m
        np.testing.assert_allclose(gram, 2.25 * np.eye(gram.shape[0]),
                                   atol=1e-4)


def test_draws_follow_the_key():
    """One key, one value; the next key of the stream another."""
    init = TI.XavierNormal()
    a = init((8, 8), key=5, device="cpu")
    assert torch.equal(a, init((8, 8), key=5, device="cpu"))
    assert not torch.equal(a, init((8, 8), device="cpu"))


# -- ParamAttr ------------------------------------------------------------------

def _jax_param(attr, default, is_bias=False):
    return np.asarray(jnn.Layer().create_parameter(
        (3,), attr=attr, is_bias=is_bias, default_initializer=default).value)


def _port_param(attr, default, is_bias=False):
    return create_parameter((3,), attr, is_bias=is_bias,
                            default_initializer=default,
                            device="cpu").detach().numpy()


@pytest.mark.parametrize("case", ["attr", "global", "default", "fallback",
                                  "bias_fallback", "bare_initializer"])
def test_param_attr_precedence_matches_jax(case):
    """Explicit initializer > global > the layer's default > Constant(0)
    for a bias, XavierNormal otherwise (told apart by Constants)."""
    mk = {"j": (jnn.ParamAttr, JI), "t": (ParamAttr, TI)}
    got = {}
    for side, (PA, I) in mk.items():
        attr = PA(initializer=I.Constant(1.0)) if case == "attr" else \
            I.Constant(5.0) if case == "bare_initializer" else None
        glob = case in ("attr", "global")
        default = None if case in ("fallback", "bias_fallback") else \
            I.Constant(3.0)
        I.set_global_initializer(I.Constant(2.0) if glob else None,
                                 I.Constant(2.0) if glob else None)
        try:
            make = _jax_param if side == "j" else _port_param
            got[side] = make(attr, default, is_bias=case == "bias_fallback")
        finally:
            I.set_global_initializer(None, None)
    if case == "fallback":      # XavierNormal: drawn, so by distribution
        assert got["t"].std() > 0 and got["j"].std() > 0
    else:
        np.testing.assert_array_equal(got["t"], got["j"])
        want = {"attr": 1.0, "global": 2.0, "default": 3.0,
                "bias_fallback": 0.0, "bare_initializer": 5.0}[case]
        assert (got["t"] == want).all()


def test_param_attr_fields_and_root_export():
    attr = ParamAttr(name="w", learning_rate=0.5, regularizer="l2",
                     need_clip=False)
    p = create_parameter((2, 2), attr, device="cpu")
    assert p.param_attr is attr and p.requires_grad
    assert RootParamAttr is ParamAttr
    assert ParamAttr._to_attr("name").name == "name"
    with pytest.raises(TypeError):
        ParamAttr._to_attr(3.0)


def test_trainable_false_is_left_out_as_in_jax():
    """``trainable=False``: ``requires_grad=False``, so ``TrainStep``
    leaves the weight out and it keeps its value; JAX's trainable
    parameters leave it out too."""
    frozen = {"j": jnn.ParamAttr(trainable=False),
              "t": ParamAttr(trainable=False)}
    jl = jnn.Linear(4, 3, weight_attr=frozen["j"])
    assert set(get_params(jl, trainable_only=True)) == {"bias"}
    tl = tnn.Linear(4, 3, weight_attr=frozen["t"], device="cpu")
    assert not tl.weight.requires_grad and tl.bias.requires_grad
    before = tl.weight.detach().clone()
    step = make_sharded_train_step(
        tl, topt.SGD(0.1), lambda m, x: m(x).square().sum())
    assert set(step.params) == {"bias"}
    step.step(torch.ones(2, 4))
    assert torch.equal(tl.weight, before)
    assert not torch.equal(tl.bias, torch.zeros(3))


def test_layers_take_initializers_as_jax_does():
    """A Constant weight and bias through ``weight_attr``/``bias_attr``,
    and ``bias_attr=False``: the same values as the JAX layers (the port's
    Linear weight transposed)."""
    jl = jnn.Linear(3, 2, weight_attr=JI.Assign(np.arange(6.0).reshape(
        3, 2)), bias_attr=jnn.ParamAttr(initializer=JI.Constant(0.5)))
    tl = tnn.Linear(3, 2, weight_attr=TI.Assign(np.arange(6.0).reshape(
        3, 2)), bias_attr=ParamAttr(initializer=TI.Constant(0.5)),
        device="cpu")
    np.testing.assert_array_equal(tl.weight.detach().numpy().T,
                                  np.asarray(jl.weight))
    np.testing.assert_array_equal(tl.bias.detach().numpy(),
                                  np.asarray(jl.bias))
    x = np.arange(6.0, dtype=np.float32).reshape(2, 3)
    np.testing.assert_allclose(
        tl(torch.from_numpy(x)).detach().numpy(), np.asarray(jl(
            jnp.asarray(x))), rtol=1e-6)
    assert tnn.Linear(3, 2, bias_attr=False, device="cpu").bias is None
    conv = tnn.Conv2D(2, 4, 3, weight_attr=TI.Dirac(), bias_attr=False,
                      device="cpu")
    jconv = jnn.Conv2D(2, 4, 3, weight_attr=JI.Dirac(), bias_attr=False)
    np.testing.assert_array_equal(conv.weight.detach().numpy(),
                                  np.asarray(jconv.weight))
    ln = tnn.LayerNorm(5, weight_attr=False, bias_attr=False, device="cpu")
    assert ln.weight is None and ln.bias is None
