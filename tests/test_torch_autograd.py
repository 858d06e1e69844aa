"""Port parity: ``paddle_tpu/autograd`` on torch's tape and ``torch.func``.

Each function of the port's ``autograd`` against JAX's on the same numpy
inputs, float32 within 1e-5 + 1e-5·|ref| (1e-4 for second derivatives):
``backward`` in both of JAX's forms (tensors through its eager tape; a
layer and a loss closure), ``grad`` (tensors; a callable), ``value_and_grad``
with ``argnums`` and ``has_aux``, ``jacobian`` (both modes), ``hessian``,
``vjp``, ``jvp``, a ``PyLayer`` against JAX's ``custom_vjp`` form (its own
backward, a non-tensor argument, a tensor input with no gradient), and
``saved_tensors_hooks``.

``no_grad``, ``enable_grad``, ``set_grad_enabled`` and ``is_grad_enabled``
are a stated difference: JAX's are no-ops (``is_grad_enabled`` always
True); the port's switch torch's tape, Paddle's meaning. They are held to
JAX's values of what runs under them, and to the tape's state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu import autograd as jag
from paddle_tpu_torch import autograd as tag
from paddle_tpu_torch.core import device as tdev
from _torch_threads import one_torch_thread  # noqa: F401

_r = np.random.default_rng(5)
X = _r.standard_normal((3, 4)).astype(np.float32)
W = _r.standard_normal((4, 2)).astype(np.float32)
V = _r.standard_normal(5).astype(np.float32)
DV = _r.standard_normal(5).astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    tdev.set_device("cpu")
    yield
    tdev._state.__dict__.pop("device", None)


def close(got, want, tol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got)
    want = np.asarray(getattr(want, "_value", want))
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def t(a, grad=False):
    return torch.tensor(a, requires_grad=grad)


def test_backward_tensors_form():
    jx = jp.to_tensor(X, stop_gradient=False)
    jy = (jx.tanh() * 2.0 + jx * jx).sum()
    jag.backward([jy])
    tx = tp.to_tensor(X, stop_gradient=False)
    ty = (torch.tanh(tx) * 2.0 + tx * tx).sum()
    assert tag.backward([ty]) is None
    close(tx.grad, jx.grad._value)
    # a seed for the output, accumulated into .grad
    jy2 = (jx * 3.0).sum()
    jag.backward([jy2], grad_tensors=[jp.to_tensor(np.float32(2.0))])
    ty2 = (tx * 3.0).sum()
    tag.backward([ty2], grad_tensors=[torch.tensor(2.0)])
    close(tx.grad, jx.grad._value)
    # Paddle's positional spelling backward(tensors, grad_tensors)
    tag.backward((tx * 1.0).sum(), torch.tensor(-6.0))
    close(tx.grad, jx.grad._value - 6.0)


def test_backward_closure_form():
    """JAX's functional form: the loss of a closure run back into a
    layer's parameters (the port's Linear holds JAX's weight transposed)."""
    jl = jp.nn.Linear(4, 2)
    tl = tp.nn.Linear(4, 2, device="cpu")
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(np.asarray(jl.weight).T.copy()))
        tl.bias.copy_(torch.from_numpy(np.asarray(jl.bias)))
    jloss = jag.backward(jl, lambda: jnp.sum(jnp.tanh(jl(X)) ** 2))
    tloss = tag.backward(tl, lambda: torch.sum(torch.tanh(
        tl(torch.from_numpy(X))) ** 2))
    close(tloss, jloss)
    jgrad = {n: p.grad for n, p in jl.named_parameters()}
    close(tl.weight.grad.T, jgrad["weight"])
    close(tl.bias.grad, jgrad["bias"])
    # accumulate=False replaces the gradients; the loss_closure spelling
    tag.backward(tl, loss_closure=lambda m: torch.sum(torch.tanh(
        m(torch.from_numpy(X))) ** 2), accumulate=False)
    close(tl.bias.grad, jgrad["bias"])


def test_grad_tensors_form():
    jx = jp.to_tensor(X, stop_gradient=False)
    jw = jp.to_tensor(W, stop_gradient=False)
    jy = ((jx @ jw).tanh() ** 2).sum()
    jgx, jgw = jag.grad(jy, [jx, jw])
    tx, tw = t(X, True), t(W, True)
    ty = (torch.tanh(tx @ tw) ** 2).sum()
    tgx, tgw = tag.grad(ty, [tx, tw])
    close(tgx, jgx._value)
    close(tgw, jgw._value)
    assert tx.grad is None and tw.grad is None      # no .grad touched
    # a second-order gradient through create_graph
    tz = t(V, True)
    (g1,) = tag.grad((tz ** 3).sum(), [tz], create_graph=True)
    (g2,) = tag.grad(g1.sum(), [tz])
    close(g2, 6 * V)


def test_grad_callable_form():
    close(tag.grad(lambda x: torch.sin(x) * x, t(V)),
          jag.grad(lambda x: jnp.sin(x) * x, jnp.asarray(V)))
    # a pytree of inputs
    tg = tag.grad(lambda d: d["x"] @ d["w"], {"x": t(X), "w": t(W)})
    jg = jag.grad(lambda d: d["x"] @ d["w"], {"x": jnp.asarray(X),
                                               "w": jnp.asarray(W)})
    close(tg["x"], jg["x"])
    close(tg["w"], jg["w"])


def test_value_and_grad():
    def tf(x, w):
        y = torch.tanh(x @ w)
        return torch.sum(y ** 2), y.mean()

    def jf(x, w):
        y = jnp.tanh(x @ w)
        return jnp.sum(y ** 2), y.mean()

    (tv, taux), (tgx, tgw) = tag.value_and_grad(tf, argnums=(0, 1),
                                                has_aux=True)(t(X), t(W))
    (jv, jaux), (jgx, jgw) = jag.value_and_grad(jf, argnums=(0, 1),
                                                has_aux=True)(X, W)
    for a, b in ((tv, jv), (taux, jaux), (tgx, jgx), (tgw, jgw)):
        close(a, b)
    v, g = tag.value_and_grad(lambda x: (x ** 2).sum())(t(V))
    jv, jg = jag.value_and_grad(lambda x: (x ** 2).sum())(V)
    close(v, jv)
    close(g, jg)


@pytest.mark.parametrize("mode", ["reverse", "forward"])
def test_jacobian(mode):
    close(tag.jacobian(lambda x: torch.tanh(x) * x.sum(), t(V), mode=mode),
          jag.jacobian(lambda x: jnp.tanh(x) * x.sum(), jnp.asarray(V),
                       mode=mode))


def test_hessian():
    close(tag.hessian(lambda x: (torch.tanh(x) ** 3).sum(), t(V)),
          jag.hessian(lambda x: (jnp.tanh(x) ** 3).sum(), jnp.asarray(V)),
          tol=1e-4)


@pytest.mark.parametrize("with_v", [False, True])
def test_vjp(with_v):
    tv = t(DV) if with_v else None
    jv = jnp.asarray(DV) if with_v else None
    tout, tg = tag.vjp(lambda x: torch.sin(x) * x, t(V), tv)
    jout, jg = jag.vjp(lambda x: jnp.sin(x) * x, jnp.asarray(V), jv)
    close(tout, jout)
    close(tg, jg)


@pytest.mark.parametrize("with_v", [False, True])
def test_jvp(with_v):
    tv = t(DV) if with_v else None
    jv = jnp.asarray(DV) if with_v else None
    tout, ttan = tag.jvp(lambda x: torch.sin(x) * x, t(V), tv)
    jout, jtan = jag.jvp(lambda x: jnp.sin(x) * x, jnp.asarray(V), jv)
    close(tout, jout)
    close(ttan, jtan)


def test_grad_switches_act_on_the_tape():
    """Stated difference: JAX's switches are no-ops; the port's switch
    torch's tape. The values computed under them are JAX's."""
    tw = t(W, True)
    with tag.no_grad():
        y = torch.from_numpy(X) @ tw
        assert not tag.is_grad_enabled()
        with tag.enable_grad():
            z = torch.from_numpy(X) @ tw
            assert tag.is_grad_enabled()
    with jag.no_grad():
        jy = X @ W
    close(y, jy)
    assert not y.requires_grad and z.requires_grad
    with tag.set_grad_enabled(False):
        assert not tag.is_grad_enabled()
    assert tag.is_grad_enabled() and jag.is_grad_enabled()
    # as a decorator, as Paddle's
    assert not tag.no_grad()(lambda: (t(V, True) * 2).requires_grad)()
    assert tp.no_grad is tag.no_grad and tp.grad is tag.grad


class TScale(tag.PyLayer):
    @staticmethod
    def forward(ctx, x, k, y):
        ctx.save_for_backward(x, y)
        return x * x * k + y

    @staticmethod
    def backward(ctx, dy):
        x, y = ctx.saved_tensor()
        # a deliberately custom rule (3·x, not 2·k·x): the layer's own
        # backward must be the one that runs
        return dy * 3 * x, None


class JScale(jag.PyLayer):
    @staticmethod
    def forward(ctx, x, k, y):
        ctx.save_for_backward(x, y)
        return x * x * k + y

    @staticmethod
    def backward(ctx, dy):
        x, y = ctx.saved_tensor()
        return dy * 3 * x, None


@jax.custom_vjp
def jscale(x, y):
    """What JAX's PyLayer lowers to (``autograd/__init__.py:205-232``),
    written out: its forward, and the layer's backward as the rule, zeros
    for an input the backward gives None."""
    return x * x * 2.0 + y


jscale.defvjp(lambda x, y: (jscale(x, y), (x, y)),
              lambda res, g: (g * 3 * res[0], jnp.zeros_like(res[1])))


def test_pylayer_against_jax_custom_vjp():
    tx, ty = t(V, True), t(DV, True)
    out = TScale.apply(tx, 2.0, ty)
    out.sum().backward()
    jgx, jgy = jax.grad(lambda x, y: jscale(x, y).sum(),
                        argnums=(0, 1))(jnp.asarray(V), jnp.asarray(DV))
    close(out, jscale(jnp.asarray(V), jnp.asarray(DV)))
    # JAX's own PyLayer gives the same forward
    close(out, JScale.apply(jnp.asarray(V), 2.0, jnp.asarray(DV)))
    close(tx.grad, jgx)
    # None for a tensor input: no gradient in the port (JAX pads zeros)
    assert ty.grad is None
    np.testing.assert_array_equal(np.asarray(jgy), 0)


def test_jax_pylayer_is_not_differentiable():
    """A reference fault kept visible: JAX's PyLayer keeps its context
    object among the residuals of its custom_vjp, so jax.grad through it
    raises; the port's differentiates."""
    with pytest.raises(TypeError, match="not a valid JAX type"):
        jax.grad(lambda x: JScale.apply(x, 2.0, x).sum())(jnp.asarray(V))
    tx = t(V, True)
    (g,) = tag.grad(TScale.apply(tx, 2.0, tx).sum(), [tx])
    close(g, 3 * V)     # the layer's rule: None for y


def test_pylayer_context_standalone():
    for ctx in (tag.PyLayerContext(), jag.PyLayerContext()):
        ctx.save_for_backward(1, 2)
        assert tuple(ctx.saved_tensor()) == (1, 2)
        ctx.set_materialize_grads(False)
        assert ctx.materialize_grads is False


def test_saved_tensors_hooks():
    packed = []

    def pack(x):
        packed.append(x.shape)
        return x

    tx = t(V, True)
    with tag.saved_tensors_hooks(pack, lambda x: x):
        y = (torch.sin(tx) * tx).sum()
    y.backward()
    assert packed
    with jag.saved_tensors_hooks(pack, lambda x: x):
        jg = jax.grad(lambda x: (jnp.sin(x) * x).sum())(jnp.asarray(V))
    close(tx.grad, jg)
