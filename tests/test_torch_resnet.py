"""Port parity: the ResNet training slice — bottleneck blocks, a bottleneck
ResNet with every code path of ResNet-50, three Momentum train steps, the
bf16 running-stat buffers and the weight conversion — against the JAX
package.

Weights go from the JAX model to the port through
``convert.from_jax_state_dict``; inputs are made with numpy from a seed and
handed to both sides. The port runs on the CPU, so with
``FLAGS_pallas_conv`` on its convs run K5-K8's plain versions. The JAX
blocks run its Pallas kernels in interpret mode, as
``tests/test_pallas_conv.py`` does; the whole-model comparisons hold the
port (both flags on) against JAX with ``fused_conv_bn=1, pallas_conv=0``
(the units compute the same function on either route, and the whole model
in interpret mode would take minutes), and the port with both flags off
against JAX with both off. The JAX steps are jitted. Each comparison states
its tolerance and why.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.core import flags as jflags
from paddle_tpu.framework.functional import (functional_call, get_buffers,
                                             get_params)
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn import fused_conv_bn  # noqa: F401  (defines the flag)
from paddle_tpu.ops._pallas import conv as pconv
from paddle_tpu.vision.models.resnet import BottleneckBlock as JBottleneck
from paddle_tpu.vision.models.resnet import ResNet as JResNet
from paddle_tpu.vision.models.resnet import resnet50 as jax_resnet50
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import (from_jax_optimizer_state,
                                      from_jax_state_dict, to_jax_state_dict)
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.framework import make_sharded_train_step
from paddle_tpu_torch.nn.functional import cross_entropy
from paddle_tpu_torch.ops._hopper import conv as hc
from paddle_tpu_torch.vision.models import resnet50
from paddle_tpu_torch.vision.models.resnet import (BottleneckBlock, ResNet,
                                                   _fold_stem_weight,
                                                   _space_to_depth)
from _torch_threads import one_torch_thread  # noqa: F401

MODEL = dict(num_classes=10, data_format="NHWC", stem_mode="space_to_depth")
B, IMG = 4, 32


class flags_set:
    """Both packages' conv flags set for a block of code, then restored."""

    def __init__(self, module, fused, pallas):
        self.module, self.want = module, {"fused_conv_bn": fused,
                                          "pallas_conv": pallas}

    def __enter__(self):
        self.prev = self.module.get_flags(list(self.want))
        self.module.set_flags(self.want)

    def __exit__(self, *exc):
        self.module.set_flags(self.prev)


def _jsd(layer):
    return {k: np.asarray(v) for k, v in layer.state_dict().items()}


def _carry(jlayer, tlayer):
    tlayer.load_state_dict(from_jax_state_dict(_jsd(jlayer)), strict=True)
    return tlayer


def _torch_grad(name, p):
    """A port gradient in the JAX layout (``fc``'s weight transposed)."""
    g = p.grad.detach().float().numpy()
    return g.T if name.endswith("fc.weight") else g


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, IMG, IMG, 3)).astype(np.float32),
            rng.integers(0, 10, (B,)).astype(np.int32))


# -- blocks: the Pallas kernels in interpret mode ----------------------------

def _blocks(stride):
    paddle.seed(0)
    planes = 4
    inplanes = planes * 4
    jds = tds = None
    if stride != 1:
        jds = jnn.Sequential(
            jnn.Conv2D(inplanes, planes * 4, 1, stride=stride,
                       bias_attr=False, data_format="NHWC"),
            jnn.BatchNorm2D(planes * 4, data_format="NHWC"))
        tds = tnn.Sequential(
            tnn.Conv2D(inplanes, planes * 4, 1, stride=stride,
                       bias_attr=False, data_format="NHWC", device="cpu"),
            tnn.BatchNorm2D(planes * 4, data_format="NHWC", device="cpu"))
    jb = JBottleneck(inplanes, planes, stride=stride, downsample=jds,
                     data_format="NHWC")
    tb = BottleneckBlock(inplanes, planes, stride=stride, downsample=tds,
                         data_format="NHWC", device="cpu")
    return jb, _carry(jb, tb)


@pytest.mark.parametrize("stride", [1, 2])
def test_bottleneck_block_matches_jax_on_the_kernel_route(stride):
    """One training forward and backward of a BottleneckBlock (8x8, batch
    2, f32, loss sum(out²)) with both flags on in both packages: JAX's
    Pallas kernels in interpret mode against K5-K8's plain versions, every
    conv on the kernel route (counted). Outputs and new buffers within 1e-5
    of their scale; gradients within 1e-4 of each tensor's largest (BN's
    closed form divides by the batch's std over 128 values)."""
    jb, tb = _blocks(stride)
    x = np.random.default_rng(19).standard_normal((2, 8, 8, 16)).astype(
        np.float32)
    with flags_set(jflags, 1, 1):
        params, buffers = get_params(jb), get_buffers(jb)

        def loss_fn(p):
            out, nb = functional_call(jb, p, jnp.asarray(x), buffers=buffers,
                                      mutable=True, training=True)
            return jnp.sum(out * out), (out, nb)

        (_, (jout, jbuf)), jgrads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)
    calls = {"fwd": 0, "dgrad": 0, "wgrad": 0}
    spies = {name: getattr(hc, f"conv2d_{name}") for name in calls}

    def spy(name):
        def counted(*a, **k):
            calls[name] += 1
            return spies[name](*a, **k)
        return counted

    tb.train()
    with flags_set(tflags, 1, 1), pytest.MonkeyPatch.context() as mp:
        for name in calls:
            mp.setattr(hc, f"conv2d_{name}", spy(name))
        tx = torch.from_numpy(x).requires_grad_()   # every conv's dgrad
        out = tb(tx)
        (out * out).sum().backward()
    n_convs = 4 if stride != 1 else 3
    assert calls == {"fwd": n_convs, "dgrad": n_convs, "wgrad": n_convs}
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5 * float(np.abs(
                                   np.asarray(jout)).max()))
    for name, p in tb.named_parameters():
        want = np.asarray(jgrads[name])
        np.testing.assert_allclose(_torch_grad(name, p), want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()),
                                   err_msg=name)
    for name, buf in tb.named_buffers():
        np.testing.assert_allclose(buf.numpy(), np.asarray(jbuf[name]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


# -- the model: every code path of ResNet-50 with fewer blocks ---------------

@pytest.fixture(scope="module")
def jax_model():
    paddle.seed(0)
    return JResNet(JBottleneck, 18, **MODEL)


def _jax_forward_backward(jm, fused, pallas):
    """Loss, logits, new buffers and gradients of one jitted JAX training
    step's forward and backward."""
    x, y = _batch()
    with flags_set(jflags, fused, pallas):
        params, buffers = get_params(jm), get_buffers(jm)

        def loss_fn(p):
            out, nb = functional_call(jm, p, jnp.asarray(x), buffers=buffers,
                                      mutable=True, training=True)
            return JF.cross_entropy(out.astype(jnp.float32), jnp.asarray(y),
                                    reduction="mean"), (out, nb)

        (loss, (out, nb)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)
    return (float(loss), np.asarray(out),
            {k: np.asarray(v) for k, v in nb.items()},
            {k: np.asarray(v) for k, v in grads.items()})


@pytest.fixture(scope="module")
def jax_runs(jax_model):
    return {"kernels": _jax_forward_backward(jax_model, 1, 0),
            "plain": _jax_forward_backward(jax_model, 0, 0)}


def _torch_model(jm, dtype=torch.float32):
    tm = ResNet(BottleneckBlock, 18, **MODEL, device="cpu", dtype=dtype)
    _carry(jm, tm)
    return tm.train()


def _torch_forward_backward(jm, fused, pallas, dtype=torch.float32):
    x, y = _batch()
    tm = _torch_model(jm, dtype)
    launches = hc.mm.launches + hc.c3.launches
    with flags_set(tflags, fused, pallas):
        out = tm(torch.from_numpy(x).to(dtype))
        loss = cross_entropy(out.float(), torch.from_numpy(y))
        loss.backward()
    assert hc.mm.launches + hc.c3.launches == launches  # CPU: plain only
    return tm, float(loss.detach()), out.detach().double().numpy()


PAIRINGS = {"kernels": (1, 1), "plain": (0, 0)}


@pytest.mark.parametrize("pairing", ["kernels", "plain"])
def test_resnet_forward_backward_matches_jax(jax_model, jax_runs, pairing):
    """``ResNet(BottleneckBlock, 18, num_classes=10, NHWC,
    space_to_depth)`` at 32x32, batch 4, f32: the port with both flags on
    (K5-K8's plain versions) against JAX with ``fused_conv_bn=1``, and both
    flags off against both off.

    The last stage normalises 4 values per channel (1x1 pixels x batch 4),
    where a ReLU can flip on a rounding difference: each block alone agrees
    with JAX's kernels tightly (the block test), but through the model the
    f32 sums of the two frameworks, taken in other orders, move gradient
    entries by a large share of their tensor's largest. On the CPU alone a
    1e-7 relative change of the input moves this model's gradients (with
    the port's own seed-0 weights) by up to 19% of a tensor's 2-norm and
    72% of its largest, and its loss by 6e-6
    (``tools/resnet_grad_sensitivity.py``). So gradients are held per
    tensor in the 2-norm, within 5e-2; the loss within 1e-4, the logits
    within 2e-3 and the new buffers within 1e-3 relative plus 1e-4 (JAX's
    own fused-against-plain model test uses the last two)."""
    jloss, jout, jbuf, jgrads = jax_runs[pairing]
    tm, loss, out = _torch_forward_backward(jax_model, *PAIRINGS[pairing])
    assert abs(loss - jloss) <= 1e-4
    np.testing.assert_allclose(out, jout, rtol=0, atol=2e-3)
    for name, buf in tm.named_buffers():
        np.testing.assert_allclose(buf.numpy(), jbuf[name], rtol=1e-3,
                                   atol=1e-4, err_msg=name)
    params = dict(tm.named_parameters())
    assert set(params) == set(jgrads)
    for name, p in params.items():
        g, want = _torch_grad(name, p), jgrads[name]
        rel = np.linalg.norm(g - want) / np.linalg.norm(want)
        assert rel <= 5e-2, (name, rel)


def test_resnet_routes_agree_and_match_float64(jax_model):
    """Within the port, the kernel route (both flags on) and the plain
    route (both off) compute the same function: f32 gradients within 1e-3
    of each tensor's largest (the stats are summed in other orders on the
    two routes); and both are within 2e-3 of the gradients of the same
    model in float64, whose BN statistics are summed in f32 too, in the
    same order."""
    grads = {}
    for key, fl, dt in (("kernels", (1, 1), torch.float32),
                        ("plain", (0, 0), torch.float32),
                        ("f64", (0, 0), torch.float64)):
        tm, _, _ = _torch_forward_backward(jax_model, *fl, dtype=dt)
        grads[key] = {n: p.grad.double().numpy()
                      for n, p in tm.named_parameters()}
    for name, want in grads["f64"].items():
        scale = np.abs(want).max()
        for key, tol in (("kernels", 2e-3), ("plain", 2e-3)):
            err = np.abs(grads[key][name] - want).max() / scale
            assert err <= tol, (key, name, err)
        err = np.abs(grads["kernels"][name] - grads["plain"][name]).max()
        assert err <= 1e-3 * scale, (name, err / scale)


def test_space_to_depth_stem_is_the_7x7_conv():
    """The folded 4x4/s1 stem over space-to-depth input equals the 7x7/s2
    conv with padding 3, and its weight gradient reaches conv1.weight."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 16, 16, 3)))
    w = torch.from_numpy(rng.standard_normal((8, 3, 7, 7))).requires_grad_()
    xs = torch.nn.functional.pad(_space_to_depth(x), (0, 0, 2, 1, 2, 1))
    y = torch.nn.functional.conv2d(xs.permute(0, 3, 1, 2),
                                   _fold_stem_weight(w))
    ref = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w, stride=2,
                                     padding=3)
    torch.testing.assert_close(y, ref, rtol=1e-12, atol=1e-12)
    y.sum().backward()
    assert w.grad is not None and float(w.grad.abs().sum()) > 0


# -- three Momentum train steps ----------------------------------------------

def _np_state(state):
    return {"step": np.asarray(state["step"]),
            "param_states": {n: {k: np.asarray(v) for k, v in st.items()}
                             for n, st in state["param_states"].items()}}


def test_train_steps_match_jax_loop(jax_model):
    """3 steps of Momentum(momentum 0.9, multi_precision), bench.py's
    optimizer, at lr 0.01 (at bench.py's 0.1 this toy's loss explodes in
    both packages), through ``TrainStep`` with both flags on, against the
    JAX loop (``functional_call`` with mutable buffers,
    ``apply_gradients``; ``fused_conv_bn=1``), f32.

    This toy memorises its 4 random labels in a step or two, and its last
    stage normalises 4 values per channel, so two correct f32
    implementations drift apart over steps: the port's own two routes
    (flags on and off) reach third-step losses of 0.82 and 1.39 from the
    same start (``tools/resnet_grad_sensitivity.py``). So each port step
    starts from the JAX loop's
    state at that step (params, buffers, velocities and the step count,
    loaded through ``from_jax_optimizer_state`` and
    ``TrainStep.load_state_dict``) and is held against the JAX step from
    it: the loss within 1e-4; the new parameters, velocities and buffers
    per tensor within 1e-2 of their 2-norm (one step of the gradient
    differences the forward/backward test bounds)."""
    x, y = _batch()
    lr = 0.01
    opt = jopt.Momentum(learning_rate=lr, momentum=0.9, multi_precision=True)
    jm = jax_model
    with flags_set(jflags, 1, 0):
        params, buffers = get_params(jm), get_buffers(jm)
        state = opt.init(params)

        def loss_fn(p, buf):
            out, nb = functional_call(jm, p, jnp.asarray(x), buffers=buf,
                                      mutable=True, training=True)
            return JF.cross_entropy(out.astype(jnp.float32), jnp.asarray(y),
                                    reduction="mean"), nb

        @jax.jit
        def jstep(p, buf, st):
            (loss, nb), g = jax.value_and_grad(loss_fn, has_aux=True)(p, buf)
            p, st = opt.apply_gradients(p, g, st, lr)
            return loss, p, nb, st

        trajectory = [(params, buffers, state)]
        jlosses = []
        for _ in range(3):
            loss, params, buffers, state = jstep(params, buffers, state)
            jlosses.append(float(loss))
            trajectory.append((params, buffers, state))
    assert jlosses[2] < jlosses[0]

    step = make_sharded_train_step(
        _torch_model(jm), topt.Momentum(learning_rate=lr, momentum=0.9,
                                        multi_precision=True),
        lambda m, b: cross_entropy(m(b[0]).float(), b[1]))

    def close(got, want, what):
        rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert rel <= 1e-2, (what, rel)

    for i in range(3):
        p, buf, st = trajectory[i]
        step.load_state_dict({
            "params": from_jax_state_dict({k: np.asarray(v)
                                           for k, v in p.items()}),
            "buffers": {k: np.array(v) for k, v in buf.items()},
            "opt_state": from_jax_optimizer_state(_np_state(st)),
            "step_count": i})
        with flags_set(tflags, 1, 1):
            loss = float(step.step((x, y)))
        assert abs(loss - jlosses[i]) <= 1e-4, (i, loss, jlosses[i])
        p, buf, st = trajectory[i + 1]
        want = from_jax_state_dict({k: np.asarray(v) for k, v in p.items()})
        for name, q in step.model.named_parameters():
            close(q.detach().numpy(), want[name].numpy(), f"{i}: {name}")
        for name, b in step.model.named_buffers():
            close(b.numpy(), np.asarray(buf[name]), f"{i}: {name}")
        want_st = from_jax_optimizer_state(_np_state(st))
        assert int(step.opt_state["step"]) == int(want_st["step"]) == i + 1
        for name, leaves in want_st["param_states"].items():
            got = step.opt_state["param_states"][name]
            assert set(got) == set(leaves) == {"velocity"}
            close(got["velocity"].numpy(), leaves["velocity"].numpy(),
                  f"{i}: {name}.velocity")


# -- bf16 buffers ------------------------------------------------------------

@pytest.mark.parametrize("fused", [1, 0], ids=["fused", "plain"])
def test_bf16_running_stats_come_back_float32_as_in_jax(fused):
    """After a cast to bf16 the BN buffers are bf16; a training step
    replaces them with ``0.9 · bf16 + 0.1 · f32``, which promotes to f32 in
    both frameworks. The port must replace the buffer, not copy into its
    bf16 storage (that would round every update). Against JAX's
    ``astype(bfloat16)`` block with the same flags (the Pallas kernels in
    interpret mode when fused): float32 buffers, equal within 1e-2 relative
    (stats of bf16 convs summed in f32, from outputs that may round
    differently) and not all representable in bf16."""
    jb, tb = _blocks(2)
    jb.astype(jnp.bfloat16)
    tb.to(torch.bfloat16)
    assert all(b.dtype == torch.bfloat16 for b in tb.buffers())
    x = np.random.default_rng(20).standard_normal((2, 8, 8, 16)).astype(
        np.float32)
    with flags_set(jflags, fused, fused):
        _, jbuf = functional_call(jb, get_params(jb),
                                  jnp.asarray(x, jnp.bfloat16),
                                  buffers=get_buffers(jb), mutable=True,
                                  training=True)
    tb.train()
    with flags_set(tflags, fused, fused), torch.no_grad():
        tb(torch.from_numpy(x).to(torch.bfloat16))
    for name, buf in tb.named_buffers():
        assert buf.dtype == torch.float32, name
        assert jbuf[name].dtype == jnp.float32, name
        np.testing.assert_allclose(buf.numpy(), np.asarray(jbuf[name]),
                                   rtol=1e-2, atol=1e-3, err_msg=name)
    var = tb.bn2._variance
    assert not torch.equal(var, var.to(torch.bfloat16).float())


def test_train_step_resumes_float32_buffers_into_a_bf16_model():
    """A TrainStep state saved after a step of a bf16 bottleneck block
    (both flags on) holds float32 BN buffers; loading it into a fresh bf16
    block must restore them as float32 (a copy into the bf16 storage would
    round them), so the resumed step equals the unbroken one."""
    x = torch.from_numpy(np.random.default_rng(21).standard_normal(
        (2, 8, 8, 16)).astype(np.float32)).to(torch.bfloat16)

    def make():
        block = _blocks(2)[1].to(torch.bfloat16).train()
        return make_sharded_train_step(
            block, topt.Momentum(learning_rate=0.1, momentum=0.9,
                                 multi_precision=True),
            lambda m, b: (m(b[0]).float() ** 2).mean())

    with flags_set(tflags, 1, 1):
        a = make()
        a.step((x,))
        saved = a.state_dict()
        want = float(a.step((x,)))
        b = make()
        b.load_state_dict(saved)
        for name, buf in b.model.named_buffers():
            assert buf.dtype == torch.float32, name
            assert torch.equal(buf, saved["buffers"][name]), name
        assert float(b.step((x,))) == want


# -- weight conversion -------------------------------------------------------

def test_resnet50_state_dict_loads_strictly():
    """JAX ``resnet50(NHWC, space_to_depth)``'s state_dict loads strictly
    into the port's: every key (BN buffers included) carried, conv weights
    as they are (OIHW in both), ``fc.weight`` transposed."""
    paddle.seed(1)
    jm = jax_resnet50(data_format="NHWC", stem_mode="space_to_depth")
    sd = _jsd(jm)
    tm = resnet50(data_format="NHWC", stem_mode="space_to_depth",
                  device="cpu")
    tm.load_state_dict(from_jax_state_dict(sd), strict=True)
    tsd = tm.state_dict()
    assert len(tsd) == len(sd) == 267    # 53 convs, 53 BNs x 4, fc x 2
    np.testing.assert_array_equal(tsd["fc.weight"].numpy(), sd["fc.weight"].T)
    np.testing.assert_array_equal(tsd["layer3.5.conv2.weight"].numpy(),
                                  sd["layer3.5.conv2.weight"])
    np.testing.assert_array_equal(tsd["layer4.0.downsample.1._variance"]
                                  .numpy(), sd["layer4.0.downsample.1."
                                               "_variance"])
    n_params = sum(p.numel() for p in tm.parameters())
    assert n_params == 25_557_032


def test_convert_round_trip_with_momentum_state(jax_model):
    """``to_jax_state_dict ∘ from_jax_state_dict`` is the identity on the
    ResNet's state_dict, and a Momentum state (velocity, and the f32 master
    of a bf16 model) converts leaf by leaf, ``fc``'s leaves transposed."""
    sd = _jsd(jax_model)
    back = to_jax_state_dict(from_jax_state_dict(sd))
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    params = {k: v.astype(jnp.bfloat16)
              for k, v in get_params(jax_model).items()}
    state = jopt.Momentum(learning_rate=0.1, momentum=0.9,
                          multi_precision=True).init(params)
    rng = np.random.default_rng(4)
    state["param_states"] = {
        n: {k: jnp.asarray(rng.standard_normal(v.shape), jnp.float32)
            for k, v in st.items()}
        for n, st in state["param_states"].items()}
    got = from_jax_optimizer_state(
        {"step": np.asarray(state["step"]),
         "param_states": {n: {k: np.asarray(v) for k, v in st.items()}
                          for n, st in state["param_states"].items()}})
    fc = state["param_states"]["fc.weight"]
    assert set(fc) == {"velocity", "master"}
    for key in ("velocity", "master"):
        np.testing.assert_array_equal(
            got["param_states"]["fc.weight"][key].numpy(),
            np.asarray(fc[key]).T)
    conv = state["param_states"]["layer1.0.conv2.weight"]["velocity"]
    np.testing.assert_array_equal(
        got["param_states"]["layer1.0.conv2.weight"]["velocity"].numpy(),
        np.asarray(conv))


def test_pallas_top3_shapes_are_the_jax_ones():
    assert hc.RESNET50_TOP3_SHAPES == pconv.RESNET50_TOP3_SHAPES


@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
def test_batch_norm_train_matches_jax(data_format):
    """``F.batch_norm`` in training, in both layouts: the output, the
    closed-form gradients of x, weight and bias, and the running stats
    against the JAX function (its closed form, ``_bn_train_core``). f32 on
    both sides; the f32 sums run in other orders over 4·6·5 = 120 values a
    channel, so 1e-5 relative."""
    from paddle_tpu_torch.nn import functional as TFn
    rng = np.random.default_rng(7)
    shape = (4, 3, 6, 5) if data_format == "NCHW" else (4, 6, 5, 3)
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    w, b = (rng.standard_normal(3).astype(np.float32) for _ in range(2))
    rm, rv = rng.standard_normal(3).astype(np.float32), \
        rng.uniform(0.5, 2, 3).astype(np.float32)

    def jfn(x_, w_, b_):
        out, nm, nv = JF.batch_norm(x_, jnp.asarray(rm), jnp.asarray(rv),
                                    w_, b_, training=True,
                                    data_format=data_format)
        return out, (nm, nv)

    jout, vjp, (jm, jv) = jax.vjp(jfn, x, w, b, has_aux=True)
    jgrads = vjp(jnp.asarray(dy))
    tx, tw, tb = (torch.tensor(a, requires_grad=True) for a in (x, w, b))
    tout, tm, tv = TFn.batch_norm(tx, torch.tensor(rm), torch.tensor(rv),
                                  tw, tb, training=True,
                                  data_format=data_format)
    tout.backward(torch.tensor(dy))
    for name, got, want in (("out", tout, jout), ("mean", tm, jm),
                            ("var", tv, jv), ("dx", tx.grad, jgrads[0]),
                            ("dweight", tw.grad, jgrads[1]),
                            ("dbias", tb.grad, jgrads[2])):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
