"""Port parity: the ten vision model files of the zoo (AlexNet, VGG,
MobileNet V1/V2/V3, SqueezeNet, DenseNet, ShuffleNetV2, GoogLeNet,
Inception v3) against the JAX package on the CPU, and ``convert``'s
``module=``.

- Every factory of JAX's ``vision/models`` exists in the port with JAX's
  arguments; each new factory's state_dict has JAX's names and shapes
  (JAX's built under ``jax.eval_shape``; VGG 13/16/19 without their
  classifier, whose 102M-weight Linear VGG-11 already checks).
- One model of each file (and the other variants that change the code
  path: MobileNetV3 Large and Small, SqueezeNet 1.0 and 1.1, ShuffleNetV2
  with swish, GoogLeNet's aux heads) at the smallest input it takes, with
  ``scale`` where the factory has one: JAX's weights carried by
  ``from_jax_state_dict(..., module=)``, the same batch through both in
  eval mode and in training (BatchNorm on the batch's statistics, dropout
  held off on both sides), the logits and the updated running statistics
  compared; for MobileNetV3-Small also every gradient.
- ``convert`` with ``module=`` transposes exactly the Linear weights: VGG's
  and AlexNet's ``classifier.N`` and GoogLeNet's ``fc1``/``fc2`` (which
  the name rule misses) but not MobileNetV3's squeeze-excite ``fc1``/
  ``fc2`` 1x1 convolutions (which it would take); for GPT, BERT, ERNIE,
  ResNet, LeNet and the Transformer it converts exactly as the name rule
  did.

float32: logits within 1e-4 + 1e-4·|ref|, BatchNorm statistics 1e-5,
gradients within 1e-3 of each tensor's largest.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn as jnn
from paddle_tpu.framework.functional import (functional_call, get_buffers,
                                             get_params)
from paddle_tpu.vision import models as JM
import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.convert import (from_jax_state_dict,
                                      linear_weight_keys, to_jax_state_dict)
from paddle_tpu_torch.core.device import device_guard
from paddle_tpu_torch.vision import models as TM
from _torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def cpu_device():
    with device_guard("cpu"):
        yield


NEW = ["alexnet", "vgg11", "vgg13", "vgg16", "vgg19", "mobilenet_v1",
       "mobilenet_v2", "mobilenet_v3_small", "mobilenet_v3_large",
       "squeezenet1_0", "squeezenet1_1", "densenet121", "densenet161",
       "densenet169", "densenet201", "densenet264", "shufflenet_v2_x0_25",
       "shufflenet_v2_x0_33", "shufflenet_v2_x0_5", "shufflenet_v2_x1_0",
       "shufflenet_v2_x1_5", "shufflenet_v2_x2_0", "shufflenet_v2_swish",
       "googlenet", "inception_v3"]


def test_factories_and_arguments():
    """Every name of JAX's ``vision.models``; each new factory and model
    class takes JAX's arguments with JAX's defaults (the classes also a
    keyword-only ``device``)."""
    names = [n for n in vars(JM) if not n.startswith("_")
             and callable(getattr(JM, n))]
    assert names and all(hasattr(TM, n) for n in names)
    classes = ["AlexNet", "VGG", "MobileNetV1", "MobileNetV2",
               "MobileNetV3Small", "MobileNetV3Large", "SqueezeNet",
               "DenseNet", "ShuffleNetV2", "GoogLeNet", "InceptionV3"]
    for n in NEW + classes:
        jp = inspect.signature(getattr(JM, n)).parameters
        tp = dict(inspect.signature(getattr(TM, n)).parameters)
        tp.pop("device", None)
        assert [(p.name, p.default, p.kind) for p in jp.values()] == \
            [(p.name, p.default, p.kind) for p in tp.values()], n
    assert set(NEW + classes) <= set(TM.__all__)


@pytest.mark.parametrize("name", NEW)
def test_names_and_shapes(name):
    kw = dict(num_classes=0 if name.startswith("vgg") else 10)
    if name == "vgg16":
        kw["batch_norm"] = True
    want = jax.eval_shape(lambda: dict(getattr(JM, name)(**kw).state_dict()))
    tm = getattr(TM, name)(device="cpu", **kw)
    assert isinstance(tm, tnn.Layer)
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    lin = linear_weight_keys(tm)
    assert got == {k: tuple(v.shape)[::-1] if k in lin else tuple(v.shape)
                   for k, v in want.items()}


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _no_dropout(model, dropout_cls):
    for m in model.sublayers():
        if isinstance(m, dropout_cls):
            m.eval()


# factory, its arguments, the input side, whether held in training too
PARITY = [
    ("alexnet", {}, 64, True), ("vgg11", {"batch_norm": True}, 32, True),
    ("mobilenet_v1", {"scale": 0.25}, 32, False),
    ("mobilenet_v2", {"scale": 0.5}, 32, False),
    ("mobilenet_v3_small", {"scale": 0.5}, 32, False),
    ("mobilenet_v3_large", {"scale": 0.35}, 32, False),
    ("squeezenet1_0", {}, 64, True), ("squeezenet1_1", {}, 48, True),
    ("shufflenet_v2_x0_25", {}, 32, False),
    ("shufflenet_v2_swish", {}, 32, False),
    ("densenet121", {}, 32, False), ("googlenet", {}, 48, True),
    ("inception_v3", {}, 80, False),
]


_built = {}


def _port(name, **kw):
    """The port's model of ``name`` from seed 0, built once a module (the
    VGG and AlexNet classifiers hold 102M and 55M weights)."""
    key = (name, tuple(sorted(kw.items())))
    if key not in _built:
        tpaddle.seed(0)
        _built[key] = getattr(TM, name)(device="cpu", **kw)
    return _built[key]


def _jax_twin(factory, tm, **kw):
    """JAX's model of the same structure holding the port model's weights
    and buffers: built under ``jax.eval_shape`` (eager, JAX's init draws
    take tens of seconds a model), then filled by ``set_state_dict`` from
    ``to_jax_state_dict(..., module=)``."""
    holder = {}

    def build():
        holder["m"] = factory(**kw)
        return 0

    jax.eval_shape(build)
    jm = holder["m"]
    assert jm.set_state_dict(to_jax_state_dict(tm.state_dict(),
                                               module=tm)) == ([], [])
    return jm


def _calibrate(tm, x):
    """Running statistics set from the batch's (one training pass at
    momentum 0, dropout off), the variance plus 1: with its initial
    statistics a deep random-init net's activations vanish layer by layer,
    and with the batch's own variance a channel of almost no spread
    amplifies rounding without bound."""
    from paddle_tpu_torch.nn.layers import _BatchNormBase
    bns = [m for m in tm.sublayers() if isinstance(m, _BatchNormBase)]
    for m in bns:
        m.momentum = 0.0
    tm.train()
    _no_dropout(tm, tnn.Dropout)
    with torch.no_grad():
        tm(torch.from_numpy(x))
    for m in bns:
        m.momentum = 0.9
        m._variance = m._variance + 1.0


@pytest.mark.parametrize("case", PARITY, ids=[c[0] for c in PARITY])
def test_forward_parity(case):
    """Eval mode for every model, with running statistics of the input's
    scale; training mode (BatchNorm on the batch's statistics, the
    running statistics moved) for the models where it is not chaotic at
    this input: for the others a random-init net of many BatchNorms over
    1x1 or 2x2 maps at batch 2 amplifies float32 rounding past any
    tolerance (ResNet's finding, tools/resnet_grad_sensitivity.py)."""
    name, kw, side, train = case
    tm = _port(name, num_classes=10, **kw)
    x = _x((2, 3, side, side), 1)
    _calibrate(tm, x)
    jm = _jax_twin(getattr(JM, name), tm, num_classes=10, **kw)
    for training in (False, True) if train else (False,):
        jm.train() if training else jm.eval()
        tm.train(training)
        _no_dropout(jm, jnn.Dropout)
        _no_dropout(tm, tnn.Dropout)
        jout, jbufs = jax.jit(lambda p, b, xx: functional_call(
            jm, p, xx, buffers=b, mutable=True))(
            get_params(jm), get_buffers(jm), jnp.asarray(x))
        tout = tm(torch.from_numpy(x))
        if name == "googlenet":
            assert len(tout) == 3
            for a, b in zip(tout, jout):
                _close(a, b, 1e-4)
        else:
            assert float(jnp.abs(jout).max()) > 1e-3    # not vanished
            _close(tout, jout, 1e-4)
        if training:
            for k, v in tm.named_buffers():
                _close(v, jbufs[k], 1e-5)


def test_mobilenet_v3_gradients():
    """Every gradient of a training step's loss, each tensor within 1e-3
    of its 2-norm (plus 1e-6)."""
    kw = dict(num_classes=10, scale=0.5)
    tpaddle.seed(0)
    tm = TM.mobilenet_v3_small(device="cpu", **kw)
    x = _x((4, 3, 32, 32), 2)
    _calibrate(tm, x)
    jm = _jax_twin(JM.mobilenet_v3_small, tm, **kw)
    jm.train()
    tm.train()
    _no_dropout(jm, jnn.Dropout)
    _no_dropout(tm, tnn.Dropout)
    y = np.array([1, 7, 3, 3], np.int32)
    from paddle_tpu.nn.functional import cross_entropy as jce
    from paddle_tpu_torch.nn.functional import cross_entropy as tce
    bufs = get_buffers(jm)

    def loss(p):
        out, _ = functional_call(jm, p, jnp.asarray(x), buffers=bufs,
                                 mutable=True)
        return jce(out, jnp.asarray(y))

    jl, jg = jax.jit(jax.value_and_grad(loss))(get_params(jm))
    tl = tce(tm(torch.from_numpy(x)), torch.from_numpy(y))
    tl.backward()
    _close(tl, jl, 1e-5)
    lin = linear_weight_keys(tm)
    for k, p in tm.named_parameters():
        g = p.grad.numpy()
        g = g.T if k in lin else g
        ref = np.asarray(jg[k])
        assert np.linalg.norm(g - ref) <= 1e-3 * np.linalg.norm(ref) + \
            1e-6, k


# -- convert's module= -------------------------------------------------------

def test_convert_by_structure():
    """``module=`` transposes exactly the Linears' weights, whatever their
    names: VGG's and AlexNet's ``classifier.N``, GoogLeNet's aux ``fc1``/
    ``fc2``, and not MobileNetV3's squeeze-excite ``fc1``/``fc2``
    convolutions. The name rule gets each of those wrong."""
    vgg = _port("vgg11", num_classes=10, batch_norm=True)
    assert linear_weight_keys(vgg) == {"classifier.0.weight",
                                       "classifier.3.weight",
                                       "classifier.6.weight"}
    alex = _port("alexnet", num_classes=10)
    assert linear_weight_keys(alex) == {"classifier.1.weight",
                                        "classifier.4.weight",
                                        "classifier.6.weight"}
    goog = _port("googlenet", num_classes=10)
    assert {k for k in linear_weight_keys(goog) if "aux" in k} == {
        "aux1.fc1.weight", "aux1.fc2.weight", "aux2.fc1.weight",
        "aux2.fc2.weight"}
    # the name rule misses VGG's classifier and GoogLeNet's aux heads (no
    # transpose: the wrong shapes); adding "fc1"/"fc2" to its names would
    # take MobileNetV3's squeeze-excite convolutions for Linears
    for model, key in ((vgg, "classifier.0.weight"),
                       (goog, "aux1.fc1.weight")):
        sd = to_jax_state_dict(model.state_dict(), module=model)
        want = tuple(model.state_dict()[key].shape)
        assert tuple(from_jax_state_dict(sd)[key].shape) == want[::-1]
        back = from_jax_state_dict(sd, module=model)
        assert all(torch.equal(back[k], v)
                   for k, v in model.state_dict().items())
    mb = TM.mobilenet_v3_small(scale=0.5, num_classes=10, device="cpu")
    se = [k for k in mb.state_dict() if k.endswith(("fc1.weight",
                                                    "fc2.weight"))]
    assert se and not set(se) & linear_weight_keys(mb)
    assert all(mb.state_dict()[k].dim() == 4 for k in se)
    sd = to_jax_state_dict(mb.state_dict(), module=mb)
    back = from_jax_state_dict(sd, module=mb)
    for k, v in mb.state_dict().items():
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("name", ["gpt", "bert", "ernie", "ernie_pipeline",
                                  "resnet", "lenet", "transformer"])
def test_convert_earlier_models_unchanged(name):
    """For every earlier model the structure finds exactly the weights the
    name rule found: the conversions are equal key for key, bit for bit."""
    from test_torch_layer_api import _models
    tm = _models()[name][1]()
    sd = to_jax_state_dict(tm.state_dict())
    by_name, by_module = from_jax_state_dict(sd), from_jax_state_dict(
        sd, module=tm)
    assert list(by_name) == list(by_module)
    for k in by_name:
        assert torch.equal(by_name[k], by_module[k]), k
    tsd = tm.state_dict()
    a, b = to_jax_state_dict(tsd), to_jax_state_dict(tsd, module=tm)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
