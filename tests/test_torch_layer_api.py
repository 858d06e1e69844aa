"""Port parity: the ``Layer`` API of ``nn/layer.py`` (``Layer``,
``Parameter``, ``ParamRef``, ``HookRemoveHelper``) and the rebase of every
earlier layer and model onto it, against the JAX package on the CPU.

- GPT, BERT, ERNIE, ResNet, LeNet and ``nn.Transformer`` (and ERNIE's
  ``PipelineLayer``): their state_dict keys are torch's own (the rebase
  changes none) and JAX's; ``sublayers()`` lists the JAX model's
  sublayer names in JAX's order; ``set_state_dict`` of a partial and an
  extended dict gives JAX's ``(missing, unexpected)``;
- ``model.to("cpu")`` and ``.to(dtype)`` keep torch's meaning;
  ``astype`` casts the floating parameters and buffers as JAX's does;
- the methods one by one against JAX's: ``create_parameter``,
  ``add_parameter``, ``add_sublayer``, ``register_buffer(persistable=)``
  with ``state_dict(include_non_persistable_buffer=)``, ``parameters``,
  ``named_param_specs``, ``clear_gradients``, the forward hooks and their
  removal, ``full_name``, ``Parameter.stop_gradient``, ``ParamRef``,
  ``Dropout(name=)``, ``Identity(dtype=, name_scope=)``,
  ``LayerList.sublayers()``, ``PipelineLayer.stage_of_layer``.

Outputs compared in float32 within 1e-5 + 1e-5·|ref|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn as jnn
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.convert import from_jax_state_dict, linear_weight_keys
from paddle_tpu_torch.core.device import device_guard
from _torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def cpu_device():
    with device_guard("cpu"):
        yield


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, tol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def _models():
    """``name -> (jax_factory, port_factory)`` at small sizes."""
    from paddle_tpu.distributed.fleet.meta_parallel import pp_layers as jpp
    from paddle_tpu.text.models import bert as jbert, ernie as jernie, \
        gpt as jgpt
    from paddle_tpu.vision.models import lenet as jlenet, resnet as jres
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        pp_layers as tpp
    from paddle_tpu_torch.text.models import bert as tbert, \
        ernie as tern, gpt as tgpt
    from paddle_tpu_torch.vision.models import lenet as tlenet, \
        resnet as tres
    cpu = dict(device="cpu")
    return {
        "gpt": (lambda: jgpt.GPTForCausalLM(jgpt.gpt_tiny()),
                lambda: tgpt.GPTForCausalLM(tgpt.gpt_tiny(), **cpu)),
        "bert": (lambda: jbert.BertForPretraining(jbert.bert_tiny()),
                 lambda: tbert.BertForPretraining(tbert.bert_tiny(), **cpu)),
        "ernie": (lambda: jernie.ErnieForPretraining(jernie.ernie_tiny()),
                  lambda: tern.ErnieForPretraining(tern.ernie_tiny(),
                                                   **cpu)),
        "ernie_pipeline": (
            lambda: jpp.PipelineLayer(jernie.ernie_pipeline_descs(
                jernie.ernie_tiny()), num_stages=2),
            lambda: tpp.PipelineLayer(tern.ernie_pipeline_descs(
                tern.ernie_tiny(), **cpu), num_stages=2)),
        "resnet": (lambda: jres.ResNet(jres.BasicBlock, 18, num_classes=10),
                   lambda: tres.ResNet(tres.BasicBlock, 18, num_classes=10,
                                       **cpu)),
        "lenet": (lambda: jlenet.LeNet(10), lambda: tlenet.LeNet(10, **cpu)),
        "transformer": (lambda: jnn.Transformer(32, 2, 1, 1, 64),
                        lambda: tnn.Transformer(32, 2, 1, 1, 64, **cpu)),
    }


MODELS = ["gpt", "bert", "ernie", "ernie_pipeline", "resnet", "lenet",
          "transformer"]
_cache = {}


def _pair(name):
    if name not in _cache:
        jf, tf = _models()[name]
        _cache[name] = (jf(), tf())
    return _cache[name]


@pytest.mark.parametrize("name", MODELS)
def test_state_dict_keys_unchanged(name):
    """The rebase changed no key: torch's own ``Module.state_dict`` gives
    the same keys in the same order, and they are JAX's."""
    jm, tm = _pair(name)
    assert isinstance(tm, tnn.Layer)
    keys = list(tm.state_dict())
    assert keys == list(torch.nn.Module.state_dict(tm))
    assert set(keys) == set(jm.state_dict())


@pytest.mark.parametrize("name", MODELS)
def test_sublayers_and_set_state_dict(name):
    """The same sublayer names in JAX's order, every sublayer of a class
    of the port a ``Layer`` (GPT, BERT and ERNIE also hold torch's own
    ``Embedding``, ``LayerNorm`` and ``ModuleList``), and
    ``set_state_dict``'s ``(missing, unexpected)`` equal to JAX's. JAX's
    GPT also holds its loss as a sublayer, ``loss_fn``, a
    ``ParallelCrossEntropy`` (tensor parallel, ROADMAP Queue 1 item 8),
    which holds no state; the port's calls ``cross_entropy``."""
    jm, tm = _pair(name)
    jnames = [n for n, _ in jm.named_sublayers() if n != "loss_fn"]
    tnames = [n for n, _ in tm.named_sublayers()]
    assert tnames == jnames
    assert len(tm.sublayers(include_self=True)) == len(jnames) + 1
    assert all(isinstance(m, tnn.Layer) for m in tm.sublayers()
               if type(m).__module__.startswith("paddle_tpu_torch"))
    jsd = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    params = [n for n, _ in jm.named_parameters()]
    part = {k: v for k, v in jsd.items() if k not in params[:3]}
    part["not.a.key"] = np.zeros(1, np.float32)
    tpart = from_jax_state_dict(part, module=tm)
    assert tm.set_state_dict(tpart) == jm.set_state_dict(part)
    # the whole dict: nothing missing, the values JAX's
    assert tm.set_state_dict(from_jax_state_dict(jsd, module=tm)) == ([], [])
    linear = linear_weight_keys(tm)
    for k, v in tm.state_dict().items():
        _close(v.T if k in linear else v, jsd[k], 0)


def test_set_state_dict_shape_mismatch_and_to():
    jm, tm = _pair("lenet")
    bad = {"features.0.weight": np.zeros((1, 1, 1, 1), np.float32)}
    with pytest.raises(ValueError, match="Shape mismatch"):
        tm.set_state_dict(bad)
    with pytest.raises(ValueError, match="Shape mismatch"):
        jm.set_state_dict(bad)
    # to() keeps torch's meaning: a device or a dtype
    assert tm.to("cpu") is tm
    assert all(p.device.type == "cpu" for p in tm.parameters())
    tm.to(torch.float64)
    assert all(p.dtype == torch.float64 for p in tm.parameters())
    tm.astype("float32")
    assert all(p.dtype == torch.float32 for p in tm.parameters())


def test_astype_casts_as_jax():
    """``astype`` casts the floating parameters and buffers (BatchNorm's
    running statistics included) and leaves integer buffers; the layer's
    dtype follows."""
    jm = jnn.Sequential(jnn.Linear(3, 4), jnn.BatchNorm1D(4))
    tm = tnn.Sequential(tnn.Linear(3, 4), tnn.BatchNorm1D(4))
    tm[0].register_buffer("steps", torch.zeros(2, dtype=torch.int64))
    for m in (jm, tm):
        m.astype("bfloat16")
    assert {str(v.dtype) for v in jm.state_dict().values()} == {"bfloat16"}
    assert {v.dtype for k, v in tm.state_dict().items()
            if k != "0.steps"} == {torch.bfloat16}
    assert tm[0].steps.dtype == torch.int64
    assert tm[0]._dtype == torch.bfloat16
    out = tm(torch.ones(2, 3, dtype=torch.bfloat16))
    assert out.dtype == torch.bfloat16


def test_layer_methods():
    class J(jnn.Layer):
        def __init__(self):
            super().__init__(name_scope="blk", dtype="float32")
            self.w = self.create_parameter((3, 2))
            self.b = self.create_parameter((2,), is_bias=True)
            self.add_sublayer("fc", jnn.Linear(2, 2))
            self.register_buffer("keep", jnp.ones(2))
            self.register_buffer("scratch", jnp.zeros(2), persistable=False)

        def forward(self, x):
            return self.fc(x @ self.w + self.b)

    class T(tnn.Layer):
        def __init__(self):
            super().__init__(name_scope="blk", dtype="float32")
            self.w = self.create_parameter((3, 2))
            self.b = self.create_parameter((2,), is_bias=True)
            self.add_sublayer("fc", tnn.Linear(2, 2))
            self.register_buffer("keep", torch.ones(2))
            self.register_buffer("scratch", np.zeros(2, np.float32),
                                 persistable=False)

        def forward(self, x):
            return self.fc(x @ self.w + self.b)

    jm, tm = J(), T()
    assert tm.full_name() == jm.full_name() == "blk"
    assert tnn.Linear(2, 2).full_name() == jnn.Linear(2, 2).full_name()
    assert list(tm.state_dict()) == ["w", "b", "keep", "fc.weight",
                                     "fc.bias"]
    assert sorted(tm.state_dict()) == sorted(jm.state_dict())
    assert sorted(tm.state_dict(include_non_persistable_buffer=True)) == \
        sorted(jm.state_dict(include_non_persistable_buffer=True))
    assert sorted(tm.state_dict(True)) == sorted(
        jm.state_dict(include_non_persistable_buffer=True))
    assert [n for n, _ in tm.named_buffers(include_non_persistable=False)] \
        == ["keep"]
    assert isinstance(tm.parameters(), list) and len(tm.parameters()) == 4
    assert len(tm.parameters(include_sublayers=False)) == \
        len(jm.parameters(include_sublayers=False)) == 2
    assert tm.named_param_specs() == jm.named_param_specs() == {
        "w": None, "b": None, "fc.weight": None, "fc.bias": None}
    assert tm.b.dtype == torch.float32 and float(tm.b.abs().sum()) == 0.0
    # add_parameter with a plain array, then removing it
    p = tm.add_parameter("extra", np.ones(3, np.float32))
    assert isinstance(p, tnn.Parameter) and "extra" in tm.state_dict()
    assert tm.add_parameter("extra", None) is None
    assert "extra" not in tm.state_dict()
    _carry = from_jax_state_dict(
        {k: np.asarray(v) for k, v in jm.state_dict().items()}, module=tm)
    assert tm.set_state_dict(_carry) == ([], [])
    x = _x((4, 3), 1)
    _close(tm(torch.from_numpy(x)), jm(jnp.asarray(x)))
    # gradients, then clear_gradients: gone, as JAX clears _grads
    tm(torch.from_numpy(x)).sum().backward()
    assert all(p.grad is not None for p in tm.parameters())
    tm.clear_gradients()
    assert all(p.grad is None for p in tm.parameters())


def test_forward_hooks():
    """Pre-hooks see ``(layer, args)`` and may replace the arguments (a
    non-tuple is the one argument); post-hooks see ``(layer, args, out)``
    and may replace the output; each helper's ``remove()`` takes its hook
    off, as in JAX."""
    jl, tl = jnn.Linear(3, 2), tnn.Linear(3, 2)
    tl.load_state_dict(from_jax_state_dict(
        {k: np.asarray(v) for k, v in jl.state_dict().items()}, module=tl))
    x = _x((2, 3), 2)
    seen = {}
    handles = []
    for side, layer, arr in (("jax", jl, jnp.asarray(x)),
                             ("port", tl, torch.from_numpy(x))):
        pre = layer.register_forward_pre_hook(lambda m, a: a[0] * 2.0)
        post = layer.register_forward_post_hook(
            lambda m, a, out, s=side: seen.setdefault(s, out) + 1.0)
        out = layer(arr)
        handles.append((pre, post))
        ref = seen[side]
        _close(out, (ref.detach().numpy() if side == "port" else
                     np.asarray(ref)) + 1.0)
        pre.remove()
        post.remove()
        seen[side + "_after"] = layer(arr)
    _close(seen["port"], seen["jax"])
    _close(seen["port_after"], seen["jax_after"])
    assert isinstance(handles[1][0], tnn.HookRemoveHelper)
    assert handles[1][0].id != handles[1][1].id
    # a hook returning None leaves the call as it was
    h = tl.register_forward_post_hook(lambda m, a, o: None)
    _close(tl(torch.from_numpy(x)), seen["jax_after"])
    h.remove()


def test_parameter_and_param_ref():
    p = tnn.Parameter(np.ones((2, 3), np.float32))
    assert isinstance(p, torch.nn.Parameter)
    assert not p.stop_gradient and p.trainable
    p.stop_gradient = True
    assert not p.requires_grad and not p.param_attr.trainable
    p.trainable = True
    assert p.requires_grad
    frozen = tnn.Linear(2, 2, weight_attr=tnn.ParamAttr(trainable=False))
    assert frozen.weight.stop_gradient and not frozen.bias.stop_gradient
    layer = tnn.Linear(3, 2)
    ref = tnn.ParamRef(layer, "weight", "weight")
    assert ref.shape == (2, 3) and ref.dtype == torch.float32
    ref.value = np.full((2, 3), 0.5, np.float32)
    assert float(layer.weight.sum()) == pytest.approx(3.0)
    calls = []
    helper = ref.register_hook(lambda g: calls.append(1) or g * 2)
    layer(torch.ones(1, 3)).sum().backward()
    assert calls == [1]
    _close(ref.grad, np.full((2, 3), 2.0, np.float32))
    ref.clear_grad()
    assert ref.grad is None
    assert helper.remove() is True and helper.remove() is False
    ref.trainable = False
    assert ref.stop_gradient and layer.weight.stop_gradient
    import copy
    q = copy.deepcopy(layer)
    assert isinstance(q.weight, tnn.Parameter)
    assert q.weight.paddle_transposed


def test_item7_arguments():
    """``Dropout(name=)``, ``Identity(dtype=, name_scope=)``,
    ``LayerList.sublayers()`` and ``PipelineLayer.stage_of_layer``, as
    JAX's take them."""
    assert tnn.Dropout(0.3, name="drop").p == 0.3
    ident = tnn.Identity(dtype="bfloat16", name_scope="skip")
    assert ident.full_name() == jnn.Identity(
        dtype="bfloat16", name_scope="skip").full_name() == "skip"
    assert ident._dtype == torch.bfloat16
    ll = tnn.LayerList([tnn.Linear(2, 2), tnn.LayerList([tnn.ReLU()])])
    jll = jnn.LayerList([jnn.Linear(2, 2), jnn.LayerList([jnn.ReLU()])])
    assert [n for n, _ in ll.named_sublayers()] == \
        [n for n, _ in jll.named_sublayers()] == ["0", "1", "1.0"]
    assert len(ll.sublayers()) == 3
    assert ll.append(tnn.Tanh()) is ll and len(ll) == 3
    jm, tm = _pair("ernie_pipeline")
    n = len(tm._built)
    assert [tm.stage_of_layer(i) for i in range(n)] == \
        [jm.stage_of_layer(i) for i in range(n)]
    assert set(range(2)) == {tm.stage_of_layer(i) for i in range(n)}
    with pytest.raises(IndexError):
        tm.stage_of_layer(n)


def test_torch_interop():
    """Torch's own machinery through a Layer: strict ``load_state_dict``,
    ``torch.utils.checkpoint`` (recompute), an optimizer over
    ``parameters()``, ``train(mode)``/``eval()``."""
    tm = tnn.Sequential(tnn.Linear(4, 8), tnn.GELU(), tnn.Linear(8, 2))
    other = tnn.Sequential(tnn.Linear(4, 8), tnn.GELU(), tnn.Linear(8, 2))
    other.load_state_dict(tm.state_dict(), strict=True)
    x = torch.from_numpy(_x((3, 4), 3)).requires_grad_()
    out = torch.utils.checkpoint.checkpoint(tm, x, use_reentrant=False)
    out.sum().backward()
    g_ckpt = [p.grad.clone() for p in tm.parameters()]
    tm.clear_gradients()
    tm(x).sum().backward()
    for a, b in zip(g_ckpt, tm.parameters()):
        _close(a, b.grad)
    opt = torch.optim.SGD(tm.parameters(), lr=0.1)
    opt.step()
    assert not torch.equal(tm[0].weight, other[0].weight)
    tm.train(False)
    assert not any(m.training for m in tm.sublayers(include_self=True))
    tm.train()
    assert all(m.training for m in tm.sublayers(include_self=True))
