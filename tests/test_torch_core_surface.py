"""Port parity: the single-device surface's core (``paddle_tpu/core``:
flags, device, dtype, the package's re-exports) and the root names.

- Every flag the JAX package defines is a flag of the port with JAX's
  default, type and choices; the flags whose behaviour the port has not
  reached take only their default (``NotImplementedError`` otherwise, from
  ``set_flags`` and from the environment).
- ``FLAGS_use_pallas_kernels=0`` (in a subprocess per package) and
  ``set_flags({"use_pallas_kernels": 0})`` send ``ops.flash_attention``,
  ``flash_attn_unpadded`` and ``scaled_dot_product_attention`` to the dense
  path at a kernel head dim, counted in each route's ``dense_routes``, with
  JAX's outputs (JAX's CPU path is its dense path), float32 within 1e-5 +
  1e-5·|ref|.
- The device functions answer as JAX's on the CPU; the port's
  ``resolve_device`` honours ``set_device`` per thread.
- The dtype names, aliases and predicates, ``finfo``/``iinfo`` and
  ``FLAGS_default_dtype`` as JAX's.
- ``import paddle_tpu_torch as paddle`` has every name JAX's root exports
  from ``core``, ``core.dtype``, ``tensor`` and ``autograd``, and
  ``amp``'s two predicates.
"""

import importlib
import json
import os
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu.core import device as jdev
from paddle_tpu.core import dtype as jdt
from paddle_tpu.core import flags as jflags
from paddle_tpu_torch.core import device as tdev
from paddle_tpu_torch.core import dtype as tdt
from paddle_tpu_torch.core import flags as tflags
from _torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

jfa = importlib.import_module("paddle_tpu.ops.flash_attention")
jF = importlib.import_module("paddle_tpu.nn.functional")
tfa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
tF = importlib.import_module("paddle_tpu_torch.nn.functional")

#: the JAX modules that define flags outside core/flags.py
JAX_DEFINERS = ("paddle_tpu.ops._pallas.autotune",
                "paddle_tpu.ops._pallas.flash_attention",
                "paddle_tpu.ops._pallas.conv", "paddle_tpu.nn.fused_conv_bn",
                "paddle_tpu.framework.determinism",
                "paddle_tpu.incubate.autotune")


#: the flags this slice registered, with JAX's help
NEW_FLAGS = ("default_dtype", "jit_cache_size", "log_level",
             "allocator_strategy", "embedding_deterministic",
             "flash_attn_version", "use_pallas_kernels", "flash_block_q",
             "flash_block_k", "closed_form_norm_grad", "check_nan_inf",
             "check_nan_inf_level", "use_deterministic_reductions",
             "lockcheck", "offload_optimizer", "fleet_telemetry",
             "fleet_export_interval", "comm_overlap", "comm_overlap_chunks",
             "comm_overlap_bucket_mb", "multislice",
             "multislice_dcn_bucket_mb", "health_sentinel", "cp_nested_ring",
             "deterministic", "autotune_kernel", "autotune_layout",
             "autotune_dataloader")


def _jax_specs():
    for m in JAX_DEFINERS:
        importlib.import_module(m)
    jF._closed_form_norm_grad()     # defines its flag at first use
    return {s.name: s for s in jflags.list_flags()}


def test_every_jax_flag_is_a_port_flag_with_its_default():
    port = {s.name: s for s in tflags.list_flags()}
    jax = _jax_specs()
    missing = sorted(set(jax) - set(port))
    assert not missing, missing
    for name, js in jax.items():
        ts = port[name]
        assert ts.default == js.default and ts.type is js.type, name
        assert ts.choices == js.choices, name
        if name in NEW_FLAGS:       # JAX's help (the block flags add a note)
            assert ts.help.startswith(js.help), name
    # the port defines nothing JAX does not, but probes other tests add
    extra = sorted(n for n in set(port) - set(jax)
                   if not n.startswith("torch_parity"))
    assert extra == [], extra


def _later():
    return [s for s in tflags.list_flags() if s.later is not None]


def test_deferred_flags_take_only_their_default():
    later = _later()
    names = {s.name for s in later}
    for n in ("check_nan_inf", "offload_optimizer", "comm_overlap",
              "health_sentinel", "deterministic", "lockcheck",
              "fleet_telemetry", "multislice", "cp_nested_ring"):
        assert n in names, n
    for s in later:
        assert "ROADMAP Queue 1 item" in s.later
        tflags.set_flags({s.name: s.default})       # the default is taken
        other = ("on" if s.default == "off" else "off") if s.choices \
            else (not s.default if s.type is bool else s.type(7))
        if s.choices and other not in s.choices:
            other = next(c for c in s.choices if c != s.default)
        with pytest.raises(NotImplementedError, match="item"):
            tflags.set_flags({f"FLAGS_{s.name}": other})
        assert tflags.flag(s.name) == s.default


DUMP_FLAG = """
import json, sys
flags = __import__(sys.argv[1], fromlist=["x"])
print(json.dumps({n: flags.flag(n) for n in sys.argv[2:]}))
"""


def _run(code, env_over, *args):
    env = {k: v for k, v in os.environ.items() if not k.startswith("FLAGS_")}
    env.update(env_over)
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, "-c", code, *args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_deferred_flag_env_raises():
    res = _run(DUMP_FLAG, {"FLAGS_check_nan_inf": "1"},
               "paddle_tpu_torch.core.flags", "check_nan_inf")
    assert res.returncode != 0
    assert "NotImplementedError: FLAGS_check_nan_inf=True" in res.stderr
    assert "ROADMAP Queue 1 item 9" in res.stderr
    res = _run(DUMP_FLAG, {"FLAGS_check_nan_inf": "0",
                           "FLAGS_default_dtype": "float16",
                           "FLAGS_log_level": "3"},
               "paddle_tpu_torch.core.flags", "check_nan_inf",
               "default_dtype", "log_level")
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.splitlines()[-1]) == {
        "check_nan_inf": False, "default_dtype": "float16", "log_level": 3}


ROUTE_PROBE = """
import json, sys
import numpy as np
pkg = sys.argv[1]
flags = __import__(pkg + ".core.flags", fromlist=["x"])
out = {"flag": flags.flag("use_pallas_kernels")}
import importlib
fa = importlib.import_module(pkg + ".ops.flash_attention")
if pkg == "paddle_tpu":
    import jax.numpy as jnp
    q = jnp.zeros((1, 128, 2, 128), jnp.float32)
    out["use_pallas"] = fa._use_pallas(q, q)
else:
    import torch
    F = importlib.import_module("paddle_tpu_torch.nn.functional")
    q = torch.zeros(1, 128, 2, 128)
    out["route"] = fa.attention_route(q)
    fa.flash_attention(q, q, q)
    F.scaled_dot_product_attention(q, q, q)
    cu = torch.tensor([0, 128])
    fa.flash_attn_unpadded(q[0], q[0], q[0], cu, cu, 128, 128)
    out["dense"] = [fa.flash_attention.dense_routes,
                    F.scaled_dot_product_attention.dense_routes,
                    fa.flash_attn_unpadded.dense_routes]
print(json.dumps(out))
"""


@pytest.mark.parametrize("value", ["false", "1"])
def test_use_pallas_kernels_env_in_each_package(value):
    outs = {}
    for pkg in ("paddle_tpu", "paddle_tpu_torch"):
        res = _run(ROUTE_PROBE, {"FLAGS_use_pallas_kernels": value}, pkg)
        assert res.returncode == 0, res.stderr[-2000:]
        outs[pkg] = json.loads(res.stdout.splitlines()[-1])
    on = value == "1"
    assert outs["paddle_tpu"]["flag"] is outs["paddle_tpu_torch"]["flag"] \
        is on
    assert outs["paddle_tpu"]["use_pallas"] is False   # off a TPU anyway
    port = outs["paddle_tpu_torch"]
    assert port["route"] == ("kernels" if on else "dense")
    assert port["dense"] == ([0, 0, 0] if on else [1, 1, 1])


def _qkv(d, sq=256, h=2, hk=2, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, sq, n, d)).astype(np.float32)
            for n in (h, hk, hk)]


def _close(got, want, tol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_less(np.abs(got - want),
                                 tol + tol * np.abs(want) + 1e-30)


@pytest.fixture
def pallas_off():
    tflags.set_flags({"use_pallas_kernels": 0})
    jflags.set_flags({"use_pallas_kernels": 0})
    for fn in (tfa.flash_attention, tfa.flash_attn_unpadded,
               tF.scaled_dot_product_attention):
        fn.dense_routes = 0
    yield
    tflags.set_flags({"use_pallas_kernels": 1})
    jflags.set_flags({"use_pallas_kernels": 1})


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_set_flags_off_sends_attention_dense_as_jax(pallas_off, d, causal):
    q, k, v = _qkv(d, hk=1 if d == 128 else 2, seed=d)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    assert tfa.attention_route(tq) == "dense"
    _close(tfa.flash_attention(tq, tk, tv, causal=causal),
           jfa.flash_attention(q, k, v, causal=causal))
    # dropout: the dense mirror of the kernels' mask, one seed
    _close(tfa.flash_attention(tq, tk, tv, 0.1, causal, fixed_seed_offset=5),
           jfa.flash_attention(q, k, v, 0.1, causal, fixed_seed_offset=5))
    # one query: the decode step's single_query_attention
    _close(tfa.flash_attention(tq[:, :1], tk, tv),
           jfa.flash_attention(q[:, :1], k, v))
    cu = np.array([0, 100, 256, 512], np.int32)
    pq, pk, pv = (a.reshape(-1, a.shape[2], d) for a in (q, k, v))
    if d == 64:
        _close(tfa.flash_attn_unpadded(*map(torch.from_numpy, (pq, pk, pv)),
                                       torch.from_numpy(cu),
                                       torch.from_numpy(cu), 256, 256),
               jfa.flash_attn_unpadded(pq, pk, pv, jnp.asarray(cu),
                                       jnp.asarray(cu), 256, 256))
        _close(tF.scaled_dot_product_attention(tq, tk, tv,
                                               is_causal=causal),
               jF.scaled_dot_product_attention(q, k, v, is_causal=causal))
        mask = np.arange(256)[None, :] < np.array([[200], [256]])
        _close(tF.scaled_dot_product_attention(
            tq, tk, tv, attn_mask=torch.from_numpy(mask)[:, None, None]),
            jF.scaled_dot_product_attention(q, k, v,
                                            attn_mask=mask[:, None, None]))
        assert tfa.flash_attn_unpadded.dense_routes == 1
        assert tF.scaled_dot_product_attention.dense_routes == 2
    assert tfa.flash_attention.dense_routes == 3
    # on again: the kernel route (their plain versions here), no dense
    tflags.set_flags({"use_pallas_kernels": 1})
    tfa.flash_attention.dense_routes = 0
    tfa.flash_attention(tq, tk, tv, causal=causal)
    assert tfa.flash_attention.dense_routes == 0


# -- device ---------------------------------------------------------------------

@pytest.fixture
def no_device():
    """Neither package's thread device set before or after."""
    tdev._state.__dict__.pop("device", None)
    yield
    tdev._state.__dict__.pop("device", None)
    for attr in ("device", "name"):
        jdev._state.__dict__.pop(attr, None)


def test_device_functions_answer_as_jax(no_device):
    # JAX lists every host device XLA was told to make; the port has one
    assert tdev.get_all_devices() == jdev.get_all_devices()[:1] == ["cpu:0"]
    for kind in ("gpu", "tpu", "xpu", "npu"):
        assert tdev.device_count(kind) == jdev.device_count(kind) == 0
    assert tdev.device_count("cpu") == 1
    assert tdev.is_compiled_with_tpu() is jdev.is_compiled_with_tpu() \
        is False
    assert tdev.get_device() == jdev.get_device() == "cpu:0"
    def head(e):        # the message less the host devices it lists
        return str(e.value).split(";")[0].split(" (")[0]

    for bad in ("gpu", "tpu:1", "cpu:9", "npu"):
        with pytest.raises(ValueError) as jerr:
            jdev.set_device(bad)
        with pytest.raises(ValueError) as terr:
            tdev.set_device(bad)
        assert head(terr) == head(jerr)
    assert tdev.set_device("cpu") == torch.device("cpu")
    jdev.set_device("cpu")
    assert tdev.get_device() == jdev.get_device() == "cpu:0"
    tdev.synchronize()
    jdev.synchronize()


def test_resolve_device_honours_set_device_per_thread(no_device):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdev.resolve_device(None)
    for name in ("gpu", "gpu:0", "tpu", "cuda"):
        with pytest.raises(RuntimeError):
            tdev.resolve_device(name)
    tdev.set_device("cpu")
    assert tdev.resolve_device(None) == torch.device("cpu")
    assert tdev.get_default_device() == torch.device("cpu")
    seen = []

    def other():
        try:
            tdev.resolve_device(None)
            seen.append("resolved")
        except RuntimeError:
            seen.append("raised")

    t = threading.Thread(target=other)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and seen == ["raised"]
    # an entry point that takes the thread's device
    assert paddle_tpu_torch.zeros([2]).device.type == "cpu"
    assert paddle_tpu_torch.to_tensor([1.0], place="cpu").device.type == \
        "cpu"


# -- dtype ------------------------------------------------------------------------

def test_dtype_names_aliases_and_predicates():
    for name in jdt._NAME_TO_DTYPE:
        want = jnp.dtype(jdt.to_dtype(name)).name
        assert tdt.dtype_name(name) == want, name
        assert tdt.is_floating_point(name) == jdt.is_floating_point(name)
        assert tdt.is_integer(name) == jdt.is_integer(name)
    for attr in ("bool_", "uint8", "int8", "int16", "int32", "int64",
                 "float16", "bfloat16", "float32", "float64", "complex64",
                 "complex128", "float8_e4m3", "float8_e5m2"):
        assert tdt.dtype_name(getattr(tdt, attr)) == \
            jnp.dtype(getattr(jdt, attr)).name, attr
    for spec in (np.float32, np.dtype("int16"), float, int, bool):
        assert tdt.dtype_name(spec) == jdt.dtype_name(spec), spec
    assert tdt.to_dtype(None) is jdt.to_dtype(None) is None
    with pytest.raises(ValueError, match="Unknown dtype name"):
        tdt.to_dtype("float128")
    with pytest.raises(ValueError, match="Unknown dtype name"):
        jdt.to_dtype("float128")


@pytest.mark.parametrize("name", ["float16", "bfloat16", "float32",
                                  "float64"])
def test_finfo_as_jax(name):
    t, j = tdt.finfo(name), jdt.finfo(name)
    assert t.bits == j.bits
    for field in ("eps", "max", "min", "tiny"):
        assert float(getattr(t, field)) == float(getattr(j, field)), field


@pytest.mark.parametrize("name", ["uint8", "int8", "int16", "int32",
                                  "int64"])
def test_iinfo_as_jax(name):
    t, j = tdt.iinfo(name), jdt.iinfo(name)
    assert (t.bits, int(t.min), int(t.max)) == (j.bits, int(j.min),
                                                int(j.max))


def test_default_dtype_round_trip():
    try:
        for spec in ("bfloat16", "fp16", np.float64):
            tdt.set_default_dtype(spec)
            jdt.set_default_dtype(spec)
            assert tflags.flag("default_dtype") == \
                jflags.flag("default_dtype")
            assert tdt.dtype_name(tdt.get_default_dtype()) == \
                jnp.dtype(jdt.get_default_dtype()).name
    finally:
        tdt.set_default_dtype("float32")
        jdt.set_default_dtype("float32")


# -- the re-exports and the root -------------------------------------------------

CORE_NAMES = ("device", "dtype", "flags", "random", "get_flags",
              "set_flags", "define_flag", "flag", "set_device",
              "get_device", "device_count", "is_compiled_with_tpu",
              "synchronize", "seed", "get_rng_state", "set_rng_state",
              "rng_scope")


def test_core_reexports_as_jax():
    for name in CORE_NAMES:
        assert hasattr(paddle_tpu.core, name), name
        assert hasattr(paddle_tpu_torch.core, name), name


def _jax_root_names():
    """What JAX's root exports from core, core.dtype, tensor and
    autograd (``paddle_tpu/__init__.py:16-29``, ``:84-85``)."""
    names = set()
    for m in ("creation", "math", "manipulation", "linalg", "logic",
              "random", "stat", "search", "extras"):
        names |= set(importlib.import_module(
            f"paddle_tpu.tensor.{m}").__all__)
    names |= {"core", "seed", "set_device", "get_device", "device_count",
              "get_flags", "set_flags", "is_compiled_with_tpu",
              "synchronize", "get_rng_state", "set_rng_state", "bool_",
              "uint8", "int8", "int16", "int32", "int64", "float16",
              "bfloat16", "float32", "float64", "complex64", "complex128",
              "get_default_dtype", "set_default_dtype", "is_tensor",
              "autograd", "no_grad", "grad", "enable_grad",
              "set_grad_enabled", "is_grad_enabled", "bool"}
    return names


def test_root_has_every_jax_root_name_of_the_ported_modules():
    names = _jax_root_names()
    assert len(names) > 320
    for name in sorted(names):
        assert hasattr(paddle_tpu, name), name
    missing = sorted(n for n in names if not hasattr(paddle_tpu_torch, n))
    assert missing == []
    # the dtypes are torch's, the functions the port's
    assert paddle_tpu_torch.float32 is torch.float32
    assert paddle_tpu_torch.bool is torch.bool
    assert paddle_tpu_torch.matmul.__module__ == \
        "paddle_tpu_torch.tensor.linalg"
    assert paddle_tpu_torch.no_grad is torch.no_grad


def test_amp_predicates_as_jax():
    jamp = importlib.import_module("paddle_tpu.amp")
    tamp = importlib.import_module("paddle_tpu_torch.amp")
    assert tamp.is_float16_supported() is jamp.is_float16_supported() \
        is False
    assert tamp.is_bfloat16_supported() is jamp.is_bfloat16_supported() \
        is True
    assert tamp.is_float16_supported("cpu") is False


def test_the_root_imports_no_jax():
    res = _run("import sys, paddle_tpu_torch as paddle; "
               "print(sorted(m for m in sys.modules if m == 'jax' or "
               "m.startswith(('jax.', 'paddle_tpu.'))))", {})
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "[]"
