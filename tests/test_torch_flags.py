"""Port parity: the flag registry (``paddle_tpu/core/flags.py``).

Every flag both packages define reads its ``FLAGS_<name>`` environment
variable when it is defined, coerces it to its default's type (boolean
strings ``1/true/yes/on`` in any case), checks it against ``choices`` and
hands ``set_flags`` values to ``on_change``: the same environment gives the
same values in a subprocess of each package, and an invalid choice raises
the same ``ValueError``.
"""

import json
import os
import subprocess
import sys

import pytest

from paddle_tpu.core import flags as jflags
from paddle_tpu_torch.core import flags as tflags
from _torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the JAX modules that define flags the port defines in core/flags.py
JAX_DEFINERS = ("paddle_tpu.ops._pallas.autotune",
                "paddle_tpu.ops._pallas.flash_attention",
                "paddle_tpu.ops._pallas.conv", "paddle_tpu.nn.fused_conv_bn")

#: flags JAX defines at first use, not on import (``nn/functional.py:505``
#: at the first layer_norm): in this process only if an earlier test ran
#: one, never in the subprocess
JAX_LAZY = ("closed_form_norm_grad",)

DUMP = """
import importlib, json, sys
for m in sys.argv[2:]:
    importlib.import_module(m)
flags = importlib.import_module(sys.argv[1])
print(json.dumps({"values": flags.get_flags(),
                  "unknown": flags.unknown_env_flags()}))
"""


def run_package(flags_module, env_over, modules=()):
    env = {k: v for k, v in os.environ.items() if not k.startswith("FLAGS_")}
    env.update(env_over)
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, "-c", DUMP, flags_module, *modules], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=120)


def common_specs():
    port = {s.name: s for s in tflags.list_flags()}
    for m in JAX_DEFINERS:
        __import__(m)
    jax = {s.name: s for s in jflags.list_flags()}
    return {n: (jax[n], port[n]) for n in sorted(set(jax) & set(port))}


def env_value(spec, case):
    """A setting other than the default, spelled as a user would."""
    if spec.type is bool:
        return ("yes", "On")[case] if spec.default is False \
            else ("0", "no")[case]
    if spec.choices:
        others = [c for c in spec.choices if c != spec.default]
        return str(others[case % len(others)])
    if spec.type is int:
        return ("256", "-1")[case]
    if spec.type is float:
        return ("0.5", "2")[case]
    return ("float16", "cache.json")[case]


@pytest.fixture(scope="module")
def specs():
    got = common_specs()
    # the port defines every flag it reads, JAX's telemetry ones included
    for name in ("serve_prefix_cache", "serve_chunked_prefill",
                 "serve_speculative", "telemetry", "flight_recorder",
                 "flight_recorder_mb", "static_analysis", "fused_conv_bn",
                 "pallas_conv", "flash_head_pack", "amp_dtype",
                 "kernel_autotune", "kernel_autotune_cache_path"):
        assert name in got, name
    return got


@pytest.mark.parametrize("case", [0, 1])
def test_env_values_match_jax(specs, case):
    """One subprocess per package under the same ``FLAGS_*`` environment
    (every common flag set, plus one that names no flag): equal values,
    each not the default, and the same unknown names. The flags whose
    behaviour the port has not reached (``later``) take only their
    default, so they are left unset here (``test_torch_core_surface.py``
    sets them), as are the flags JAX defines at first use."""
    live = {n: js for n, (js, ts) in specs.items()
            if ts.later is None and n not in JAX_LAZY}
    env = {f"FLAGS_{n}": env_value(j, case) for n, j in live.items()}
    env["FLAGS_no_such_flag_for_tests"] = "1"
    jres = run_package("paddle_tpu.core.flags", env, JAX_DEFINERS)
    tres = run_package("paddle_tpu_torch.core.flags", env)
    assert jres.returncode == 0, jres.stderr[-2000:]
    assert tres.returncode == 0, tres.stderr[-2000:]
    jout = json.loads(jres.stdout.strip().splitlines()[-1])
    tout = json.loads(tres.stdout.strip().splitlines()[-1])
    for name, jspec in live.items():
        assert tout["values"][name] == jout["values"][name], name
        assert type(tout["values"][name]) is type(jout["values"][name])
        assert tout["values"][name] != jspec.default, name
    assert tout["unknown"] == jout["unknown"] == [
        "FLAGS_no_such_flag_for_tests"]


def test_env_fault_cases():
    """The two faults the port had: ``FLAGS_serve_chunked_prefill=256`` was
    ignored (0), and a boolean string ``"false"`` read as true."""
    env = {"FLAGS_serve_chunked_prefill": "256",
           "FLAGS_serve_prefix_cache": "false"}
    out = json.loads(run_package("paddle_tpu_torch.core.flags",
                                 env).stdout.strip().splitlines()[-1])
    assert out["values"]["serve_chunked_prefill"] == 256
    assert out["values"]["serve_prefix_cache"] is False


def test_invalid_env_choice_raises_as_jax():
    env = {"FLAGS_telemetry": "bogus"}
    jres = run_package("paddle_tpu.core.flags", env)
    tres = run_package("paddle_tpu_torch.core.flags", env)
    assert jres.returncode != 0 and tres.returncode != 0
    want = ("ValueError: FLAGS_telemetry='bogus' is not a valid value; "
            "choices: ['off', 'metrics', 'trace']")
    assert want in jres.stderr and want in tres.stderr


@pytest.mark.parametrize("value", ["false", "0", "on", "TRUE", "yes", "",
                                   1, 0])
def test_set_flags_bool_coercion_matches_jax(value):
    before = (jflags.flag("serve_prefix_cache"),
              tflags.flag("serve_prefix_cache"))
    try:
        jflags.set_flags({"FLAGS_serve_prefix_cache": value})
        tflags.set_flags({"FLAGS_serve_prefix_cache": value})
        got = tflags.flag("serve_prefix_cache")
        assert got is jflags.flag("serve_prefix_cache")
    finally:
        jflags.set_flags({"serve_prefix_cache": before[0]})
        tflags.set_flags({"serve_prefix_cache": before[1]})


@pytest.mark.parametrize("name,value", [("telemetry", "verbose"),
                                        ("flight_recorder", "yes"),
                                        ("static_analysis", "fatal")])
def test_set_flags_outside_choices_raises_as_jax(name, value):
    before = tflags.flag(name)
    with pytest.raises(ValueError) as jerr:
        jflags.set_flags({name: value})
    with pytest.raises(ValueError) as terr:
        tflags.set_flags({name: value})
    assert str(terr.value) == str(jerr.value)
    assert tflags.flag(name) == before


def test_set_flags_coerces_type_and_unknown_names():
    before = tflags.flag("serve_chunked_prefill")
    try:
        tflags.set_flags({"serve_chunked_prefill": "64"})
        jflags.set_flags({"serve_chunked_prefill": "64"})
        assert tflags.flag("serve_chunked_prefill") == 64 == \
            jflags.flag("serve_chunked_prefill")
    finally:
        tflags.set_flags({"serve_chunked_prefill": before})
        jflags.set_flags({"serve_chunked_prefill": before})
    with pytest.raises(KeyError, match="did you mean 'telemetry'"):
        tflags.set_flags({"telemetri": "off"})


def test_on_change_fires_as_jax():
    name = "torch_parity_on_change_probe"
    seen = {"jax": [], "port": []}
    jflags.define_flag(name, "a", "probe", on_change=seen["jax"].append,
                       choices=("a", "b"))
    tflags.define_flag(name, "a", "probe", on_change=seen["port"].append,
                       choices=("a", "b"))
    try:
        for v in ("b", "a"):
            jflags.set_flags({f"FLAGS_{name}": v})
            tflags.set_flags({f"FLAGS_{name}": v})
        assert seen["port"] == seen["jax"] == ["b", "a"]
        spec = {s.name: s for s in tflags.list_flags()}[name]
        assert spec.choices == ("a", "b") and spec.help == "probe"
    finally:
        for reg in (jflags, tflags):
            reg._registry.pop(name, None)
            reg._values.pop(name, None)


def test_unknown_env_flags_in_process(monkeypatch):
    for k in list(os.environ):
        if k.startswith("FLAGS_"):
            monkeypatch.delenv(k)
    monkeypatch.setenv("FLAGS_telemetry", "metrics")
    monkeypatch.setenv("FLAGS_not_defined_anywhere", "1")
    assert tflags.unknown_env_flags() == jflags.unknown_env_flags() == [
        "FLAGS_not_defined_anywhere"]
