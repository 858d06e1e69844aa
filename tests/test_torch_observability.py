"""Port parity: ``paddle_tpu_torch.observability`` against
``paddle_tpu.observability``.

The same call sequences go through both packages' modules: metric
registries (equal ``snapshot(include_buckets=True)`` and
``prometheus_text()``, hostile label values included), span trees under
``FLAGS_telemetry=trace`` (and nothing under ``metrics``/``off``), flight
recorder rings (each package's ``replay`` reads the other's file),
request-timeline summaries, the recompile sentinel's fingerprints and O001,
the HBM plan check's O002, and the step JSONL rendered by
``tools/trace_view.py``.
"""

import json
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import flags as jflags
from paddle_tpu.observability import flight_recorder as jfr
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.observability import request_timeline as jrt
from paddle_tpu.observability import step_monitor as jsm
from paddle_tpu.observability import trace as jtrace
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.observability import flight_recorder as tfr
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.observability import request_timeline as trt
from paddle_tpu_torch.observability import step_monitor as tsm
from paddle_tpu_torch.observability import trace as ttrace
from paddle_tpu_torch.profiler import monitor as tmonitor
from _torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HOSTILE = ['a"b', "back\\slash", "new\nline", 'end\\', "plain", "ü-ñ",
           "{x=1}", ""]


def both_modes(mode):
    jflags.set_flags({"telemetry": mode})
    tflags.set_flags({"telemetry": mode})


@pytest.fixture
def telemetry_mode():
    before = (jflags.flag("telemetry"), tflags.flag("telemetry"))
    yield both_modes
    jflags.set_flags({"telemetry": before[0]})
    tflags.set_flags({"telemetry": before[1]})


# -- metrics ------------------------------------------------------------------

def feed(mod, seed):
    """One seeded call sequence on a fresh registry of ``mod``."""
    reg = mod.Registry()
    rng = np.random.default_rng(seed)
    c = reg.counter("serving.requests", "requests submitted")
    g = reg.gauge("hbm.bytes_in_use", "live device bytes")
    h = reg.histogram("telemetry.step_ms", "wall time per step (ms)")
    hl = reg.histogram("telemetry.phase_ms", "per phase")
    for i in range(200):
        op = int(rng.integers(0, 5))
        lab = HOSTILE[int(rng.integers(0, len(HOSTILE)))]
        v = float(rng.lognormal(0.0, 3.0))
        if op == 0:
            c.inc(int(rng.integers(1, 4)))
        elif op == 1:
            c.labels(fn=lab).inc()
        elif op == 2:
            g.labels(dev=lab).set(int(rng.integers(0, 2 ** 40)))
        elif op == 3:
            h.observe(v)
        else:
            hl.labels(phase=lab, kind="x").observe(v)
    reg.stat("dataloader.batches").add(7)
    reg.stat("model.train_batches").set(3)
    hl.remove(phase="plain", kind="x")
    reg.expire(lambda name, labels: labels.get("dev") == "")
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_registry_expositions_equal(seed):
    jreg, treg = feed(jmetrics, seed), feed(tmetrics, seed)
    assert treg.snapshot(include_buckets=True) == \
        jreg.snapshot(include_buckets=True)
    assert treg.snapshot() == jreg.snapshot()
    assert treg.prometheus_text() == jreg.prometheus_text()
    assert treg.stats_snapshot() == jreg.stats_snapshot()
    assert '\\"' in treg.prometheus_text()


def test_metrics_kind_clash_and_flat_stats():
    for mod in (jmetrics, tmetrics):
        reg = mod.Registry()
        reg.counter("x")
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("x")
    before = tmonitor.stat_get("torch_parity.probe")
    tmonitor.stat_add("torch_parity.probe", 2)
    assert tmetrics.stat_get("torch_parity.probe") == before + 2
    assert tmonitor.stats_snapshot()["torch_parity.probe"] == before + 2


# -- spans --------------------------------------------------------------------

def span_tree(mod, name):
    mod.clear()
    with mod.span(f"{name}/outer", step=1):
        with mod.span(f"{name}/mid"):
            with mod.span(f"{name}/leaf", k="v"):
                pass
        with mod.span(f"{name}/mid2"):
            pass
    got = [(s["name"].split("/", 1)[1], s["depth"], s.get("attrs"))
           for s in mod.spans()]
    mod.clear()
    return got


def test_span_trees_equal_under_trace(telemetry_mode):
    telemetry_mode("trace")
    want = [("leaf", 2, {"k": "v"}), ("mid", 1, None), ("mid2", 1, None),
            ("outer", 0, {"step": 1})]
    assert span_tree(ttrace, "t") == span_tree(jtrace, "j") == want


@pytest.mark.parametrize("mode", ["metrics", "off"])
def test_no_spans_outside_trace(telemetry_mode, mode):
    telemetry_mode(mode)
    assert span_tree(ttrace, "t") == span_tree(jtrace, "j") == []
    assert ttrace.telemetry_mode() == jtrace.telemetry_mode() == mode


def test_open_spans_and_exports(telemetry_mode, tmp_path):
    telemetry_mode("trace")
    for mod in (jtrace, ttrace):
        mod.clear()
        with mod.span("done"):
            pass
        with mod.span("hung", why="test"):
            assert [s["name"] for s in mod.open_spans()] == ["hung"]
            n = mod.export_chrome_trace(str(tmp_path / "t.json"))
            m = mod.export_jsonl(str(tmp_path / "t.jsonl"))
        assert n == m == 2
        ev = json.load(open(tmp_path / "t.json"))["traceEvents"]
        assert ev[1]["args"] == {"why": "test", "incomplete": True}
        mod.clear()


def test_span_is_a_profiler_range(telemetry_mode):
    """Under ``trace`` a span opens ``torch.profiler.record_function``, so
    it shows in a ``torch.profiler`` capture."""
    telemetry_mode("trace")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with ttrace.span("parity/range"):
            torch.ones(4).sum()
    assert "parity/range" in {e.key for e in prof.key_averages()}
    ttrace.clear()


# -- flight recorder ----------------------------------------------------------

def write_ring(mod, run_dir, capacity):
    rec = mod.FlightRecorder(
        mod.recorder_path(str(run_dir), "trainer", 3, 0),
        {"run_id": "parity", "pid": 1, "start_ts": 0.0},
        capacity_bytes=capacity)
    for i in range(400):
        rec.record("step", step=i, index=i + 10, phases={"h2d": 0.25 * i},
                   note="x" * (i % 37))
    rec.record("diag", rule="O001", message='quote " and \\ back')
    rec.close()
    return rec.path


@pytest.mark.parametrize("capacity", [1 << 20, 8192 + 4096])
def test_flight_recorder_rings_cross_replay(tmp_path, capacity):
    """A ring one package wrote replays in the other to the same meta,
    records and report (a ring small enough to wrap included)."""
    tpath = write_ring(tfr, tmp_path / "port", capacity)
    jpath = write_ring(jfr, tmp_path / "jax", capacity)
    for path in (tpath, jpath):
        jmeta, jrecs, jrep = jfr.replay(path)
        tmeta, trecs, trep = tfr.replay(path)
        assert (tmeta, trecs, trep) == (jmeta, jrecs, jrep)
        assert trep["frames_torn"] == 0 and trep["contiguous"]
        assert trep["wrapped"] == (capacity < 1 << 20)
    # the two files differ only in their timestamps
    strip = lambda recs: [{k: v for k, v in r.items() if k != "ts"}  # noqa
                          for r in recs]
    assert strip(tfr.replay(tpath)[1]) == strip(jfr.replay(jpath)[1])
    assert tfr.recorder_files(str(tmp_path)) == sorted([tpath, jpath])
    assert tfr.next_incarnation(str(tmp_path / "port"), "trainer", 3) == \
        jfr.next_incarnation(str(tmp_path / "port"), "trainer", 3) == 1


def test_flight_recorder_arm_emit_gate(tmp_path):
    before = tflags.flag("flight_recorder")
    try:
        tflags.set_flags({"flight_recorder": "off"})
        assert tfr.arm_if_enabled(str(tmp_path), "serve") is None
        tflags.set_flags({"flight_recorder": "on"})
        rec = tfr.arm(str(tmp_path), "serve", capacity_bytes=1 << 16)
        assert tfr.emit("request", rid="r0", outcome="ok") == 0
        tflags.set_flags({"flight_recorder": "off"})
        assert tfr.emit("request", rid="r1") is None
        tfr.disarm()
        meta, recs, _ = jfr.replay(rec.path)
        assert meta["role"] == "serve" and meta["incarnation"] == 0
        assert [r["rid"] for r in recs] == ["r0"]
    finally:
        tfr.disarm()
        tflags.set_flags({"flight_recorder": before})


# -- request timeline ---------------------------------------------------------

def timeline_records(rng):
    out = []
    for i in range(40):
        outcome = ["ok", "ok", "ok", "rejected", "expired", "shed",
                   "failed"][int(rng.integers(0, 7))]
        phases = {p: float(rng.uniform(0, 30)) for p in
                  ("queue", "prefill", "decode", "detokenize")
                  if outcome != "rejected"}
        out.append(dict(
            rid=f"r{i}", prompt_tokens=int(rng.integers(3, 90)),
            new_tokens=int(rng.integers(0, 9)), phases_ms=phases,
            total_ms=float(rng.uniform(1, 200)),
            ttft_ms=(float(rng.uniform(0, 50)) if outcome == "ok"
                     else None),
            preemptions=int(rng.integers(0, 2)), outcome=outcome,
            deadline_ms=(float(rng.uniform(50, 150)) if i % 3 else None),
            error=None if outcome == "ok" else f"{outcome} reason"))
    return out


def test_request_timeline_summary_equal():
    recs = timeline_records(np.random.default_rng(0))
    jt, tt = jrt.RequestTimeline(), trt.RequestTimeline()
    for r in recs:
        assert tt.record(**r) == jt.record(**r)
    assert tt.summary() == jt.summary()
    assert tt.records() == jt.records()
    vals = [r["total_ms"] for r in recs]
    for q in (0, 50, 90, 99, 100):
        assert trt.percentile(vals, q) == jrt.percentile(vals, q)
    assert trt.percentile([], 50) is None
    assert trt.current() is trt.current()
    assert trt.reset_default() is trt.current()


# -- recompile sentinel -------------------------------------------------------

PLACE = re.compile(r"@[^ ;]*")


def signatures(n):
    """``n`` distinct signatures of one tree, as (JAX, port) pairs."""
    out = []
    for i in range(n):
        s = 4 * (i + 1)
        base = np.arange(s, dtype=np.int32).reshape(1, s)
        lr = np.float32(0.5)
        out.append((({"ids": jnp.asarray(base), "mask": [
            jnp.ones((2, s), jnp.bfloat16), None]}, lr),
            ({"ids": torch.from_numpy(base), "mask": [
                torch.ones(2, s, dtype=torch.bfloat16), None]}, lr)))
    return out


def test_fingerprints_and_diff_match_jax():
    sigs = signatures(2)
    jfp = [jsm.fingerprint(j, donate=(1, 2)) for j, _ in sigs]
    tfp = [tsm.fingerprint(t, donate=(1, 2)) for _, t in sigs]
    for j, t in zip(jfp, tfp):
        assert [e[:3] for e in t[1:]] == [e[:3] for e in j[1:]]
        assert t[0] == j[0] == (1, 2)
    assert [e[0] for e in tfp[0][1:]] == ["[0]['ids']", "[0]['mask'][0]",
                                         "[1]"]
    assert tfp[0][1][3] == "cpu"
    jd = jsm.fingerprint_diff(jfp[0], jfp[1])
    td = tsm.fingerprint_diff(tfp[0], tfp[1])
    assert PLACE.sub("", td) == PLACE.sub("", jd)
    assert "bfloat16[2,4]" in td and "torch." not in td
    assert tsm.fingerprint_fast(sigs[0][1]) != tsm.fingerprint_fast(
        sigs[1][1])


def test_o001_fires_once_on_third_signature():
    sigs = signatures(4)
    js, ts = jsm.RecompileSentinel(), tsm.RecompileSentinel()
    fired = []
    for (j, t) in sigs + sigs[:1]:
        js.observe_tree("k", j, where="serving.decode")
        ts.observe_tree("k", t, where="serving.decode")
        fired.append((len(js.diagnostics), len(ts.diagnostics)))
    assert fired == [(0, 0), (0, 0), (1, 1), (1, 1), (1, 1)]
    jd, td = js.diagnostics[0], ts.diagnostics[0]
    assert (td.rule, td.name, td.severity, td.where) == \
        (jd.rule, jd.name, jd.severity, jd.where) == \
        ("O001", "recompile-churn", "warning", "serving.decode")
    assert PLACE.sub("", td.message) == PLACE.sub("", jd.message)
    assert "XLA" not in td.hint and "kernel build" in td.hint
    # a seen signature is not new; the timeline names the phase
    tl = tsm.StepTimeline()
    assert tl.observe_dispatch("f", sigs[0][1]) == "compile"
    assert tl.observe_dispatch("f", sigs[0][1]) == "device"


def test_o002_plan_check_matches_jax():
    jt, tt = jsm.StepTimeline(), tsm.StepTimeline(device="cpu")
    for tl in (jt, tt):
        tl.hbm_peak_bytes = int(3.5 * 2 ** 30)
        assert tl.check_plan({"device_gb": 3.4}) is None   # within 5%
    jd, td = jt.check_plan({"device_gb": 3.0}), tt.check_plan(
        {"device_gb": 3.0})
    assert td.to_json() == jd.to_json()
    assert td.rule == "O002" and tt.all_diagnostics() == [td]


def test_sample_hbm_is_none_on_cpu():
    assert tsm.StepTimeline(device="cpu").sample_hbm() is None
    if not torch.cuda.is_available():
        assert tsm.StepTimeline().sample_hbm() is None
    tl = tsm.StepTimeline(device="cpu")
    with tl.step():
        pass
    assert "hbm_peak_gb" not in tl.steps()[0]


# -- step timeline through tools/trace_view.py --------------------------------

def drive(mod, tl):
    for i in range(6):
        with tl.step():
            with tl.phase("data"):
                pass
            tl.note("index", i + 1)
            with tl.phase("h2d"):
                pass
            with tl.phase("compile" if i == 0 else "device"):
                pass
            with tl.phase("callbacks"):
                pass
    with tl.phase("ckpt_save"):
        pass


def test_step_jsonl_renders_through_trace_view(tmp_path, telemetry_mode):
    telemetry_mode("metrics")
    out = {}
    for name, mod, tl in (("jax", jsm, jsm.StepTimeline()),
                          ("port", tsm, tsm.StepTimeline(device="cpu"))):
        drive(mod, tl)
        steps = tl.steps()
        assert [s["index"] for s in steps] == list(range(1, 7))
        path = tmp_path / f"{name}.jsonl"
        assert tl.export_jsonl(str(path)) == 6
        res = subprocess.run(
            [sys.executable, os.path.join(ROOT, "tools", "trace_view.py"),
             str(path), "--json"], capture_output=True, text=True,
            timeout=60)
        assert res.returncode == 0, res.stderr
        summ = json.loads(res.stdout)
        out[name] = (summ["steps"], summ["spans"], summ["hbm_peak_gb"],
                     sorted((r["phase"], r["calls"])
                            for r in summ["phases"]),
                     sorted(tl.summary()["phases"]),
                     tl.summary()["steps"])
        text = subprocess.run(
            [sys.executable, os.path.join(ROOT, "tools", "trace_view.py"),
             str(path)], capture_output=True, text=True, timeout=60)
        assert "Telemetry timeline" in text.stdout
    assert out["port"] == out["jax"]
    assert out["port"][3] == [("callbacks", 6), ("compile", 1),
                              ("data", 6), ("device", 5), ("h2d", 6)]


def test_timeline_off_records_nothing(telemetry_mode):
    telemetry_mode("off")
    tl = tsm.StepTimeline(device="cpu")
    with tl.step():
        with tl.phase("h2d"):
            pass
    assert tl.steps() == [] and not tl.enabled


def test_instrument_jitted_feeds_sentinel(telemetry_mode):
    telemetry_mode("metrics")
    tl = tsm.StepTimeline(device="cpu")
    fn = tsm.instrument_jitted(lambda x: x * 2, name="double", timeline=tl)
    with tl.step():
        fn(torch.ones(3))
    with tl.step():
        fn(torch.ones(3))
    with tl.step():
        fn(torch.ones(4))
    assert [sorted(s["phases"]) for s in tl.steps()] == [
        ["compile"], ["device"], ["compile"]]
    assert fn.__name__ == "double" and not hasattr(fn, "lower")
