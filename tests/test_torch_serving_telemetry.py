"""Port parity: the serving engine's telemetry.

JAX's engine and the port's serve the same traces on the
``tests/test_serving.py`` micro model with JAX's weights carried into the
port, each after its package's metric registry and request timeline are
reset: a ragged trace that preempts and spills, bench.py's overload trace
(its endings rejected, expired, shed and failed), and the three throughput
tiers composed with a ``ModelDrafter`` (the extend, verify and draft
sentinels). The two must agree on every ``serving.*`` counter and
non-time gauge, each histogram's count, each timeline record's non-time
fields and every field of ``compile_report()``, with O001 silent.
"""

import numpy as np
import pytest

from paddle_tpu.fault import injection as jinj
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.observability import request_timeline as jrt
from paddle_tpu.serving import ModelDrafter as JModelDrafter
from paddle_tpu.serving import Rejected as JRejected
from paddle_tpu.serving import Request as JRequest
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu.serving import ShedPolicy as JShedPolicy
from paddle_tpu.serving import SpillError as JSpillError
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.fault import injection as tinj
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.observability import request_timeline as trt
from paddle_tpu_torch.serving import (ModelDrafter, Rejected, Request,
                                      ServingEngine, ShedPolicy, SpillError)
from test_torch_serving_resilience import carried, overload_trace, ragged
from _torch_threads import one_torch_thread  # noqa: F401

#: gauges whose value is a time (the shed policy's decode p99)
TIME_GAUGES = {"serving.decode_p99_ms"}

DRAFTER = dict(vocab_size=128, hidden_size=32, num_layers=1, num_heads=2,
               max_position_embeddings=32)


def series(snap):
    """``{(family, type, labels): value}`` over the ``serving.*``
    families: counters and gauges by value (time gauges left out),
    histograms by count; zero series left out (a family another test in
    the process made holds zeros after the reset)."""
    out = {}
    for name, fam in snap.items():
        if not name.startswith("serving.") or name in TIME_GAUGES:
            continue
        for s in fam["series"]:
            v = s["value"]["count"] if fam["type"] == "histogram" \
                else s["value"]
            if v:
                out[(name, fam["type"], tuple(sorted(
                    s["labels"].items())))] = v
    return out


def record_fields(recs):
    return [(r["rid"], r["prompt_tokens"], r["new_tokens"],
             r["preemptions"], r["outcome"], sorted(r["phases"]))
            for r in recs]


class Telemetry:
    """One trace through an engine after its package's registry and
    timeline are reset; keeps the series, records and compile report."""

    def __init__(self, metrics_mod, timeline_mod, make, reqs, fire=None):
        metrics_mod.reset_all()
        timeline_mod.reset_default()
        self.engine = make()
        self.res = self.engine.serve(reqs)
        self.series = series(metrics_mod.snapshot())
        self.records = timeline_mod.current().records()
        self.summary = timeline_mod.current().summary()
        self.report = self.engine.compile_report()


def serve_both(jm, tm, specs, jax_kw=None, port_kw=None, jax_fire=None,
               port_fire=None, **kw):
    """The trace through JAX's engine and the port's (``*_fire``: each
    package's ``serve.mid_spill`` fire point while it serves)."""
    out = []
    for inj, fire, mod, rt, make, reqs in (
            (jinj, jax_fire, jmetrics, jrt,
             lambda: JEngine(jm, **{**kw, **(jax_kw or {})}),
             [JRequest(**s) for s in specs]),
            (tinj, port_fire, tmetrics, trt,
             lambda: ServingEngine(tm, device="cpu",
                                   **{**kw, **(port_kw or {})}),
             [Request(**s) for s in specs])):
        inj.register_fire_point("serve.mid_spill", fire)
        try:
            out.append(Telemetry(mod, rt, make, reqs))
        finally:
            inj.register_fire_point("serve.mid_spill", None)
    return out


@pytest.fixture(scope="module")
def ragged_spill():
    """Preemption and spill: 4 requests through a 10-block pool."""
    assert tflags.flag("telemetry") != "off"
    jm, tm = carried(max_position_embeddings=32)
    return serve_both(jm, tm, ragged(4, lo=8, hi=14, max_new=8, seed=1),
                      block_size=4, num_blocks=10, max_batch=4,
                      max_seq_len=32)


@pytest.fixture(scope="module")
def overload():
    """bench.py's overload trace through the starved engine with the
    degrade-mode policy and a ``SpillError`` at the first spill."""
    jm, tm = carried(max_position_embeddings=160)

    def bomb(exc):
        calls = [0]

        def fire():
            calls[0] += 1
            if calls[0] == 1:
                raise exc("injected host allocation failure")
        return fire

    pol = dict(min_free_block_frac=0.2, max_p99_decode_ms=5e3, degrade=True)
    return serve_both(jm, tm, overload_trace(),
                      jax_kw=dict(shed_policy=JShedPolicy(**pol)),
                      port_kw=dict(shed_policy=ShedPolicy(**pol)),
                      jax_fire=bomb(JSpillError), port_fire=bomb(SpillError),
                      block_size=8, num_blocks=16, max_batch=4,
                      max_waiting=8, validate_capacity=False)


@pytest.fixture(scope="module")
def tiers():
    """Prefix sharing, chunked prefill and speculation with a
    ``ModelDrafter``, composed under pool pressure."""
    jm, tm = carried(max_position_embeddings=32)
    jd, td = carried(**DRAFTER)
    rng = np.random.default_rng(2)
    shared = rng.integers(0, 128, 8)
    specs = [dict(rid=f"t{i}", prompt_ids=np.concatenate(
        [shared, rng.integers(0, 128, 6)]), max_new_tokens=8)
        for i in range(4)]
    return serve_both(jm, tm, specs,
                      jax_kw=dict(drafter=JModelDrafter(jd)),
                      port_kw=dict(drafter=ModelDrafter(td)),
                      block_size=4, num_blocks=12, max_batch=4,
                      max_seq_len=32, prefill_buckets=[16],
                      decode_buckets=[4], prefix_cache=True,
                      chunked_prefill=8, speculative=2)


CASES = ["ragged_spill", "overload", "tiers"]


@pytest.fixture(params=CASES)
def case(request):
    return request.getfixturevalue(request.param)


def test_counters_and_gauges_match_jax(case):
    j, t = case
    scalar = lambda s: {k: v for k, v in s.items()  # noqa: E731
                        if k[1] != "histogram"}
    assert scalar(t.series) == scalar(j.series)
    assert any(k[0] == "serving.requests" for k in t.series)


def test_histogram_counts_match_jax(case):
    j, t = case
    hist = lambda s: {k: v for k, v in s.items()  # noqa: E731
                      if k[1] == "histogram"}
    assert hist(t.series) == hist(j.series)
    assert any(k[0] == "serving.decode_step_ms" for k in t.series)


def test_timeline_records_match_jax(case):
    j, t = case
    assert record_fields(t.records) == record_fields(j.records)
    assert len(t.records) == len(t.res)
    for r in t.records:
        if r["outcome"] == "ok":
            assert 0 <= r["ttft_ms"] <= r["total_ms"]
    drop = ("p50_ms", "p99_ms", "ttft_p50_ms", "ttft_p99_ms", "phases")
    assert {k: v for k, v in t.summary.items() if k not in drop} == \
        {k: v for k, v in j.summary.items() if k not in drop}


def test_compile_report_matches_jax(case):
    j, t = case
    assert t.report == j.report
    assert t.report["within_budget"] and not t.report["o001_fired"]


def test_counters_match_the_endings(case):
    """Each ending's counter equals the count of that ending in the
    results; completed and generated-token counters match the records."""
    _, t = case
    ends = {}
    for r in t.res.values():
        key = "rejected" if isinstance(r, (Rejected, JRejected)) \
            else r.status.value
        ends[key] = ends.get(key, 0) + 1
    for outcome in ("rejected", "expired", "shed", "failed"):
        assert t.series.get((f"serving.{outcome}", "counter", ()), 0) == \
            ends.get(outcome, 0), outcome
    ok = [r for r in t.records if r["outcome"] == "ok"]
    assert t.series.get(("serving.requests_completed", "counter", ()),
                        0) == len(ok) == ends.get("finished", 0)
    assert t.series.get(("serving.tokens_generated", "counter", ()), 0) == \
        sum(r["new_tokens"] for r in ok)
    assert t.series[("serving.requests", "counter", ())] == len(t.res)


def test_each_case_exercises_its_signals(ragged_spill, overload, tiers):
    keys = lambda c: {k[0] for k in c[1].series}  # noqa: E731
    assert {"serving.preemptions", "serving.kv_spills",
            "serving.kv_restores"} <= keys(ragged_spill)
    assert {"serving.rejected", "serving.expired", "serving.shed",
            "serving.failed", "serving.overload_iterations"} <= \
        keys(overload)
    assert {"serving.chunked_prefill_iterations", "serving.spec_accept_len",
            "serving.prefix_nodes", "serving.prefill_ms"} <= keys(tiers)
    rep = tiers[1].report
    assert rep["extend_signatures"] >= 1 and rep["verify_signatures"] >= 1


def test_telemetry_off_records_nothing_and_changes_no_output():
    """``FLAGS_telemetry=off`` in the port: the same outputs as under
    ``metrics``, and the engine reports nothing (no series, no timeline
    record, no signature); the reference's engine reports under every
    flag value, the port's obeys the flag."""
    jm, tm = carried(max_position_embeddings=32)
    specs = ragged(3, lo=8, hi=14, max_new=6, seed=4)
    out = {}
    before = tflags.flag("telemetry")
    try:
        for mode in ("off", "metrics"):
            tflags.set_flags({"telemetry": mode})
            tmetrics.reset_all()
            trt.reset_default()
            eng = ServingEngine(tm, block_size=4, num_blocks=10,
                                max_batch=4, max_seq_len=32, device="cpu")
            res = eng.serve([Request(**s) for s in specs])
            out[mode] = ({rid: s.output.tolist() for rid, s in res.items()},
                         series(tmetrics.snapshot()),
                         trt.current().records(), eng.compile_report())
    finally:
        tflags.set_flags({"telemetry": before})
    assert out["off"][0] == out["metrics"][0]
    assert out["off"][1] == {} and out["off"][2] == []
    assert out["off"][3]["prefill_signatures"] == 0
    assert len(out["metrics"][2]) == 3 and out["metrics"][1]
    assert out["metrics"][3]["prefill_signatures"] >= 1
