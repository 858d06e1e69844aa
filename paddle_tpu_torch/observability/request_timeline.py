"""Per-request phase timeline for the serving tier
(``paddle_tpu/observability/request_timeline.py``, ported as it is).

The training-side :class:`~.step_monitor.StepTimeline` accounts a *step*;
a serving engine's unit of accounting is a *request*, and its latency
decomposes into four phases the operator actually acts on:

- ``queue``   — submit → prefill start (admission wait: batch slots or
  KV blocks exhausted);
- ``prefill`` — the bucketed prompt pass that writes paged KV and emits
  the first token (time-to-first-token = queue + prefill);
- ``decode``  — accumulated share of the continuous-batching decode
  iterations the request was resident in;
- ``detokenize`` — output assembly / tokenizer callback.

Each request that reaches a terminal state is one record in a bounded
ring (JSONL-exportable next to the step timeline — ``tools/trace_view.py``
passes ``kind: "request"`` records through untouched) and feeds the
``serving.*`` metric families in :mod:`.metrics`:
``serving.request_latency_ms`` / ``serving.ttft_ms`` histograms,
per-phase ``serving.phase_ms``, and the ``serving.requests_completed`` /
``serving.tokens_generated`` counters. Records carry an ``outcome``
(``ok``, or the resilience endings ``rejected``/``failed``/``expired``/
``shed`` — see RESILIENCE.md); only ok records feed the latency
families, and deadline-carrying records stamp ``deadline_met`` — the
input to :meth:`RequestTimeline.summary`'s ``slo_attainment_pct`` and
``shed_rate``. p50/p99 come from the exact recorded latencies, not
histogram buckets — tail latency is the headline serving metric and
deserves better than log2-bucket resolution.
"""

from __future__ import annotations

import json
import threading
from collections import deque
from typing import Any, Dict, List, Optional

from . import flight_recorder, metrics

__all__ = ["RequestTimeline", "REQUEST_PHASES", "current", "reset_default",
           "percentile"]

#: ``chunk_prefill`` replaces ``prefill`` on the extend path (prefix-hit
#: suffix prefill and chunked prefill); ``draft``/``verify`` replace
#: ``decode`` under speculative decoding.
REQUEST_PHASES = ("queue", "prefill", "chunk_prefill", "decode",
                  "draft", "verify", "detokenize")


def percentile(values: List[float], q: float) -> Optional[float]:
    """Linear-interpolated percentile (q in [0, 100]) of raw values."""
    if not values:
        return None
    vs = sorted(values)
    if len(vs) == 1:
        return vs[0]
    rank = (q / 100.0) * (len(vs) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(vs) - 1)
    frac = rank - lo
    return vs[lo] * (1.0 - frac) + vs[hi] * frac


class RequestTimeline:
    """Bounded ring of per-request records + the serving.* metric feed."""

    def __init__(self, capacity: int = 8192):
        self._mu = threading.Lock()
        self._records: "deque[Dict[str, Any]]" = deque(maxlen=capacity)
        self._completed = metrics.counter(
            "serving.requests_completed", "requests fully served").labels()
        self._tokens = metrics.counter(
            "serving.tokens_generated", "new tokens emitted").labels()
        self._lat = metrics.histogram(
            "serving.request_latency_ms",
            "submit-to-last-token wall time per request (ms)").labels()
        self._ttft = metrics.histogram(
            "serving.ttft_ms", "submit-to-first-token wall time (ms)").labels()

    def record(self, *, rid: str, prompt_tokens: int, new_tokens: int,
               phases_ms: Dict[str, float], total_ms: float,
               ttft_ms: Optional[float] = None,
               preemptions: int = 0, outcome: str = "ok",
               deadline_ms: Optional[float] = None,
               error: Optional[str] = None, **extra: Any) -> Dict[str, Any]:
        """Append one terminal request and feed the metric families.

        ``outcome`` is ``ok`` for a served request or one of the
        resilience endings (``rejected`` / ``failed`` / ``expired`` /
        ``shed``); non-ok records carry ``error`` and are kept OUT of the
        latency/TTFT histograms and percentiles — tail latency describes
        answers, not refusals. ``deadline_ms`` stamps the record with
        ``deadline_met`` (the SLO-attainment input: an ok outcome whose
        total latency fit the deadline)."""
        rec: Dict[str, Any] = {
            "kind": "request", "rid": rid,
            "prompt_tokens": int(prompt_tokens),
            "new_tokens": int(new_tokens),
            "preemptions": int(preemptions),
            "outcome": str(outcome),
            "total_ms": round(float(total_ms), 4),
            "phases": {k: round(float(v), 4)
                       for k, v in sorted(phases_ms.items())},
        }
        if ttft_ms is not None:
            rec["ttft_ms"] = round(float(ttft_ms), 4)
        if error is not None:
            rec["error"] = str(error)
        if deadline_ms is not None:
            rec["deadline_ms"] = round(float(deadline_ms), 4)
            rec["deadline_met"] = bool(outcome == "ok"
                                       and total_ms <= deadline_ms)
        rec.update(extra)
        with self._mu:
            self._records.append(rec)
        # the black box keeps the terminal outcome even when the engine
        # process is SIGKILLed right after — the journal's ack plus this
        # record is what the postmortem cross-checks for exactly-once
        flight_recorder.emit(
            "request", rid=rec["rid"], outcome=rec["outcome"],
            new_tokens=rec["new_tokens"],
            total_ms=rec["total_ms"], preemptions=rec["preemptions"],
            **({"error": rec["error"]} if "error" in rec else {}))
        if outcome == "ok":
            self._completed.inc()
            self._tokens.inc(int(new_tokens))
            self._lat.observe(float(total_ms))
            if ttft_ms is not None:
                self._ttft.observe(float(ttft_ms))
            for name, ms in phases_ms.items():
                metrics.histogram(
                    "serving.phase_ms",
                    "wall time per request phase (ms)").labels(
                        phase=name).observe(float(ms))
        return rec

    # -- inspection / export -------------------------------------------------

    def records(self) -> List[Dict[str, Any]]:
        with self._mu:
            return list(self._records)

    def summary(self) -> Dict[str, Any]:
        """Aggregates over the ring. Latency percentiles cover **served**
        (outcome ok) requests; ``outcomes`` counts every ending;
        ``slo_attainment_pct`` is the fraction of deadline-carrying
        requests whose ok answer landed within the deadline (a
        rejected/shed/expired/failed request with a deadline counts as a
        miss); ``shed_rate`` is (shed + rejected) / all records."""
        recs = self.records()
        ok = [r for r in recs if r.get("outcome", "ok") == "ok"]
        lats = [r["total_ms"] for r in ok]
        ttfts = [r["ttft_ms"] for r in ok if "ttft_ms" in r]
        outcomes: Dict[str, int] = {}
        for r in recs:
            o = r.get("outcome", "ok")
            outcomes[o] = outcomes.get(o, 0) + 1
        with_deadline = [r for r in recs if "deadline_ms" in r]
        met = sum(1 for r in with_deadline if r.get("deadline_met"))
        phases: Dict[str, Dict[str, float]] = {}
        for r in recs:
            for name, ms in r.get("phases", {}).items():
                agg = phases.setdefault(name, {"calls": 0, "total_ms": 0.0})
                agg["calls"] += 1
                agg["total_ms"] += ms
        for agg in phases.values():
            agg["avg_ms"] = round(agg["total_ms"] / max(agg["calls"], 1), 4)
            agg["total_ms"] = round(agg["total_ms"], 4)
        rnd = lambda v: None if v is None else round(v, 4)  # noqa: E731
        shed = outcomes.get("shed", 0) + outcomes.get("rejected", 0)
        return {
            "requests": len(recs),
            "served": len(ok),
            "outcomes": outcomes,
            "new_tokens": sum(r["new_tokens"] for r in recs),
            "preemptions": sum(r["preemptions"] for r in recs),
            "p50_ms": rnd(percentile(lats, 50)),
            "p99_ms": rnd(percentile(lats, 99)),
            "ttft_p50_ms": rnd(percentile(ttfts, 50)),
            "ttft_p99_ms": rnd(percentile(ttfts, 99)),
            "slo_attainment_pct": (
                round(100.0 * met / len(with_deadline), 4)
                if with_deadline else None),
            "shed_rate": (round(shed / len(recs), 4) if recs else 0.0),
            "phases": {k: phases[k] for k in sorted(phases)},
        }

    def export_jsonl(self, path: str, append: bool = False) -> int:
        recs = self.records()
        with open(path, "a" if append else "w") as f:
            for r in recs:
                f.write(json.dumps(r) + "\n")
        return len(recs)

    def reset(self) -> None:
        with self._mu:
            self._records.clear()


# ---------------------------------------------------------------------------
# Process-wide default (mirrors step_monitor.current())
# ---------------------------------------------------------------------------

_default: Optional[RequestTimeline] = None
_default_mu = threading.Lock()


def current() -> RequestTimeline:
    global _default
    tl = _default
    if tl is None:
        with _default_mu:
            if _default is None:
                _default = RequestTimeline()
            tl = _default
    return tl


def reset_default() -> RequestTimeline:
    global _default
    with _default_mu:
        _default = RequestTimeline()
        return _default
