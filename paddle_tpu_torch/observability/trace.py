"""Span-tree tracer: host-side nested spans with structured export.

The port of ``paddle_tpu/observability/trace.py``:

- :func:`span` — thread-safe, nestable context manager. Active only under
  ``FLAGS_telemetry=trace``; when active it also opens a
  ``torch.profiler.record_function`` range of the span's name, so the span
  shows inside a ``torch.profiler`` capture beside the card's kernels (where
  JAX opens a ``jax.profiler.TraceAnnotation``);
- completed spans land in a bounded in-memory ring (oldest evicted), so a
  long run can keep tracing without growing;
- :func:`export_chrome_trace` (``chrome://tracing`` / Perfetto JSON) and
  :func:`export_jsonl` (one span per line, the format
  ``tools/trace_view.py`` aggregates).

Spans are host wall time (``perf_counter_ns``): a span around a CUDA
launch measures the launch, not the kernel, and nothing here synchronises
the device.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from ..core.flags import flag

__all__ = ["span", "Span", "telemetry_mode", "tracing_active", "spans",
           "open_spans", "clear", "export_chrome_trace", "export_jsonl",
           "RING_CAPACITY"]

RING_CAPACITY = 65536

_ring: "deque[Dict[str, Any]]" = deque(maxlen=RING_CAPACITY)
_ring_mu = threading.Lock()
_tls = threading.local()
# spans entered but not yet exited, across ALL threads — the export
# functions emit these as explicit `incomplete` spans so a hang
# postmortem shows WHERE the process was stuck, not just that it was
_open_mu = threading.Lock()
_open: Dict[int, "Span"] = {}


def telemetry_mode() -> str:
    """Current ``FLAGS_telemetry`` value (off | metrics | trace)."""
    try:
        return str(flag("telemetry"))
    except KeyError:  # core.flags not initialized (partial import)
        return "off"


def tracing_active() -> bool:
    return telemetry_mode() == "trace"


def _stack() -> List["Span"]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


class Span:
    """One open span; records itself into the ring on exit."""

    __slots__ = ("name", "attrs", "begin_ns", "depth", "tid", "_ann",
                 "_active")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self.begin_ns = 0
        self.depth = 0
        self.tid = 0
        self._ann = None
        self._active = False

    def __enter__(self) -> "Span":
        self._active = tracing_active()
        if not self._active:
            return self
        st = _stack()
        self.depth = len(st)
        st.append(self)
        self.tid = threading.get_ident()
        with _open_mu:
            _open[id(self)] = self
        try:  # device-trace correlation: a range in a torch.profiler capture
            import torch
            self._ann = torch.profiler.record_function(self.name)
            self._ann.__enter__()
        except Exception:
            self._ann = None
        self.begin_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        if not self._active:
            return False
        end_ns = time.perf_counter_ns()
        if self._ann is not None:
            self._ann.__exit__(*exc)
            self._ann = None
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        with _open_mu:
            _open.pop(id(self), None)
        rec = {
            "kind": "span",
            "name": self.name,
            "ts_us": self.begin_ns / 1e3,
            "dur_us": (end_ns - self.begin_ns) / 1e3,
            "tid": threading.get_ident(),
            "depth": self.depth,
        }
        if self.attrs:
            rec["attrs"] = dict(self.attrs)
        with _ring_mu:
            _ring.append(rec)
        return False


def span(name: str, **attrs: Any) -> Span:
    """``with span("offload/h2d", block=3): ...`` — no-op unless
    ``FLAGS_telemetry=trace`` (checked at enter, so runtime ``set_flags``
    changes take effect immediately)."""
    return Span(name, attrs)


def spans() -> List[Dict[str, Any]]:
    """Snapshot of the ring (oldest first) — completed spans only; see
    :func:`open_spans` for the in-flight ones."""
    with _ring_mu:
        return list(_ring)


def open_spans() -> List[Dict[str, Any]]:
    """Spans still open right now, as ``incomplete`` records whose end
    is the call time — a span that never closes is the signature of a
    hang, and dropping it (the old export behavior) hid exactly the
    evidence a hang postmortem needs."""
    now_ns = time.perf_counter_ns()
    with _open_mu:
        live = list(_open.values())
    out = []
    for s in live:
        rec = {
            "kind": "span",
            "name": s.name,
            "ts_us": s.begin_ns / 1e3,
            "dur_us": max(0.0, (now_ns - s.begin_ns) / 1e3),
            "tid": s.tid,
            "depth": s.depth,
            "incomplete": True,
        }
        if s.attrs:
            rec["attrs"] = dict(s.attrs)
        out.append(rec)
    out.sort(key=lambda r: r["ts_us"])
    return out


def clear() -> None:
    with _ring_mu:
        _ring.clear()
    with _open_mu:
        _open.clear()


def export_chrome_trace(path: str) -> int:
    """Write the ring as chrome-trace JSON; returns the event count.
    Spans still open at export time are emitted too (end = export time,
    ``args.incomplete`` set) instead of being silently dropped."""
    events = []
    for s in spans() + open_spans():
        ev = {"name": s["name"], "ph": "X", "ts": s["ts_us"],
              "dur": s["dur_us"], "pid": 0, "tid": s["tid"]}
        args = dict(s.get("attrs") or {})
        if s.get("incomplete"):
            args["incomplete"] = True
        if args:
            ev["args"] = args
        events.append(ev)
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    return len(events)


def export_jsonl(path: str, append: bool = False) -> int:
    """Write the ring as JSONL (one span per line); returns the count.
    Open spans land flagged ``"incomplete": true`` with end = export
    time."""
    recs = spans() + open_spans()
    with open(path, "a" if append else "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    return len(recs)
