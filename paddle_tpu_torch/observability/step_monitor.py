"""Step timeline, recompile sentinel, and HBM watermarks.

The port of ``paddle_tpu/observability/step_monitor.py``: the always-on
measurement layer of the training hot path. Three signals, all host-side:
no phase, step or sample synchronises the device or reads a device value,
so outputs are bitwise identical under every ``FLAGS_telemetry`` mode.

**StepTimeline** — per-step phase accounting. ``framework.sharded.
TrainStep``, ``io.dataloader`` and the ``hapi`` fit loop report into the
phases (``data``, ``h2d``, ``compile``, ``device``, ``callbacks``, ...);
each completed step is a record in a bounded ring, durations also feed the
log-bucket histograms in :mod:`.metrics`, and under
``FLAGS_telemetry=trace`` every phase opens a :mod:`.trace` span. A phase
times the host: on the GPU ``device`` is the time to launch the step's
work, and the device time shows where a later step waits on it.
``tools/trace_view.py`` aggregates the JSONL export.

**RecompileSentinel** — every instrumented dispatch fingerprints its
argument signature (per leaf: path, shape, dtype and the tensor's device);
when one callable accumulates more than N distinct fingerprints the
sentinel raises a :class:`~paddle_tpu_torch.analysis.diagnostics.
Diagnostic` (rule O001) through the analysis channel, with the leaf-level
diff between the two most recent signatures. In the port the first
dispatch of a new signature pays the first-use kernel build, autotune and
the caching allocator's growth (where JAX pays a compile); it is timed
under the ``compile`` phase.

**HBM watermarks** — the caching allocator's counters
(``torch.cuda.memory_stats_as_nested_dict(device)``, what
``torch.cuda.memory_stats`` flattens) sampled at every step end:
``allocated_bytes.all.current`` stands for JAX's
``bytes_in_use`` and ``allocated_bytes.all.peak`` for
``peak_bytes_in_use`` (the caching allocator's live and peak bytes; the
card's memory is HBM3, and the gauges keep JAX's ``hbm.*`` names),
cross-checkable against a static plan via :meth:`StepTimeline.check_plan`
(rule O002). On a CPU device sampling returns None.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import flight_recorder, metrics, trace
from .trace import telemetry_mode

__all__ = ["StepTimeline", "RecompileSentinel", "current", "reset_default",
           "fingerprint", "fingerprint_diff", "instrument_jitted",
           "PHASES", "GB"]

PHASES = ("data", "h2d", "compile", "device", "comm",
          "ckpt_save", "ckpt_restore", "offload_in",
          "offload_out", "callbacks",
          # training-health tier (fault/health.py): the SDC canary's
          # double-execution window and the guardian's rewind restore
          "canary", "rewind")

GB = float(2 ** 30)

# Distinct compile fingerprints one callable may accumulate before the
# sentinel fires: 1 is the expected compile, 2 tolerates a one-off second
# signature (e.g. a short final batch); the 3rd distinct signature is churn.
DEFAULT_RECOMPILE_THRESHOLD = 2


# ---------------------------------------------------------------------------
# Abstract-signature fingerprinting
# ---------------------------------------------------------------------------

def _dtype_name(dtype) -> str:
    """``float32``, ``bfloat16``, ``int32``: JAX's spelling of a dtype
    (torch's ``torch.float32`` loses its prefix)."""
    s = str(dtype)
    return s[len("torch."):] if s.startswith("torch.") else s


def _leaf_desc(x) -> Tuple[str, str, str]:
    """(shape, dtype, place) of one leaf: the parts of a signature a new
    dispatch keys on. The place is a tensor's device (``cuda:0``), where
    JAX writes the sharding."""
    shape = "x".join(str(int(d)) for d in getattr(x, "shape", ()) or ())
    dtype = getattr(x, "dtype", None)
    dtype = type(x).__name__ if dtype is None else _dtype_name(dtype)
    dev = getattr(x, "device", None)
    place = str(dev) if dev is not None and not isinstance(x, np.ndarray) \
        else ""
    return (shape, dtype, place)


def _leaves(tree: Any, path: str = ""):
    """(path, leaf) of a tree of dicts, lists and tuples, in
    ``jax.tree_util`` order (dict keys sorted, None an empty subtree),
    each path written as ``jax.tree_util.keystr`` writes it."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from _leaves(v, f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _fast(tree: Any) -> Any:
    """Structure and per-leaf (shape, dtype), with no path strings."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return ("d",) + tuple((k, _fast(tree[k])) for k in sorted(tree))
    if isinstance(tree, (list, tuple)):
        return (type(tree),) + tuple(_fast(v) for v in tree)
    return (tuple(getattr(tree, "shape", ()) or ()),
            getattr(tree, "dtype", type(tree)))


def fingerprint(tree: Any, donate: Sequence[int] = ()) -> Tuple:
    """Hashable signature of a tree: per-leaf (path, shape, dtype, place)
    plus the donation config, as JAX's ``fingerprint`` (the port donates
    nothing; ``donate`` is kept so signatures compare with JAX's)."""
    return (tuple(donate),) + tuple(
        (path,) + _leaf_desc(leaf) for path, leaf in _leaves(tree))


def fingerprint_fast(tree: Any) -> Tuple:
    """Cheap per-dispatch signature: the structure and per-leaf shape and
    dtype, no path strings and no device; the sentinel computes the full
    :func:`fingerprint` only when this one is new. A move to another
    device that changes neither shape nor dtype is the one signature
    change this tier cannot see."""
    return _fast(tree)


def fingerprint_diff(old: Tuple, new: Tuple) -> str:
    """Human-readable leaf-level diff between two fingerprints — the
    shape/dtype change that caused a recompile."""
    o_by = {e[0]: e[1:] for e in old[1:]}
    n_by = {e[0]: e[1:] for e in new[1:]}
    parts: List[str] = []
    if old[0] != new[0]:
        parts.append(f"donate {old[0]} -> {new[0]}")
    for key in sorted(set(o_by) | set(n_by)):
        a, b = o_by.get(key), n_by.get(key)
        if a == b:
            continue
        def fmt(d):
            if d is None:
                return "<absent>"
            shape, dtype, place = d
            return f"{dtype}[{shape.replace('x', ',')}]" + \
                (f"@{place}" if place else "")
        parts.append(f"{key or '<root>'}: {fmt(a)} -> {fmt(b)}")
    return "; ".join(parts) if parts else "<identical signatures>"


# ---------------------------------------------------------------------------
# Recompile sentinel
# ---------------------------------------------------------------------------

class RecompileSentinel:
    """Counts distinct abstract signatures per jitted callable; fires one
    Diagnostic (rule O001, via the analysis channel) per callable when the
    count exceeds the threshold."""

    def __init__(self, threshold: int = DEFAULT_RECOMPILE_THRESHOLD):
        self.threshold = threshold
        self._mu = threading.Lock()
        self._seen: Dict[Any, List[Tuple]] = {}
        self._fast: Dict[Any, set] = {}
        self._fired: set = set()
        self.diagnostics: List[Any] = []

    def observe_tree(self, key: Any, tree: Any, donate: Sequence[int] = (),
                     where: str = "") -> bool:
        """Two-tier :meth:`observe`: the cheap fingerprint gates the full
        one, so the steady state (signature already seen) costs a couple
        of microseconds. Returns True when the signature is new."""
        fast = fingerprint_fast(tree)
        with self._mu:
            seen = self._fast.setdefault(key, set())
            if fast in seen:
                return False
            seen.add(fast)
        return self.observe(key, fingerprint(tree, donate), where)

    def observe(self, key: Any, fp: Tuple, where: str = "") -> bool:
        """Record one dispatch. Returns True when `fp` is NEW for `key`
        (i.e. this dispatch pays a compile)."""
        with self._mu:
            fps = self._seen.setdefault(key, [])
            if fp in fps:
                return False
            fps.append(fp)
            n = len(fps)
            fire = n > self.threshold and key not in self._fired
            if fire:
                self._fired.add(key)
            prev = fps[-2] if n >= 2 else None
        metrics.counter(
            "telemetry.compiles",
            "distinct jit signatures observed per callable").labels(
                fn=str(where or key)).inc()
        if fire:
            self._emit(key, where, n, prev, fp)
        return True

    def _emit(self, key, where, n, prev, fp) -> None:
        from ..analysis import diagnostics
        d = diagnostics.Diagnostic(
            rule="O001", name="recompile-churn",
            severity=diagnostics.WARNING,
            message=(f"callable compiled {n} times with differing "
                     f"signatures (threshold {self.threshold}); last "
                     f"change: {fingerprint_diff(prev, fp)}"),
            where=where or str(key),
            hint="pad/bucket inputs to a fixed shape set, or mark the "
                 "varying operand static — every new signature's first "
                 "dispatch pays the first-use kernel build, autotune and "
                 "allocator growth")
        with self._mu:   # reset() swaps the list under the same lock
            self.diagnostics.append(d)
        metrics.counter("telemetry.recompile_churn",
                        "recompile-sentinel firings").inc()
        flight_recorder.emit("diag", rule=d.rule, where=d.where,
                             message=d.message)
        try:
            diagnostics.emit([d], where=d.where)
        except diagnostics.GraphLintError:
            raise
        except Exception:
            pass

    def reset(self) -> None:
        with self._mu:
            self._seen.clear()
            self._fast.clear()
            self._fired.clear()
            self.diagnostics = []


# ---------------------------------------------------------------------------
# Step timeline
# ---------------------------------------------------------------------------

class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Phase:
    __slots__ = ("_tl", "name", "_span", "_t0")

    def __init__(self, tl: "StepTimeline", name: str, attrs: Dict[str, Any]):
        self._tl = tl
        self.name = name
        self._span = trace.span(f"step/{name}", **attrs)
        self._t0 = 0

    def __enter__(self):
        self._span.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur_ms = (time.perf_counter_ns() - self._t0) / 1e6
        self._span.__exit__(*exc)
        self._tl._phase_done(self.name, dur_ms)
        return False


class _Step:
    __slots__ = ("_tl", "_span")

    def __init__(self, tl: "StepTimeline"):
        self._tl = tl
        self._span = None

    def __enter__(self):
        idx = self._tl._step_begin()
        self._span = trace.span("step", step=idx)
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        self._span.__exit__(*exc)
        self._tl._step_end()
        return False


class StepTimeline:
    """Per-step phase timeline + recompile sentinel + HBM watermarks.

    All methods are cheap no-ops under ``FLAGS_telemetry=off``; the flag is
    re-read at every step/phase entry so runtime ``set_flags`` changes take
    effect immediately.
    """

    def __init__(self, capacity: int = 4096,
                 recompile_threshold: int = DEFAULT_RECOMPILE_THRESHOLD,
                 device: Any = None):
        self._mu = threading.RLock()
        self._steps: "deque[Dict[str, Any]]" = deque(maxlen=capacity)
        self._cur: Optional[Dict[str, Any]] = None
        self._cur_t0 = 0
        self._step_idx = 0
        self._device = device
        self.sentinel = RecompileSentinel(recompile_threshold)
        self.hbm_peak_bytes = 0
        self.hbm_live_bytes = 0
        self.diagnostics: List[Any] = []
        # hot-path metric children resolved once (registry + label lookups
        # off the per-phase path)
        self._phase_hists: Dict[str, Any] = {}
        self._step_hist = metrics.histogram(
            "telemetry.step_ms", "wall time per step (ms)").labels()
        self._step_counter = metrics.counter(
            "telemetry.steps", "completed training steps").labels()

    # -- gating --------------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return telemetry_mode() != "off"

    # -- step / phase context managers --------------------------------------

    def step(self):
        """``with timeline.step(): ...`` around one training step."""
        if not self.enabled:
            return _NOOP
        return _Step(self)

    def phase(self, name: str, **attrs):
        """``with timeline.phase("h2d"): ...``; durations accumulate into
        the current step record (or stand alone between steps) and feed
        the ``telemetry.phase_ms`` histogram."""
        if not self.enabled:
            return _NOOP
        return _Phase(self, name, attrs)

    def note(self, key: str, value: Any) -> None:
        """Annotate the OPEN step record (no-op between steps / off).
        ``sharded.TrainStep`` notes its applied-step ``index`` here so
        the flight recorder's step commits carry the trainer's global
        step, not just the timeline's incarnation-local count."""
        if not self.enabled:
            return
        with self._mu:
            if self._cur is not None:
                self._cur[key] = value

    def _step_begin(self) -> int:
        with self._mu:
            self._step_idx += 1
            self._cur = {"kind": "step", "step": self._step_idx, "phases": {}}
            self._cur_t0 = time.perf_counter_ns()
            return self._step_idx

    def _step_end(self) -> None:
        hbm = self.sample_hbm()
        with self._mu:
            cur, t0 = self._cur, self._cur_t0
            self._cur = None
        if cur is None:
            return
        cur["total_ms"] = (time.perf_counter_ns() - t0) / 1e6
        if hbm is not None:
            cur["hbm_live_gb"] = round(hbm["bytes_in_use"] / GB, 4)
            cur["hbm_peak_gb"] = round(hbm["peak_bytes_in_use"] / GB, 4)
        with self._mu:
            self._steps.append(cur)
        self._step_counter.inc()
        self._step_hist.observe(cur["total_ms"])
        # black-box commit: the step's phase totals land in the
        # crash-persistent ring the moment the record returns, so a
        # SIGKILL in the very next instruction keeps this step
        flight_recorder.emit(
            "step", step=cur["step"], index=cur.get("index"),
            total_ms=round(cur["total_ms"], 4),
            phases={k: round(v, 4) for k, v in cur["phases"].items()},
            **({"hbm_peak_gb": cur["hbm_peak_gb"]}
               if "hbm_peak_gb" in cur else {}))
        flight_recorder.maybe_metrics(cur.get("index", cur["step"]))

    def _phase_done(self, name: str, dur_ms: float) -> None:
        with self._mu:
            standalone = self._cur is None
            if self._cur is not None:
                ph = self._cur["phases"]
                ph[name] = ph.get(name, 0.0) + dur_ms
            hist = self._phase_hists.get(name)
            if hist is None:
                hist = self._phase_hists[name] = metrics.histogram(
                    "telemetry.phase_ms",
                    "wall time per step phase (ms)").labels(phase=name)
        hist.observe(dur_ms)
        if standalone:
            # between-steps phases (ckpt_restore, the guardian's rewind)
            # are exactly the recovery work a postmortem reconstructs
            flight_recorder.emit("phase", phase=name,
                                 ms=round(dur_ms, 4))

    # -- dispatch observation (sentinel + compile attribution) ---------------

    def observe_dispatch(self, key: Any, tree: Any,
                         donate: Sequence[int] = (), where: str = "") -> str:
        """Feed one dispatch's argument pytree to the sentinel; returns
        the phase name the dispatch should be timed under ("compile" the
        first time a signature is seen, "device" after)."""
        return "compile" if self.sentinel.observe_tree(key, tree, donate,
                                                       where) else "device"

    # -- HBM watermarks ------------------------------------------------------

    def _default_device(self):
        """The card (the current CUDA device) unless the timeline was
        given a device; None without CUDA or on a CPU device."""
        if self._device is None:
            if not torch.cuda.is_available():
                return None
            self._device = torch.device("cuda", torch.cuda.current_device())
        dev = torch.device(self._device)
        return dev if dev.type == "cuda" else None

    def sample_hbm(self) -> Optional[Dict[str, int]]:
        """One sample of the caching allocator's host-side counters (no
        synchronisation) -> gauges + process peak; None on a CPU device.
        It reads ``torch.cuda.memory_stats_as_nested_dict``, the counters
        ``torch.cuda.memory_stats`` flattens and sorts in Python."""
        dev = self._default_device()
        if dev is None:
            return None
        try:
            ms = torch.cuda.memory_stats_as_nested_dict(dev)
        except Exception:
            return None
        alloc = (ms or {}).get("allocated_bytes", {}).get("all")
        if not alloc:
            return None
        live = int(alloc.get("current", 0))
        peak = int(alloc.get("peak", live))
        with self._mu:
            self.hbm_live_bytes = live
            self.hbm_peak_bytes = max(self.hbm_peak_bytes, peak, live)
        metrics.gauge("hbm.bytes_in_use", "live device bytes").set(live)
        metrics.gauge("hbm.peak_bytes_in_use",
                      "runtime peak device bytes").set(
                          max(self.hbm_peak_bytes, peak))
        return {"bytes_in_use": live, "peak_bytes_in_use": peak}

    def check_plan(self, plan: Dict[str, Any], slack: float = 0.05):
        """Cross-check the measured HBM peak against a static plan from
        ``tools/hbm_budget.py`` (a ``gpt_plan``-style dict with
        ``device_gb``). Returns the O002 Diagnostic when the measured peak
        exceeds the plan by more than ``slack`` (and routes it through the
        analysis channel), else None."""
        planned_gb = float(plan.get("device_gb", 0.0))
        if not planned_gb or not self.hbm_peak_bytes:
            return None
        measured_gb = self.hbm_peak_bytes / GB
        if measured_gb <= planned_gb * (1.0 + slack):
            return None
        from ..analysis import diagnostics
        d = diagnostics.Diagnostic(
            rule="O002", name="hbm-plan-exceeded",
            severity=diagnostics.WARNING,
            message=(f"measured HBM peak {measured_gb:.2f} GB exceeds the "
                     f"static plan's {planned_gb:.2f} GB "
                     f"(+{100 * (measured_gb / planned_gb - 1):.1f}%)"),
            where="observability.step_monitor",
            hint="the tools/hbm_budget.py accounting is missing a row "
                 "(new activation, fragmentation, an un-donated buffer) — "
                 "update the plan or find the leak")
        with self._mu:   # reset() swaps the list under the same lock
            self.diagnostics.append(d)
        flight_recorder.emit("diag", rule=d.rule, where=d.where,
                             message=d.message)
        try:
            diagnostics.emit([d], where=d.where)
        except diagnostics.GraphLintError:
            raise
        except Exception:
            pass
        return d

    # -- inspection / export -------------------------------------------------

    def steps(self) -> List[Dict[str, Any]]:
        with self._mu:
            return list(self._steps)

    def all_diagnostics(self) -> List[Any]:
        return list(self.sentinel.diagnostics) + list(self.diagnostics)

    def summary(self) -> Dict[str, Any]:
        """Per-phase aggregate over the recorded steps."""
        steps = self.steps()
        phases: Dict[str, Dict[str, float]] = {}
        for s in steps:
            for name, ms in s.get("phases", {}).items():
                agg = phases.setdefault(
                    name, {"calls": 0, "total_ms": 0.0, "max_ms": 0.0})
                agg["calls"] += 1
                agg["total_ms"] += ms
                agg["max_ms"] = max(agg["max_ms"], ms)
        for agg in phases.values():
            agg["avg_ms"] = agg["total_ms"] / max(agg["calls"], 1)
        totals = [s["total_ms"] for s in steps if "total_ms" in s]
        return {
            "steps": len(steps),
            "phases": {k: {kk: (round(vv, 4) if isinstance(vv, float) else vv)
                           for kk, vv in v.items()}
                       for k, v in sorted(phases.items())},
            "avg_step_ms": round(sum(totals) / len(totals), 4)
            if totals else None,
            "hbm_peak_gb": round(self.hbm_peak_bytes / GB, 4)
            if self.hbm_peak_bytes else None,
            "recompile_diagnostics": len(self.sentinel.diagnostics),
        }

    def export_jsonl(self, path: str, append: bool = False) -> int:
        """One JSON record per step (the ``tools/trace_view.py`` input);
        returns the record count."""
        steps = self.steps()
        with open(path, "a" if append else "w") as f:
            for s in steps:
                f.write(json.dumps(s) + "\n")
        return len(steps)

    def reset(self) -> None:
        with self._mu:
            self._steps.clear()
            self._cur = None
            self._step_idx = 0
            self.hbm_peak_bytes = 0
            self.hbm_live_bytes = 0
            self.diagnostics = []
        self.sentinel.reset()


# ---------------------------------------------------------------------------
# Process-wide default timeline
# ---------------------------------------------------------------------------

_default: Optional[StepTimeline] = None
_default_mu = threading.Lock()


def current() -> StepTimeline:
    """The process-wide timeline every instrumented subsystem reports to."""
    global _default
    tl = _default
    if tl is None:
        with _default_mu:
            if _default is None:
                _default = StepTimeline()
            tl = _default
    return tl


def reset_default() -> StepTimeline:
    """Fresh default timeline (tests / run boundaries)."""
    global _default
    with _default_mu:
        _default = StepTimeline()
        return _default


# ---------------------------------------------------------------------------
# Generic jitted-callable instrumentation
# ---------------------------------------------------------------------------

def instrument_jitted(fn, name: Optional[str] = None,
                      timeline: Optional[StepTimeline] = None,
                      donate: Sequence[int] = ()):
    """Wrap any callable: each call is fingerprinted through the recompile
    sentinel and timed under the "compile" (first time a signature is
    seen) or "device" phase. JAX's AOT attributes (``lower``, ``trace``)
    have no counterpart in the port. Zero-added-behavior under
    ``FLAGS_telemetry=off``."""
    label = name or getattr(fn, "__name__", "jitted")
    key = (label, id(fn))

    def wrapper(*args, **kwargs):
        tl = timeline if timeline is not None else current()
        if not tl.enabled:
            return fn(*args, **kwargs)
        ph = tl.observe_dispatch(key, (args, kwargs), donate=donate,
                                 where=label)
        with tl.phase(ph, fn=label):
            return fn(*args, **kwargs)

    wrapper.__name__ = label
    wrapper.__wrapped__ = fn
    return wrapper
