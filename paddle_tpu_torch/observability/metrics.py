"""Labeled runtime metrics: counters, gauges, log-bucket histograms.

The port of ``paddle_tpu/observability/metrics.py``, with the same names,
buckets, label escaping and exposition formats, so a registry fed the same
calls in both packages gives equal :func:`snapshot` and
:func:`prometheus_text`. The flat ``stat_*`` surface of
``profiler/monitor.py`` forwards here, so its counters
(``dataloader.batches``, ``model.train_batches``) land in the same registry
as the telemetry series:

- :func:`prometheus_text` — Prometheus text format (names sanitized,
  histogram ``_bucket``/``_sum``/``_count`` with cumulative ``le``);
- :func:`snapshot` — JSON-able nested dict, for one-shot dumps.

Histograms use **fixed log-scale buckets** (powers of two spanning
~1e-6..1e6), so two processes, or two snapshots of one, always agree on
bucket boundaries. Everything is host-side and thread-safe (plain
``threading.Lock``s), and nothing here reads a device value.
"""

from __future__ import annotations

import bisect
import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

__all__ = [
    "Counter", "Gauge", "Histogram", "Stat", "Registry",
    "counter", "gauge", "histogram", "get_registry",
    "snapshot", "prometheus_text", "reset_all",
    "stat", "stat_add", "stat_set", "stat_get", "stats_snapshot",
    "stats_reset", "DEFAULT_BUCKETS",
]

_Number = Union[int, float]

# Fixed log2-scale bucket upper bounds: 2^-20 (~1e-6) .. 2^20 (~1e6), one
# bucket per octave. Deterministic — no timestamps, no env-derived state.
DEFAULT_BUCKETS: Tuple[float, ...] = tuple(2.0 ** e for e in range(-20, 21))

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> _LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _new_lock(name: str):
    """Registry lock factory (JAX's ``FLAGS_lockcheck`` seam; the port's
    locks are plain)."""
    return threading.Lock()


class _Child:
    """One (metric name, label set) time series."""

    __slots__ = ("name", "labels", "_mu")

    def __init__(self, name: str, labels: _LabelKey):
        self.name = name
        self.labels = labels
        self._mu = _new_lock("_Child._mu")

    def label_str(self) -> str:
        if not self.labels:
            return ""
        inner = ",".join(f'{k}="{v}"' for k, v in self.labels)
        return "{" + inner + "}"


class Counter(_Child):
    """Monotonic tally (events, batches, recompiles)."""

    __slots__ = ("_value",)

    def __init__(self, name: str, labels: _LabelKey):
        super().__init__(name, labels)
        self._value: _Number = 0

    def inc(self, n: _Number = 1) -> None:
        with self._mu:
            self._value += n

    add = inc  # monitor.StatValue verb

    def get(self) -> _Number:
        with self._mu:
            return self._value

    def reset(self) -> None:
        with self._mu:
            self._value = 0


class Gauge(_Child):
    """Point-in-time value (queue depth, HBM bytes, flat stats)."""

    __slots__ = ("_value",)

    def __init__(self, name: str, labels: _LabelKey):
        super().__init__(name, labels)
        self._value: _Number = 0

    def set(self, v: _Number) -> None:
        with self._mu:
            self._value = v

    def inc(self, n: _Number = 1) -> None:
        with self._mu:
            self._value += n

    add = inc  # monitor.StatValue verb

    def get(self) -> _Number:
        with self._mu:
            return self._value

    def reset(self) -> None:
        with self._mu:
            self._value = 0


# The absorbed monitor stat registry hands out gauges (they support both
# the add() and set() verbs of the old StatValue).
Stat = Gauge


class Histogram(_Child):
    """Distribution over fixed log-scale buckets (durations, bytes)."""

    __slots__ = ("buckets", "_counts", "_sum", "_count", "_min", "_max")

    def __init__(self, name: str, labels: _LabelKey,
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        super().__init__(name, labels)
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # last = +Inf overflow
        self._sum = 0.0
        self._count = 0
        self._min = None
        self._max = None

    def observe(self, v: _Number) -> None:
        v = float(v)
        i = bisect.bisect_left(self.buckets, v)
        with self._mu:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            self._min = v if self._min is None else min(self._min, v)
            self._max = v if self._max is None else max(self._max, v)

    def get(self) -> Dict[str, Any]:
        with self._mu:
            return {
                "count": self._count,
                "sum": self._sum,
                "avg": self._sum / self._count if self._count else 0.0,
                "min": self._min,
                "max": self._max,
            }

    def bucket_counts(self) -> Dict[str, List[float]]:
        """Raw per-bucket counts ``{"le": [...], "counts": [...]}`` (the
        final count is the +Inf overflow bucket). Buckets are fixed
        log2, so two processes' histograms merge by exact element-wise
        addition of ``counts`` — the cross-host contract the live fleet
        aggregator (observability/live.py) relies on."""
        with self._mu:
            return {"le": list(self.buckets), "counts": list(self._counts)}

    def cumulative(self) -> List[Tuple[float, int]]:
        """[(le, cumulative_count)] per bucket, +Inf last."""
        with self._mu:
            out, running = [], 0
            for le, c in zip(self.buckets, self._counts):
                running += c
                out.append((le, running))
            out.append((float("inf"), running + self._counts[-1]))
            return out

    def reset(self) -> None:
        with self._mu:
            self._counts = [0] * (len(self.buckets) + 1)
            self._sum = 0.0
            self._count = 0
            self._min = None
            self._max = None


class Family:
    """All series of one metric name (one kind, many label sets)."""

    def __init__(self, name: str, kind: type, help: str = "",
                 buckets: Optional[Iterable[float]] = None):
        self.name = name
        self.kind = kind
        self.help = help
        self._buckets = tuple(buckets) if buckets is not None else None
        self._mu = _new_lock("Family._mu")
        self._children: Dict[_LabelKey, _Child] = {}

    def labels(self, **labels: Any) -> Any:
        key = _label_key(labels)
        with self._mu:
            child = self._children.get(key)
            if child is None:
                if self.kind is Histogram:
                    child = Histogram(self.name, key,
                                      self._buckets or DEFAULT_BUCKETS)
                else:
                    child = self.kind(self.name, key)
                self._children[key] = child
            return child

    def children(self) -> List[_Child]:
        with self._mu:
            return [self._children[k] for k in sorted(self._children)]

    # convenience: family-level verbs hit the label-less child
    def inc(self, n: _Number = 1) -> None:
        self.labels().inc(n)

    def add(self, n: _Number = 1) -> None:
        self.labels().add(n)

    def set(self, v: _Number) -> None:
        self.labels().set(v)

    def observe(self, v: _Number) -> None:
        self.labels().observe(v)

    def get(self):
        return self.labels().get()

    def reset(self) -> None:
        for c in self.children():
            c.reset()

    # -- label-child GC ------------------------------------------------------

    def remove(self, **labels: Any) -> bool:
        """Drop the child with exactly these labels (True if it existed).
        Long-lived registries with per-replica/per-request labels grow
        without bound otherwise; the fleet aggregator calls this when a
        worker is retired. A later ``labels(...)`` call with the same
        label set recreates a fresh zeroed child."""
        key = _label_key(labels)
        with self._mu:
            return self._children.pop(key, None) is not None

    def expire(self, predicate) -> int:
        """Drop every child whose label dict satisfies ``predicate``;
        returns the number removed."""
        with self._mu:
            doomed = [k for k, c in self._children.items()
                      if predicate(dict(c.labels))]
            for k in doomed:
                del self._children[k]
            return len(doomed)


_KIND_NAMES = {Counter: "counter", Gauge: "gauge", Histogram: "histogram"}


class Registry:
    def __init__(self):
        self._mu = _new_lock("Registry._mu")
        self._families: Dict[str, Family] = {}

    def _family(self, name: str, kind: type, help: str,
                buckets: Optional[Iterable[float]] = None) -> Family:
        with self._mu:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = Family(name, kind, help, buckets)
            elif fam.kind is not kind:
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{_KIND_NAMES[fam.kind]}, not {_KIND_NAMES[kind]}")
            return fam

    def counter(self, name: str, help: str = "") -> Family:
        return self._family(name, Counter, help)

    def gauge(self, name: str, help: str = "") -> Family:
        return self._family(name, Gauge, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Iterable[float]] = None) -> Family:
        return self._family(name, Histogram, help, buckets)

    def families(self) -> List[Family]:
        with self._mu:
            return [self._families[k] for k in sorted(self._families)]

    def expire(self, predicate) -> int:
        """Registry-wide label-child GC: drop every series (in every
        family) whose ``(name, labels)`` satisfies ``predicate``;
        returns the number of series removed. Families themselves stay
        registered (type/help survive). Used by the fleet aggregator to
        retire a dead worker's ``worker=...`` children."""
        removed = 0
        for fam in self.families():
            removed += fam.expire(
                lambda labels, _n=fam.name: predicate(_n, labels))
        return removed

    # -- exposition ----------------------------------------------------------

    def snapshot(self, include_buckets: bool = False) -> Dict[str, Any]:
        """JSON-able dump: {name: {"type", "help", "series": [...]}}.

        ``include_buckets=True`` additionally attaches each histogram
        series' raw per-bucket counts under ``"buckets"`` (exact-merge
        food for the fleet aggregator); the default keeps the compact
        count/sum/avg/min/max shape bench records already embed."""
        out: Dict[str, Any] = {}
        for fam in self.families():
            series = []
            for c in fam.children():
                entry = {"labels": dict(c.labels), "value": c.get()}
                if include_buckets and isinstance(c, Histogram):
                    entry["buckets"] = c.bucket_counts()
                series.append(entry)
            out[fam.name] = {"type": _KIND_NAMES[fam.kind],
                             "help": fam.help, "series": series}
        return out

    def prometheus_text(self) -> str:
        lines: List[str] = []
        for fam in self.families():
            pname = _prom_name(fam.name)
            if fam.help:
                lines.append(f"# HELP {pname} {fam.help}")
            lines.append(f"# TYPE {pname} {_KIND_NAMES[fam.kind]}")
            for c in fam.children():
                if isinstance(c, Histogram):
                    base = dict(c.labels)
                    for le, cum in c.cumulative():
                        ls = _prom_labels({**base, "le": _fmt_le(le)})
                        lines.append(f"{pname}_bucket{ls} {cum}")
                    ls = _prom_labels(base)
                    g = c.get()
                    lines.append(f"{pname}_sum{ls} {g['sum']}")
                    lines.append(f"{pname}_count{ls} {g['count']}")
                else:
                    lines.append(
                        f"{pname}{_prom_labels(dict(c.labels))} {c.get()}")
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        for fam in self.families():
            fam.reset()

    # -- the absorbed flat stat surface (profiler/monitor.py) ---------------

    def stat(self, name: str) -> Stat:
        return self.gauge(name).labels()

    def stats_snapshot(self) -> Dict[str, _Number]:
        """Flat {series: value} over every counter/gauge — the old
        ``monitor.stats_snapshot`` view of the unified registry."""
        out: Dict[str, _Number] = {}
        for fam in self.families():
            if fam.kind is Histogram:
                continue
            for c in fam.children():
                out[c.name + c.label_str()] = c.get()
        return dict(sorted(out.items()))


def _prom_name(name: str) -> str:
    return "".join(ch if (ch.isalnum() or ch == "_") else "_"
                   for ch in name)


def _escape_label_value(v: str) -> str:
    """Prometheus text-format label-value escaping: backslash first,
    then double-quote and newline (exposition spec, in that order so an
    injected ``\\n`` doesn't double-escape)."""
    return (str(v).replace("\\", "\\\\")
                  .replace('"', '\\"')
                  .replace("\n", "\\n"))


def _prom_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{_prom_name(k)}="{_escape_label_value(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_le(le: float) -> str:
    return "+Inf" if le == float("inf") else repr(le)


# ---------------------------------------------------------------------------
# Default process-wide registry + module-level conveniences
# ---------------------------------------------------------------------------

_default = Registry()


def get_registry() -> Registry:
    return _default


def counter(name: str, help: str = "") -> Family:
    return _default.counter(name, help)


def gauge(name: str, help: str = "") -> Family:
    return _default.gauge(name, help)


def histogram(name: str, help: str = "",
              buckets: Optional[Iterable[float]] = None) -> Family:
    return _default.histogram(name, help, buckets)


def snapshot(include_buckets: bool = False) -> Dict[str, Any]:
    return _default.snapshot(include_buckets=include_buckets)


def prometheus_text() -> str:
    return _default.prometheus_text()


def reset_all() -> None:
    _default.reset()


# flat stat compatibility surface (forwarded to by profiler/monitor.py)

def stat(name: str) -> Stat:
    return _default.stat(name)


def stat_add(name: str, n: _Number = 1) -> None:
    _default.stat(name).add(n)


def stat_set(name: str, v: _Number) -> None:
    _default.stat(name).set(v)


def stat_get(name: str) -> _Number:
    return _default.stat(name).get()


def stats_snapshot() -> Dict[str, _Number]:
    return _default.stats_snapshot()


def stats_reset() -> None:
    _default.reset()
