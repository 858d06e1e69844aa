"""Monitor counters — forwarding shim over ``observability.metrics``
(``paddle_tpu/profiler/monitor.py``, ported as it is).

The ``stat_*`` surface forwards to :mod:`paddle_tpu_torch.observability.
metrics` unchanged, so old call sites and the telemetry series share one
registry; :func:`get_logger` is the rank-tagged logger and
:class:`StatsReporter` a periodic counter dump. Counters are host-side
tallies that read no device value.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
from typing import Dict, Union

from ..observability import metrics as _metrics

__all__ = ["stat", "stat_add", "stat_set", "stat_get", "stats_snapshot",
           "stats_reset", "get_logger"]

_Number = Union[int, float]

# Old name for the registry's flat-stat series (supports add/set/get/reset).
StatValue = _metrics.Stat


def stat(name: str) -> StatValue:
    """The named counter (created on first use)."""
    return _metrics.stat(name)


def stat_add(name: str, n: _Number = 1) -> None:
    _metrics.stat_add(name, n)


def stat_set(name: str, v: _Number) -> None:
    _metrics.stat_set(name, v)


def stat_get(name: str) -> _Number:
    return _metrics.stat_get(name)


def stats_snapshot() -> Dict[str, _Number]:
    return _metrics.stats_snapshot()


def stats_reset() -> None:
    _metrics.stats_reset()


# -- rank-aware logging (ref fleet/utils/log_util.py LoggerFactory) ---------

_loggers: Dict[str, logging.Logger] = {}
_loggers_mu = threading.Lock()


def get_logger(name: str = "paddle_tpu_torch",
               level: int = logging.INFO):
    """Per-process logger tagged with the trainer rank; when the launcher
    set PADDLE_LOG_DIR the stream also tees into ``<dir>/<name>.rank<N>.log``
    (stdout already lands in the launcher's workerlog.N).

    Calling again with a different `level` re-levels the cached logger."""
    with _loggers_mu:
        cached = _loggers.get(name)
        if cached is not None:
            cached.setLevel(level)
            return cached
        rank = os.environ.get("PADDLE_TRAINER_ID", "0")
        logger = logging.getLogger(name)
        logger.setLevel(level)
        logger.propagate = False
        fmt = logging.Formatter(
            f"%(asctime)s [rank {rank}] %(levelname)s %(name)s: %(message)s")
        if not logger.handlers:  # logging.getLogger returns a singleton
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(fmt)
            logger.addHandler(h)
            log_dir = os.environ.get("PADDLE_LOG_DIR")
            if log_dir:
                os.makedirs(log_dir, exist_ok=True)
                fh = logging.FileHandler(
                    os.path.join(log_dir, f"{name}.rank{rank}.log"))
                fh.setFormatter(fmt)
                logger.addHandler(fh)
        _loggers[name] = logger
        return logger


class StatsReporter:
    """Periodic counter dump (one line per interval) for long jobs."""

    def __init__(self, interval: float = 60.0, logger=None):
        self.interval = interval
        self.logger = logger or get_logger("paddle_tpu_torch.monitor")
        self._stop = threading.Event()
        # _mu orders concurrent start()/stop(): without it two racing
        # start() calls both observe "not alive" and spawn two reporter
        # loops, and stop() can join a handle start() is replacing
        self._mu = threading.Lock()
        self._thread = None

    def start(self):
        with self._mu:
            if self._thread is not None and self._thread.is_alive():
                return self  # idempotent
            self._stop.clear()  # restartable after stop()

            def loop():
                while not self._stop.wait(self.interval):
                    snap = stats_snapshot()
                    if snap:
                        self.logger.info("stats %s", snap)
            self._thread = threading.Thread(target=loop, daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        with self._mu:
            th, self._thread = self._thread, None
        if th:
            th.join(timeout=2.0)
