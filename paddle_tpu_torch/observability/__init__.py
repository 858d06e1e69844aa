"""paddle_tpu_torch.observability — always-on runtime telemetry
(``paddle_tpu/observability`` counterpart).

The training and serving hot paths carry a low-overhead measurement layer,
gated by ``FLAGS_telemetry`` = ``off`` | ``metrics`` (default) | ``trace``:

- :mod:`.metrics` — labeled counters/gauges/log-bucket histograms with
  Prometheus-text and JSON exposition; the ``profiler.monitor`` flat stat
  surface forwards here.
- :mod:`.trace` — thread-safe nestable ``span()`` context managers
  buffering into an in-memory ring, exported as chrome-trace JSON or
  JSONL (``FLAGS_telemetry=trace`` only); each span is also a
  ``torch.profiler.record_function`` range.
- :mod:`.request_timeline` — the serving engine's per-request phase
  accounting (queue/prefill/decode/detokenize, exact-value p50/p99),
  feeding the ``serving.*`` metric families.
- :mod:`.step_monitor` — the :class:`StepTimeline` (per-step phases), the
  recompile sentinel (Diagnostic O001 with the exact shape/dtype diff when
  a callable churns signatures), and HBM watermarks from
  ``torch.cuda.memory_stats`` (O002 against a static plan).
- :mod:`.flight_recorder` — the crash-persistent tier
  (``FLAGS_flight_recorder=off|on``): an mmap-backed ring of CRC-framed
  records per process incarnation, in the JAX package's file format.

Wiring: ``framework.sharded.TrainStep``, ``io.dataloader``, ``hapi`` and
``serving`` report into the process-wide timelines
(``step_monitor.current()``, ``request_timeline.current()``). JAX's live
fleet exporter, its alert rules and its fleet aggregator (``live``,
``alerts``, ``fleet``) are not ported.
"""

from . import metrics  # noqa: F401
from . import trace  # noqa: F401
from . import flight_recorder  # noqa: F401
from . import step_monitor  # noqa: F401
from . import request_timeline  # noqa: F401
from .trace import span, telemetry_mode  # noqa: F401
from .step_monitor import (StepTimeline, RecompileSentinel,  # noqa: F401
                           current, reset_default, instrument_jitted,
                           fingerprint, fingerprint_diff)
from .request_timeline import RequestTimeline  # noqa: F401
from .flight_recorder import FlightRecorder  # noqa: F401

__all__ = [
    "metrics", "trace", "step_monitor", "request_timeline",
    "flight_recorder",
    "span", "telemetry_mode",
    "StepTimeline", "RecompileSentinel", "RequestTimeline",
    "FlightRecorder",
    "current", "reset_default",
    "instrument_jitted", "fingerprint", "fingerprint_diff",
]
