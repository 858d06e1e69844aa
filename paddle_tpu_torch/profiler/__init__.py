"""paddle_tpu_torch.profiler (``paddle_tpu/profiler`` counterpart).

So far :mod:`.monitor` only: the ``stat_*`` shim over
:mod:`paddle_tpu_torch.observability.metrics`, ``get_logger`` and
``StatsReporter``. The windowed ``Profiler`` (scheduler states, chrome
export) is not ported; ``torch.profiler`` captures the card, and the
telemetry's spans show inside it as ``record_function`` ranges.
"""

from . import monitor  # noqa: F401

__all__ = ["monitor"]
