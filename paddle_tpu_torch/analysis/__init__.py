"""paddle_tpu_torch.analysis — the diagnostics channel
(``paddle_tpu/analysis`` counterpart, so far :mod:`.diagnostics` only).

The JAX package's jaxpr, Pallas and HLO rules are not ported; the channel
they report through is: :class:`~.diagnostics.Diagnostic` records, routed
by :func:`~.diagnostics.emit` under ``FLAGS_static_analysis``. The
runtime telemetry's rules (O001, the recompile sentinel; O002, the HBM
plan check) and the serving engine's F003 use it."""

from .diagnostics import (ERROR, INFO, WARNING, Diagnostic,  # noqa: F401
                          GraphLintError, analysis_mode, emit)

__all__ = ["Diagnostic", "GraphLintError", "analysis_mode", "emit",
           "ERROR", "WARNING", "INFO"]
