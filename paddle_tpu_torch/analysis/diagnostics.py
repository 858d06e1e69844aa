"""Structured findings and the channel that routes them.

The port's copy of what the channel needs from
``paddle_tpu/analysis/jaxpr_lint.py``: :class:`Diagnostic` (``:42-69``),
:class:`GraphLintError` (``:72-80``), the severities, :func:`analysis_mode`
(``:790``) and :func:`emit` (``:799-825``), with JAX's formats, so a
finding prints the same line in both packages. The jaxpr walker and its
rules stay in the JAX package.
"""

from __future__ import annotations

import sys
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

__all__ = ["Diagnostic", "GraphLintError", "emit", "analysis_mode",
           "ERROR", "WARNING", "INFO"]

ERROR = "error"
WARNING = "warning"
INFO = "info"


@dataclass
class Diagnostic:
    """One structured finding: rule id, severity, message, source
    location and fix hint."""

    rule: str                 # stable id, e.g. "O001"
    name: str                 # human slug, e.g. "recompile-churn"
    severity: str             # error | warning | info
    message: str
    source: str = ""          # "file.py:123 (fn)" or "file.py:123"
    hint: str = ""
    where: str = ""           # surrounding context, e.g. "serving.decode"

    def format(self) -> str:
        loc = f" at {self.source}" if self.source else ""
        ctx = f" [{self.where}]" if self.where else ""
        tail = f" — hint: {self.hint}" if self.hint else ""
        return (f"[{self.severity}] {self.rule}/{self.name}{ctx}: "
                f"{self.message}{loc}{tail}")

    def to_json(self) -> Dict[str, str]:
        return {"rule": self.rule, "name": self.name,
                "severity": self.severity, "message": self.message,
                "source": self.source, "hint": self.hint,
                "where": self.where}

    def __str__(self) -> str:
        return self.format()


class GraphLintError(RuntimeError):
    """Raised by :func:`emit` in error mode when error-severity
    diagnostics are present."""

    def __init__(self, diagnostics: Sequence[Diagnostic]):
        self.diagnostics = list(diagnostics)
        super().__init__(
            "static analysis found "
            f"{sum(1 for d in self.diagnostics if d.severity == ERROR)} "
            "error(s):\n" + "\n".join(d.format() for d in self.diagnostics))


def analysis_mode() -> str:
    """Current ``FLAGS_static_analysis`` mode: off | warn | error."""
    from ..core import flags
    try:
        return str(flags.flag("static_analysis"))
    except KeyError:
        return "off"


def emit(diagnostics: Sequence[Diagnostic], where: str = "",
         mode: Optional[str] = None) -> List[Diagnostic]:
    """Route diagnostics per ``FLAGS_static_analysis``.

    off: return silently. warn: print every diagnostic to stderr (and
    ``warnings.warn`` the errors). error: raise :class:`GraphLintError`
    when any error-severity diagnostic is present, warn otherwise.
    """
    mode = mode or analysis_mode()
    if mode == "off" or not diagnostics:
        return list(diagnostics)
    for d in diagnostics:
        if where and not d.where:
            d.where = where
    errors = [d for d in diagnostics if d.severity == ERROR]
    if mode == "error" and errors:
        raise GraphLintError(list(diagnostics))
    for d in diagnostics:
        print(d.format(), file=sys.stderr)
    if errors:
        warnings.warn(
            f"static analysis: {len(errors)} error-severity finding(s) "
            f"in {where or 'graph'} (FLAGS_static_analysis=warn)",
            stacklevel=2)
    return list(diagnostics)
