"""Fire points: named seams where a test or a drill injects a fault
(``paddle_tpu/fault/injection.py:65-95`` counterpart).

Production code calls :func:`fire` unconditionally; with nothing
registered it is a dict lookup and a return. A registered callback runs
in the caller's frame, so what it raises propagates there as it is: the
serving engine's ``serve.mid_spill`` seam (inside
:meth:`~paddle_tpu_torch.serving.paged_cache.PagedKVCache.spill`) and
``serve.mid_decode`` (after a decode or verify step's compute, before any
of its tokens is committed) are the two seams so far.

Only the fire points are ported. The deterministic kill schedule
(``FaultEvent``, ``FaultPlan``, ``check_plan``), the in-process trigger
``FaultInjector`` with its fsynced ``fired.json``, ``FAULT_KINDS`` and
``PREEMPTION_EXIT_CODE`` wait for the fault tier (ROADMAP Queue 1 item 9),
with the subprocess serve drill that needs them.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

__all__ = ["fire", "register_fire_point", "clear_fire_points"]

_fire_points: Dict[str, Callable[[], None]] = {}
_fire_lock = threading.Lock()


def register_fire_point(name: str, fn: Optional[Callable[[], None]]) -> None:
    """Install (or with ``None`` remove) the callback behind a named
    seam."""
    with _fire_lock:
        if fn is None:
            _fire_points.pop(name, None)
        else:
            _fire_points[name] = fn


def clear_fire_points() -> None:
    with _fire_lock:
        _fire_points.clear()


def fire(name: str) -> None:
    """Run the callback registered for ``name`` (a no-op otherwise)."""
    with _fire_lock:
        fn = _fire_points.get(name)
    if fn is not None:
        fn()
