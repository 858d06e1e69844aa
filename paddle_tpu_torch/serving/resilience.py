"""Serving resilience: deadlines, bounded admission, load shedding and the
exactly-once request journal (``paddle_tpu/serving/resilience.py``
counterpart; standard library and numpy only).

- **Typed rejection** (:class:`Rejected`): the 429-style answer to an
  over-budget submission. Bounded admission (``max_waiting`` on the
  scheduler, ``max_spilled_bytes`` on the engine) turns an ever-growing
  queue into an explicit refusal.
- **Load shedding** (:class:`ShedPolicy`): when free KV blocks or the
  rolling p99 decode time cross thresholds, the engine sheds the
  lowest-priority, youngest work (waiting first, then running), one
  request an iteration, and in ``degrade`` mode also shrinks the active
  decode bucket so the survivors' per-token latency recovers.
- **Exactly-once journal** (:class:`RequestJournal`): fsynced JSONL of
  admitted-request state. A submission is journaled before any device
  work; an acknowledgment (``done`` with the output tokens, or a terminal
  ``rejected``/``failed``/``expired``/``shed``) is journaled before the
  response leaves the engine, so a relaunched engine replays exactly the
  submitted-but-unacknowledged requests.

Everything here is host-side policy. The journal's appends hold a plain
``threading.Lock`` where the JAX package takes its concurrency checker's
lock.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence as Seq, Set

import numpy as np

__all__ = ["Rejected", "ShedPolicy", "RequestJournal", "prompt_hash"]


def prompt_hash(prompt_ids) -> str:
    """Content hash of a prompt's token stream (sha1 over the int32
    bytes, truncated). Journaled with every submission so a relaunched
    engine can (a) verify the replay trace still carries the tokens the
    journal admitted and (b) group replayed requests by shared prefix —
    identical-prompt-prefix requests submitted adjacently re-attach to
    the radix tree's surviving pages instead of re-prefilling cold."""
    ids = np.asarray(prompt_ids, np.int32).reshape(-1)
    return hashlib.sha1(ids.tobytes()).hexdigest()[:16]


@dataclass(frozen=True)
class Rejected:
    """Typed admission refusal (the HTTP-429 of the engine): the request
    was never admitted, holds no blocks, and will not produce tokens.
    ``reason`` is machine-readable (``queue_full`` / ``spill_budget``);
    ``detail`` is the human sentence."""

    rid: str
    reason: str
    detail: str = ""

    def __bool__(self) -> bool:  # never truthy-confused with a Sequence
        return False


@dataclass
class ShedPolicy:
    """Overload detection + what to do about it.

    The engine consults :meth:`overloaded` once per scheduler iteration
    with the paged pool's free-block fraction and the rolling p99 of the
    last ``window`` decode-iteration wall times. While overloaded the
    engine (a) pauses fresh admissions, (b) sheds one
    lowest-priority/youngest request per iteration
    (``FCFSScheduler.shed_candidate``), and (c) with ``degrade=True``
    shrinks the active decode bucket one rung (preempting the youngest
    residents through the normal LIFO spill path) so the survivors'
    iteration time drops. In degrade mode only *waiting* work (fresh or
    preempted) is shed — residents are squeezed, never dropped; with
    ``degrade=False`` shedding may drop running work to free blocks.
    """

    min_free_block_frac: float = 0.0       # shed below this free fraction
    max_p99_decode_ms: Optional[float] = None  # shed above this decode p99
    window: int = 64                       # rolling decode-time window
    degrade: bool = False                  # also shrink the decode bucket

    def overloaded(self, free_frac: float,
                   p99_decode_ms: Optional[float]) -> Optional[str]:
        """The reason string when a threshold is crossed, else None."""
        if free_frac < self.min_free_block_frac:
            return (f"free KV blocks {free_frac:.3f} < "
                    f"{self.min_free_block_frac:.3f} of pool")
        if (self.max_p99_decode_ms is not None
                and p99_decode_ms is not None
                and p99_decode_ms > self.max_p99_decode_ms):
            return (f"p99 decode {p99_decode_ms:.2f}ms > "
                    f"{self.max_p99_decode_ms:.2f}ms")
        return None


# ---------------------------------------------------------------------------
# Exactly-once request journal
# ---------------------------------------------------------------------------

#: Journal events that acknowledge a request (the client got an answer —
#: tokens or a terminal refusal). A relaunch must NOT replay these.
ACK_EVENTS = ("done", "rejected", "failed", "expired", "shed")


class RequestJournal:
    """Fsynced JSONL journal of admitted-request state for exactly-once
    serving across process deaths.

    One JSON object per line; every append is flushed **and fsynced**
    before the call returns, mirroring the fault injector's fired-event
    journal — a SIGKILL immediately after an acknowledgment cannot lose
    it. Events:

    - ``{"event": "launch"}`` — one per engine incarnation (restart
      counting);
    - ``{"event": "submitted", "rid", "prompt", "max_new_tokens", ...}``
      — admitted-request state, enough to reconstruct the Request;
    - ``{"event": "done", "rid", "tokens"}`` — the output was committed;
    - ``{"event": "rejected"|"failed"|"expired"|"shed", "rid",
      "reason"}`` — a terminal non-success answer.

    :meth:`pending_rids` is the replay set: submitted (or expected) but
    not acknowledged. :meth:`exactly_once_report` is the drill's verdict.
    """

    def __init__(self, path: str):
        self.path = path
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        # append = write + flush + fsync + in-memory mirror as ONE unit:
        # concurrent ackers (a multi-threaded engine, the churn tests)
        # must never interleave half-lines or reorder an ack against its
        # fsync
        self._mu = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        self._events.append(json.loads(line))
                    except ValueError:
                        # a torn tail line from a mid-append kill: the
                        # event it described was never acknowledged
                        break
        self._f = open(path, "a")

    # -- append side (fsync before return) ----------------------------------

    def append(self, event: str, **payload: Any) -> None:
        rec = {"event": event, **payload}
        with self._mu:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
            # serializing the fsync IS the exactly-once contract: the
            # ack must be durable before append returns
            os.fsync(self._f.fileno())
            self._events.append(rec)

    def launch(self) -> None:
        self.append("launch")

    def submitted(self, request) -> None:
        self.append("submitted", rid=request.rid,
                    prompt=[int(t) for t in request.prompt_ids],
                    prompt_sha=prompt_hash(request.prompt_ids),
                    max_new_tokens=int(request.max_new_tokens),
                    eos_token_id=request.eos_token_id,
                    deadline_s=request.deadline_s,
                    priority=int(request.priority))

    def done(self, rid: str, tokens: Seq[int]) -> None:
        self.append("done", rid=rid, tokens=[int(t) for t in tokens])

    def terminal(self, rid: str, outcome: str, reason: str = "") -> None:
        if outcome not in ACK_EVENTS:
            raise ValueError(f"not a terminal outcome: {outcome!r}")
        self.append(outcome, rid=rid, reason=reason)

    def close(self) -> None:
        self._f.close()

    # -- read side -----------------------------------------------------------

    def events(self) -> List[Dict[str, Any]]:
        with self._mu:
            return list(self._events)

    @property
    def n_launches(self) -> int:
        return sum(1 for e in self._events if e["event"] == "launch")

    def acknowledged_rids(self) -> Set[str]:
        return {e["rid"] for e in self._events if e["event"] in ACK_EVENTS}

    def ack_outcomes(self) -> Dict[str, str]:
        """rid -> first acknowledged outcome (``done`` or a terminal
        refusal kind) — the exact ack mix the live fleet goodput must
        reproduce at drill end."""
        out: Dict[str, str] = {}
        for e in self._events:
            if e["event"] in ACK_EVENTS and e["rid"] not in out:
                out[e["rid"]] = e["event"]
        return out

    def submitted_rids(self) -> Set[str]:
        return {e["rid"] for e in self._events if e["event"] == "submitted"}

    def pending_rids(self, expected: Optional[Seq[str]] = None) -> List[str]:
        """Rids a relaunched engine must replay: everything in
        ``expected`` (or, without it, everything ever submitted) that was
        never acknowledged — in first-seen order."""
        acked = self.acknowledged_rids()
        if expected is not None:
            return [r for r in expected if r not in acked]
        seen: List[str] = []
        for e in self._events:
            if (e["event"] == "submitted" and e["rid"] not in acked
                    and e["rid"] not in seen):
                seen.append(e["rid"])
        return seen

    def prompt_hashes(self) -> Dict[str, str]:
        """rid -> journaled prompt content hash (first submitted record
        wins) — the replay-integrity and prefix-regrouping input."""
        out: Dict[str, str] = {}
        for e in self._events:
            if e["event"] == "submitted" and "prompt_sha" in e \
                    and e["rid"] not in out:
                out[e["rid"]] = e["prompt_sha"]
        return out

    def done_outputs(self) -> Dict[str, List[int]]:
        """rid -> output tokens of the FIRST done record (duplicates are
        a drill failure surfaced by :meth:`exactly_once_report`)."""
        out: Dict[str, List[int]] = {}
        for e in self._events:
            if e["event"] == "done" and e["rid"] not in out:
                out[e["rid"]] = list(e["tokens"])
        return out

    def exactly_once_report(self, expected_rids: Seq[str]
                            ) -> Dict[str, Any]:
        """The drill verdict: every expected rid acknowledged exactly
        once — ``lost`` (no ack) and ``duplicated`` (>1 ack) must both be
        empty."""
        acks: Dict[str, int] = {}
        for e in self._events:
            if e["event"] in ACK_EVENTS:
                acks[e["rid"]] = acks.get(e["rid"], 0) + 1
        lost = [r for r in expected_rids if r not in acks]
        duplicated = sorted(r for r, n in acks.items() if n > 1)
        return {"expected": len(expected_rids), "acknowledged": len(acks),
                "lost": lost, "duplicated": duplicated,
                "launches": self.n_launches,
                "exactly_once": not lost and not duplicated}
