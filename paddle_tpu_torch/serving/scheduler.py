"""Continuous-batching scheduler: iteration-level request admission.

A copy of ``paddle_tpu/serving/scheduler.py`` (numpy only; the port imports
nothing of the JAX package). The port's engine drives it on the reference's
flag-off path; the fields and hooks of the later tiers (prefix sharing,
chunked prefill, speculative decoding, resilience) are kept so the copy
stays the reference's state machine.

Orca's (OSDI'22) observation, applied here: a serving batch must be
re-formed at *token-iteration* granularity, not request granularity —
a static batch runs at the speed of its longest member and admits new
work only at batch boundaries, while iteration-level scheduling admits a
request the moment a decode slot and KV blocks are free, and retires a
sequence the token it finishes. The policy is FCFS with LIFO preemption
(vLLM's default): requests are admitted in arrival order, and when the
block pool runs dry the *youngest* running sequence is preempted (its KV
spilled to host) — the one with the least sunk prefill work and the
shortest spill payload — then resumed, at the front of the queue, when
capacity returns.

Resilience semantics (the overload half of the Orca/vLLM story) live in
the same state machine: the waiting deque can be **bounded**
(``max_waiting`` — the engine answers over-budget submissions with a
typed ``Rejected`` (the reference's resilience tier) instead of
growing the queue forever), every request can carry a **deadline** and a
**priority**, and three more terminal states exist beyond ``FINISHED``:
``EXPIRED`` (deadline passed — cancelled at iteration granularity),
``SHED`` (dropped by the overload policy), and ``FAILED`` (a
per-request device/capacity error isolated to that request). Victim
selection for both preemption and shedding is lowest-priority-first with
the original LIFO (youngest) tie-break, so equal-priority traffic
behaves exactly as before.

This module is pure host-side bookkeeping (queues and state machines);
the engine executes the device work and reports back. Everything is
deterministic under a fixed submission order — no wall-clock policy
inputs — which the block-assignment regression test pins.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from collections import deque

__all__ = ["Request", "Sequence", "Status", "FCFSScheduler",
           "TERMINAL_STATUSES"]


class Status(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    PREEMPTED = "preempted"
    FINISHED = "finished"
    EXPIRED = "expired"      # deadline passed; cancelled, blocks reclaimed
    SHED = "shed"            # dropped by the overload policy
    FAILED = "failed"        # per-request error, isolated from the loop


#: Terminal states a sequence can end in (everything but the three live
#: queue states). ``finished`` holds all of them, in retirement order.
TERMINAL_STATUSES = frozenset(
    {Status.FINISHED, Status.EXPIRED, Status.SHED, Status.FAILED})


@dataclass
class Request:
    """One client request: a prompt and a generation budget."""

    rid: str
    prompt_ids: np.ndarray          # [prompt_len] int32
    max_new_tokens: int
    eos_token_id: Optional[int] = None
    arrival_s: float = 0.0          # offset into the trace (replay traces)
    deadline_s: Optional[float] = None  # SLO: finish within this of submit
    priority: int = 0               # higher = kept longer under overload

    def __post_init__(self):
        self.prompt_ids = np.asarray(self.prompt_ids, np.int32).reshape(-1)
        if self.prompt_ids.size < 1:
            raise ValueError(f"request {self.rid!r}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.rid!r}: max_new_tokens "
                             f"{self.max_new_tokens}")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(f"request {self.rid!r}: deadline_s "
                             f"{self.deadline_s}")


@dataclass
class Sequence:
    """Runtime state of one request inside the engine."""

    request: Request
    status: Status = Status.WAITING
    ctx_len: int = 0                     # tokens committed to KV
    out_tokens: List[int] = field(default_factory=list)
    block_ids: List[int] = field(default_factory=list)
    host_kv: Any = None                  # spilled KV while PREEMPTED
    spilled_bytes: int = 0               # host bytes held while PREEMPTED
    preemptions: int = 0
    # -- prefix sharing (FLAGS_serve_prefix_cache) ------------------------
    # the first n_shared_blocks of block_ids are copy-on-write tree pages
    # (one allocator ref held per attached sequence); prefix_nodes is the
    # matching trie chain. Both stay empty on the private-KV path.
    n_shared_blocks: int = 0
    prefix_nodes: List[Any] = field(default_factory=list)
    # -- chunked prefill (FLAGS_serve_chunked_prefill) --------------------
    # prompt tokens whose KV is committed; the one-shot path jumps this
    # straight to prompt_len inside _prefill.
    prefill_pos: int = 0
    # -- speculative decoding (FLAGS_serve_speculative) -------------------
    host_draft_kv: Any = None            # drafter-pool mirror of host_kv
    draft_ctx: int = 0                   # tokens with drafter KV written
    error: Optional[str] = None          # reason for a non-FINISHED ending
    # every block id ever assigned, in grant order (spill boundaries as
    # -1): the determinism regression's witness
    block_log: List[int] = field(default_factory=list)
    # phase accounting (engine-stamped, seconds). ``t_submit`` is the TRUE
    # arrival time and is never rewritten; ``t_requeue`` restarts the
    # queue-phase clock on preemption so end-to-end latency (and the
    # deadline check) still measure from submission.
    t_submit: float = 0.0
    t_requeue: Optional[float] = None
    t_first_token: Optional[float] = None
    # the port's own: when the request reached its terminal state (the
    # reference's request timeline takes this time; the port keeps it on
    # the sequence for the SLO arithmetic)
    t_done: Optional[float] = None
    phase_s: Dict[str, float] = field(default_factory=dict)

    @property
    def rid(self) -> str:
        return self.request.rid

    @property
    def t_enqueue(self) -> float:
        """Start of the current wait span: the last preemption requeue if
        one happened, else the original submission."""
        return self.t_requeue if self.t_requeue is not None else self.t_submit

    @property
    def prompt_len(self) -> int:
        return int(self.request.prompt_ids.size)

    @property
    def n_generated(self) -> int:
        return len(self.out_tokens)

    def add_phase(self, name: str, dur_s: float) -> None:
        self.phase_s[name] = self.phase_s.get(name, 0.0) + dur_s

    def is_finished_by(self, token: int) -> bool:
        eos = self.request.eos_token_id
        return ((eos is not None and token == eos) or
                self.n_generated >= self.request.max_new_tokens)

    def full_output(self) -> np.ndarray:
        return np.concatenate([self.request.prompt_ids,
                               np.asarray(self.out_tokens, np.int32)])


class FCFSScheduler:
    """Arrival-order admission, LIFO preemption, iteration batches.

    ``max_waiting`` bounds the waiting deque: :meth:`can_accept` is the
    admission-control gate the engine consults before :meth:`submit` —
    when full, the engine answers with a typed ``Rejected`` (429-style
    backpressure) instead of queueing unboundedly. ``None`` keeps the
    historical unbounded behavior.
    """

    def __init__(self, max_batch: int, max_waiting: Optional[int] = None):
        if max_batch < 1:
            raise ValueError(f"max_batch {max_batch}")
        if max_waiting is not None and max_waiting < 1:
            raise ValueError(f"max_waiting {max_waiting}")
        self.max_batch = int(max_batch)
        self.max_waiting = None if max_waiting is None else int(max_waiting)
        self.waiting: Deque[Sequence] = deque()
        self.running: List[Sequence] = []   # admission order
        self.finished: List[Sequence] = []

    # -- queue transitions ---------------------------------------------------

    def can_accept(self) -> bool:
        """Room in the bounded waiting queue (preempted residents do not
        count against it — they were already admitted once)."""
        if self.max_waiting is None:
            return True
        fresh = sum(1 for s in self.waiting if s.status is Status.WAITING)
        return fresh < self.max_waiting

    def submit(self, seq: Sequence) -> None:
        seq.status = Status.WAITING
        self.waiting.append(seq)

    def peek_waiting(self) -> Optional[Sequence]:
        return self.waiting[0] if self.waiting else None

    def has_capacity(self) -> bool:
        return len(self.running) < self.max_batch

    def admit(self, seq: Sequence) -> None:
        assert self.waiting and self.waiting[0] is seq, \
            "admission must be FCFS (engine admitted out of order)"
        self.waiting.popleft()
        seq.status = Status.RUNNING
        self.running.append(seq)

    def preempt_victim(self, exclude: Optional[Sequence] = None,
                       cost=None) -> Optional[Sequence]:
        """Lowest-priority running sequence other than ``exclude``,
        youngest (LIFO) within a priority class — with the default
        priority 0 everywhere this is exactly the historical LIFO pick.

        ``cost`` (optional, ``seq -> int``) is the prefix-sharing cost
        model: the number of **private** (refcount-1) blocks a
        preemption would actually free. When given, the pick within a
        priority class is the sequence freeing the MOST private blocks
        (tie-broken by the original LIFO order) — preempting a cheap
        prefix-sharer relieves almost nothing while re-queueing its
        work, so the expensive private-KV hog goes first. ``cost=None``
        (the flag-off path) is bitwise-identical to the historical
        behavior."""
        best: Optional[Sequence] = None
        best_cost = -1
        for seq in reversed(self.running):      # youngest first
            if seq is exclude:
                continue
            if best is None or seq.request.priority < best.request.priority:
                best = seq
                best_cost = cost(seq) if cost is not None else 0
            elif (cost is not None
                  and seq.request.priority == best.request.priority
                  and cost(seq) > best_cost):
                best = seq
                best_cost = cost(seq)
        return best

    def shed_candidate(self, waiting_only: bool = False,
                       cost=None) -> Optional[Sequence]:
        """The cheapest work to drop under overload: lowest priority,
        youngest within the class; waiting work first (no or least sunk
        device work), then — unless ``waiting_only`` (degrade mode keeps
        residents and shrinks their bucket instead) — running. With the
        prefix-sharing ``cost`` model (private blocks held), the pick
        within a priority class prefers the sequence whose drop frees
        the most private blocks — shedding a prefix-sharer frees almost
        nothing. ``cost=None`` keeps the historical order bitwise."""
        pools = [list(self.waiting)]
        if not waiting_only:
            pools.append(self.running)
        for pool in pools:
            if pool:
                if cost is None:
                    # max t_submit = youngest
                    return min(pool, key=lambda s: (s.request.priority,
                                                    -s.t_submit))
                return min(pool, key=lambda s: (s.request.priority,
                                                -cost(s), -s.t_submit))
        return None

    def preempt(self, seq: Sequence) -> None:
        self.running.remove(seq)
        seq.status = Status.PREEMPTED
        seq.preemptions += 1
        # Front of the queue: the preempted sequence has sunk work and,
        # under FCFS, arrived before everything still waiting.
        self.waiting.appendleft(seq)

    def finish(self, seq: Sequence) -> None:
        self.retire(seq, Status.FINISHED)

    def retire(self, seq: Sequence, status: Status) -> None:
        """Move ``seq`` from whichever live queue holds it into a terminal
        state — the one exit used by normal completion, deadline expiry,
        load shedding, and per-request failure isolation alike."""
        if status not in TERMINAL_STATUSES:
            raise ValueError(f"retire to non-terminal status {status}")
        if seq in self.running:
            self.running.remove(seq)
        else:
            try:
                self.waiting.remove(seq)
            except ValueError:
                pass  # already out of both queues (e.g. failed mid-admit)
        seq.status = status
        self.finished.append(seq)

    # -- iteration view ------------------------------------------------------

    def iteration_batch(self) -> List[Sequence]:
        """The sequences decoding this iteration, in admission order."""
        return list(self.running)

    @property
    def n_pending(self) -> int:
        return len(self.waiting) + len(self.running)

    def assert_idle(self) -> None:
        if self.waiting or self.running:
            raise RuntimeError(
                f"scheduler not drained: {len(self.waiting)} waiting, "
                f"{len(self.running)} running")
