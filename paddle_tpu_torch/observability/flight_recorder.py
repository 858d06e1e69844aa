"""Crash-persistent per-process flight recorder (the "black box").

The port of ``paddle_tpu/observability/flight_recorder.py``, byte for byte
the same file format: a ring one package writes, the other's
:func:`replay` reads. Each process gets a bounded **mmap-backed ring of
CRC-framed binary records** that needs no flush on death: a write into a
``MAP_SHARED`` file mapping lands in the kernel page cache the moment the
copy retires, so a SIGKILL one instruction later cannot lose it (only a
whole-machine crash can).

- **Fixed framing, variable payload.** Every record is one frame:
  ``magic u32 | payload_len u32 | seq u64 | ts f64 | crc u32 | pad`` then
  the JSON payload, zero-padded to 8-byte alignment. The CRC covers the
  header fields *and* the payload, so a frame half-written at death (or
  half-overwritten after a wrap) validates as torn and is skipped.
- **Magic-scan recovery.** The frame magic's bytes are non-ASCII, and
  payloads are ASCII JSON, so the reader re-synchronises anywhere in the
  ring by scanning 8-byte-aligned offsets for the magic: a wrapped ring
  replays as every frame whose CRC still validates, ordered by seq.
- **One file per incarnation**, named by ``(role, replica_id,
  incarnation)`` under a run directory, with the meta (run_id, pid, start
  time) in the header page.

Gating: ``FLAGS_flight_recorder`` (``off`` default / ``on``). Off is
byte-identical on step outputs: every :func:`emit` seam is a None-check
and a flag read.
"""

from __future__ import annotations

import json
import mmap
import os
import re
import struct
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

from ..core.flags import flag

__all__ = [
    "FlightRecorder", "arm", "arm_if_enabled", "disarm", "current",
    "emit", "maybe_metrics", "enabled", "recorder_on", "replay",
    "recorder_files", "next_incarnation", "recorder_path",
    "FILE_MAGIC", "FRAME_MAGIC", "HEADER_SIZE", "DEFAULT_CAPACITY_MB",
]

#: File header magic (first 8 bytes of every recorder file).
FILE_MAGIC = b"PDLFLR01"
#: Frame marker. Little-endian bytes are AB 0F 7E F1 — three of the four
#: are non-ASCII, so an ASCII-JSON payload can never alias a frame start.
FRAME_MAGIC = 0xF17E0FAB
#: Header page: FILE_MAGIC + meta_len u32 + capacity u32 + meta JSON.
HEADER_SIZE = 4096
DEFAULT_CAPACITY_MB = 4

# magic u32 | payload_len u32 | seq u64 | ts f64 | crc u32 | 4 pad bytes
_FRAME = struct.Struct("<IIQdI4x")
_HDR_META = struct.Struct("<II")
_ALIGN = 8

_FILE_RE = re.compile(
    r"^(?P<role>[A-Za-z0-9_\-]+)\.r(?P<replica>\d+)\.i(?P<inc>\d+)\.flr$")


def _align(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def _frame_crc(payload_len: int, seq: int, ts: float, payload: bytes) -> int:
    head = _FRAME.pack(FRAME_MAGIC, payload_len, seq, ts, 0)
    return zlib.crc32(payload, zlib.crc32(head)) & 0xFFFFFFFF


def _new_lock(name: str):
    # JAX's FLAGS_lockcheck seam; the port's locks are plain
    return threading.Lock()


def recorder_path(run_dir: str, role: str, replica_id: int,
                  incarnation: int) -> str:
    return os.path.join(run_dir,
                        f"{role}.r{int(replica_id)}.i{int(incarnation)}.flr")


def next_incarnation(run_dir: str, role: str, replica_id: int) -> int:
    """Smallest unused incarnation index for ``(role, replica_id)`` under
    ``run_dir`` — each process death leaves its file behind, so the
    relaunch picks the next slot."""
    taken = set()
    try:
        names = os.listdir(run_dir)
    except OSError:
        return 0
    for name in names:
        m = _FILE_RE.match(name)
        if m and m.group("role") == role \
                and int(m.group("replica")) == int(replica_id):
            taken.add(int(m.group("inc")))
    return max(taken) + 1 if taken else 0


def recorder_files(run_dir: str) -> List[str]:
    """Every ``*.flr`` under ``run_dir`` (recursive), sorted."""
    out = []
    for dirpath, _dirnames, filenames in os.walk(run_dir):
        for name in filenames:
            if _FILE_RE.match(name):
                out.append(os.path.join(dirpath, name))
    return sorted(out)


class FlightRecorder:
    """One process incarnation's black box.

    All public methods are thread-safe (the watchdog timer thread, the
    checkpoint writer thread and the training loop all record) and never
    raise into the caller's hot path — a full ring wraps, an oversized
    record is dropped and counted.
    """

    def __init__(self, path: str, meta: Dict[str, Any],
                 capacity_bytes: int = DEFAULT_CAPACITY_MB * 2 ** 20):
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self.path = path
        self.meta = dict(meta)
        self.meta.setdefault("pid", os.getpid())
        self.meta.setdefault("start_ts", time.time())
        meta_bytes = json.dumps(self.meta, sort_keys=True,
                                default=str).encode()
        if len(meta_bytes) > HEADER_SIZE - len(FILE_MAGIC) - _HDR_META.size:
            raise ValueError("recorder meta does not fit the header page")
        capacity = max(int(capacity_bytes), HEADER_SIZE + 4096)
        self._mu = _new_lock("FlightRecorder._mu")
        self._seq = 0
        self._off = 0              # next write offset within the ring area
        self._ring = capacity - HEADER_SIZE
        self.dropped = 0
        self._last_stats: Dict[str, Any] = {}
        self._last_metrics_step: Optional[int] = None
        with open(path, "wb") as f:
            f.truncate(capacity)
        self._f = open(path, "r+b")
        self._mm = mmap.mmap(self._f.fileno(), capacity)
        self._mm[:len(FILE_MAGIC)] = FILE_MAGIC
        off = len(FILE_MAGIC)
        self._mm[off:off + _HDR_META.size] = _HDR_META.pack(
            len(meta_bytes), capacity)
        off += _HDR_META.size
        self._mm[off:off + len(meta_bytes)] = meta_bytes

    # -- write side ----------------------------------------------------------

    def record(self, kind: str, /, **fields: Any) -> Optional[int]:
        """Append one record; returns its seq, or None if it was dropped
        (payload larger than the whole ring). Durable against SIGKILL the
        moment this returns — no flush involved."""
        rec = {"k": str(kind)}
        rec.update(fields)
        payload = json.dumps(rec, separators=(",", ":"),
                             default=str).encode()
        total = _align(_FRAME.size + len(payload))
        if total > self._ring:
            with self._mu:
                self.dropped += 1
            return None
        with self._mu:
            seq = self._seq
            self._seq += 1
            if self._off + total > self._ring:
                # zero the tail so a stale magic there can't resurrect a
                # pre-wrap frame whose payload we are about to overwrite
                self._mm[HEADER_SIZE + self._off:
                         HEADER_SIZE + self._ring] = \
                    b"\0" * (self._ring - self._off)
                self._off = 0
            ts = time.time()
            crc = _frame_crc(len(payload), seq, ts, payload)
            frame = _FRAME.pack(FRAME_MAGIC, len(payload), seq, ts, crc) \
                + payload
            frame += b"\0" * (total - len(frame))
            pos = HEADER_SIZE + self._off
            self._mm[pos:pos + total] = frame
            self._off += total
        return seq

    def metrics_delta(self, step: Optional[int] = None,
                      every: int = 1) -> Optional[int]:
        """Record the flat metric snapshot's *changed* entries since the
        last delta — the step-cadence breadcrumb that lets the postmortem
        say what the counters were doing when the process died. With
        ``every > 1`` the call is a no-op unless ``step`` advanced at
        least that far past the previous delta's step."""
        from . import metrics
        with self._mu:
            last = self._last_metrics_step
            if step is not None and last is not None \
                    and every > 1 and step - last < every:
                return None
            self._last_metrics_step = step
        try:
            snap = metrics.stats_snapshot()
        except Exception:
            return None
        with self._mu:
            prev = self._last_stats
            delta = {k: v for k, v in snap.items() if prev.get(k) != v}
            self._last_stats = snap
        if not delta:
            return None
        return self.record("metrics", step=step, delta=delta)

    def close(self) -> None:
        try:
            self._mm.flush()
            self._mm.close()
            self._f.close()
        except (ValueError, OSError):
            pass

    def __repr__(self) -> str:
        return (f"FlightRecorder({self.path!r}, seq={self._seq}, "
                f"dropped={self.dropped})")


# ---------------------------------------------------------------------------
# Process-wide recorder + gated emit seams
# ---------------------------------------------------------------------------

_proc: Optional[FlightRecorder] = None
_proc_mu = threading.Lock()

#: How many steps between metric-snapshot delta records (the per-step
#: phase commit is cheap; walking the whole registry is not).
METRICS_EVERY = 8


def recorder_on() -> bool:
    """Current ``FLAGS_flight_recorder`` gate."""
    try:
        return str(flag("flight_recorder")) == "on"
    except KeyError:  # core.flags not initialized (partial import)
        return False


def current() -> Optional[FlightRecorder]:
    return _proc


def enabled() -> bool:
    return _proc is not None and recorder_on()


def emit(kind: str, /, **fields: Any) -> Optional[int]:
    """The wiring seam production code calls unconditionally: a global
    read + None-check when nothing is armed, a flag read when it is, and
    never an exception into the caller."""
    rec = _proc
    if rec is None or not recorder_on():
        return None
    try:
        return rec.record(kind, **fields)
    except Exception:
        return None


def maybe_metrics(step: Optional[int] = None) -> Optional[int]:
    """Step-cadence metric-snapshot delta (every :data:`METRICS_EVERY`
    steps, plus the first call)."""
    rec = _proc
    if rec is None or not recorder_on():
        return None
    try:
        return rec.metrics_delta(step, every=METRICS_EVERY)
    except Exception:
        return None


def arm(run_dir: str, role: str, replica_id: int = 0,
        run_id: Optional[str] = None, incarnation: Optional[int] = None,
        capacity_bytes: Optional[int] = None,
        meta: Optional[Dict[str, Any]] = None) -> FlightRecorder:
    """Open this process's recorder file under ``run_dir`` and attach it
    as the process recorder :func:`emit` feeds. Incarnation defaults to
    the next unused slot for ``(role, replica_id)``."""
    global _proc
    if capacity_bytes is None:
        try:
            capacity_bytes = int(flag("flight_recorder_mb")) * 2 ** 20
        except KeyError:
            capacity_bytes = DEFAULT_CAPACITY_MB * 2 ** 20
    os.makedirs(run_dir, exist_ok=True)
    with _proc_mu:
        prev, _proc = _proc, None
    if prev is not None:  # re-arming replaces (and closes) the old box
        prev.close()
    with _proc_mu:
        if incarnation is None:
            incarnation = next_incarnation(run_dir, role, replica_id)
        full_meta = {"run_id": run_id or os.path.basename(
                         os.path.abspath(run_dir)),
                     "role": str(role), "replica_id": int(replica_id),
                     "incarnation": int(incarnation)}
        full_meta.update(meta or {})
        rec = FlightRecorder(
            recorder_path(run_dir, role, replica_id, incarnation),
            full_meta, capacity_bytes=capacity_bytes)
        _proc = rec
    return rec


def arm_if_enabled(run_dir: str, role: str, replica_id: int = 0,
                   **kwargs: Any) -> Optional[FlightRecorder]:
    """:func:`arm` gated on ``FLAGS_flight_recorder=on`` — the one-line
    seam the drill trainers/workers call at incarnation start."""
    if not recorder_on():
        return None
    return arm(run_dir, role, replica_id=replica_id, **kwargs)


def disarm() -> None:
    """Detach (and close) the process recorder — inline drill runs use
    this so a following run in the same process opens a fresh
    incarnation instead of appending to a stale one."""
    global _proc
    with _proc_mu:
        rec, _proc = _proc, None
    if rec is not None:
        rec.close()


# ---------------------------------------------------------------------------
# Read side: replay a (possibly torn, possibly wrapped) recorder file
# ---------------------------------------------------------------------------

def _read_header(buf: bytes) -> Tuple[Dict[str, Any], int]:
    if buf[:len(FILE_MAGIC)] != FILE_MAGIC:
        raise ValueError("not a flight-recorder file (bad magic)")
    off = len(FILE_MAGIC)
    meta_len, capacity = _HDR_META.unpack_from(buf, off)
    off += _HDR_META.size
    meta = json.loads(buf[off:off + meta_len].decode())
    return meta, capacity


def replay(path: str) -> Tuple[Dict[str, Any], List[Dict[str, Any]],
                               Dict[str, Any]]:
    """Scan one recorder file into ``(meta, records, report)``.

    Records are seq-ordered dicts (payload fields plus ``seq``/``ts``).
    The report counts valid and torn frames and says whether the ring
    wrapped (seq 0 evicted) and whether the surviving window is
    seq-contiguous — an unwrapped file from a SIGKILLed process must
    replay contiguous from 0 with at most one torn tail frame.
    """
    with open(path, "rb") as f:
        buf = f.read()
    meta, capacity = _read_header(buf)
    ring = buf[HEADER_SIZE:capacity]
    magic_le = struct.pack("<I", FRAME_MAGIC)
    records: List[Dict[str, Any]] = []
    torn = 0
    pos = 0
    limit = len(ring)
    while pos + _FRAME.size <= limit:
        if ring[pos:pos + 4] != magic_le:
            pos += _ALIGN
            continue
        magic, plen, seq, ts, crc = _FRAME.unpack_from(ring, pos)
        end = pos + _FRAME.size + plen
        if plen > limit - pos - _FRAME.size:
            torn += 1
            pos += _ALIGN
            continue
        payload = ring[pos + _FRAME.size:end]
        if _frame_crc(plen, seq, ts, payload) != crc:
            torn += 1
            pos += _ALIGN
            continue
        try:
            rec = json.loads(payload.decode())
        except ValueError:
            torn += 1
            pos += _ALIGN
            continue
        rec["seq"] = seq
        rec["ts"] = ts
        records.append(rec)
        pos += _align(end - pos)
    records.sort(key=lambda r: r["seq"])
    seqs = [r["seq"] for r in records]
    report = {
        "frames_valid": len(records),
        "frames_torn": torn,
        "wrapped": bool(seqs) and seqs[0] > 0,
        "seq_min": seqs[0] if seqs else None,
        "seq_max": seqs[-1] if seqs else None,
        "contiguous": seqs == list(range(seqs[0], seqs[-1] + 1))
        if seqs else True,
    }
    return meta, records, report
