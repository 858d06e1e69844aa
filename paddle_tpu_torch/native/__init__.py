"""Native runtime primitives over ctypes (``paddle_tpu/native``
counterpart).

:class:`ShmQueue` is a process-shared POSIX-shm ring of variable-length
byte records guarded by PTHREAD_PROCESS_SHARED mutex/condvars (a robust
mutex, so a dead worker cannot wedge the trainer), with a consumer-progress
marker producers use to pace themselves. The DataLoader's subprocess
workers ship their batches through it. An object whose pickle is larger
than a quarter of the ring goes through it in pieces, which the consumer
puts back together (JAX's queue refuses a record larger than the ring, so
a batch of 256 float32 images of 224² fails its worker there). The
source, ``shm_queue.cpp``, is the JAX package's; :mod:`.build` compiles
it with ``g++`` at first use into ``paddle_tpu_torch/_build/``. The
library exports a C ABI bound with ctypes.
"""

from __future__ import annotations

import ctypes
import os
import pickle
import struct
import uuid

import numpy as np

from .build import lib_path

__all__ = ["ShmQueue", "QueueClosed", "QueueTimeout", "QueueCorrupted",
           "load_library"]

_lib = None

#: a piece of a record too large for one ring record; a pickle starts with
#: its PROTO opcode, 0x80, so a record starting with 0x00 is a piece
_PIECE = b"\x00PDQ"
#: a piece's header: the magic, the producer's pid, the whole record's
#: bytes, the piece's offset in it
_HEAD = struct.Struct("<4sQQQ")


def load_library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(lib_path())
        lib.sq_create.restype = ctypes.c_void_p
        lib.sq_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                  ctypes.c_int]
        lib.sq_push.restype = ctypes.c_int
        lib.sq_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_uint64, ctypes.c_long]
        lib.sq_pop.restype = ctypes.c_int64
        lib.sq_pop.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                               ctypes.c_uint64, ctypes.c_long]
        lib.sq_peek_size.restype = ctypes.c_int64
        lib.sq_peek_size.argtypes = [ctypes.c_void_p]
        lib.sq_count.restype = ctypes.c_uint64
        lib.sq_count.argtypes = [ctypes.c_void_p]
        lib.sq_shutdown.argtypes = [ctypes.c_void_p]
        lib.sq_close.argtypes = [ctypes.c_void_p]
        lib.sq_set_useq.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.sq_get_useq.restype = ctypes.c_uint64
        lib.sq_get_useq.argtypes = [ctypes.c_void_p]
        lib.sq_wait_useq.restype = ctypes.c_int
        lib.sq_wait_useq.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                     ctypes.c_long]
        _lib = lib
    return _lib


class QueueClosed(Exception):
    """The queue was shut down and drained."""


class QueueTimeout(Exception):
    """push/pop timed out."""


class QueueCorrupted(Exception):
    """A peer died mid-commit; ring contents can no longer be trusted."""


class ShmQueue:
    """Cross-process bounded byte-record queue in POSIX shared memory.

    The creator (``owner=True``) allocates the shm segment and unlinks it on
    close; workers open the same ``name`` with ``owner=False``. Records are
    arbitrary byte strings (callers typically push pickled batches).
    """

    def __init__(self, name: str | None = None, capacity: int = 64 << 20,
                 owner: bool = True):
        # a producer that opens the ring (owner=False) passes the owner's
        # capacity: it sizes the pieces of a large record
        self.capacity = capacity
        self._pending = {}   # producer pid -> (record bytes so far, count)
        self._scratch = None  # the pop buffer, kept for the next pop
        self.name = name or f"/pdtq_{os.getpid()}_{uuid.uuid4().hex[:8]}"
        if not self.name.startswith("/"):
            self.name = "/" + self.name
        self._lib = load_library()
        self._h = self._lib.sq_create(self.name.encode(), capacity,
                                      1 if owner else 0)
        if not self._h:
            raise OSError(f"shm queue create/open failed for {self.name}")
        self.owner = owner

    def push_bytes(self, data: bytes, timeout: float = 120.0) -> None:
        rc = self._lib.sq_push(self._h, data, len(data),
                               int(timeout * 1000))
        if rc == -1:
            raise QueueTimeout(f"push timed out after {timeout}s")
        if rc == -2:
            raise QueueClosed()
        if rc == -3:
            raise ValueError(
                f"record of {len(data)} bytes exceeds queue capacity")
        if rc == -5:
            raise QueueCorrupted()

    def pop_bytes(self, timeout: float = 120.0) -> bytes:
        return bytes(self._pop(timeout))

    def _pop(self, timeout: float) -> memoryview:
        """The next record, a view of this queue's pop buffer (reused by
        the next pop: the caller copies what it keeps first)."""
        # Size the buffer off the next record; retry if a different (larger)
        # record lands between peek and pop.
        size = self._lib.sq_peek_size(self._h)
        buf_len = max(size, 4096)
        while True:
            if self._scratch is None or len(self._scratch) < buf_len:
                self._scratch = ctypes.create_string_buffer(buf_len)
            buf = self._scratch
            rc = self._lib.sq_pop(self._h, buf, len(buf),
                                  int(timeout * 1000))
            if rc >= 0:
                return memoryview(buf).cast("B")[:rc]
            if rc == -1:
                raise QueueTimeout(f"pop timed out after {timeout}s")
            if rc == -2:
                raise QueueClosed()
            if rc == -5:
                raise QueueCorrupted()
            if rc == -4:
                buf_len = max(self._lib.sq_peek_size(self._h), buf_len * 2)

    # Object convenience layer (pickle).
    def put(self, obj, timeout: float = 120.0) -> None:
        """``obj`` pickled, as one record, or in pieces of at most a
        quarter of the ring (each waits for room with ``timeout``)."""
        data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        piece = max(self.capacity // 4 - _HEAD.size, 1)
        if len(data) <= piece:
            self.push_bytes(data, timeout)
            return
        view = memoryview(data)
        pid = os.getpid()
        for off in range(0, len(data), piece):
            self.push_bytes(_HEAD.pack(_PIECE, pid, len(data), off)
                            + view[off:off + piece], timeout)

    def get(self, timeout: float = 120.0):
        """The next object; the pieces of a large one, which may arrive
        among other producers' records, are gathered first."""
        while True:
            rec = self._pop(timeout)
            if rec[:4] != _PIECE:
                # unpickled from the popped buffer itself, not a copy
                return pickle.loads(rec)
            _, pid, total, off = _HEAD.unpack_from(rec)
            buf, got = self._pending.pop(pid, None) or \
                (np.empty(total, np.uint8), 0)
            n = len(rec) - _HEAD.size
            buf[off:off + n] = np.frombuffer(rec, np.uint8, offset=_HEAD.size)
            if got + n < total:
                self._pending[pid] = (buf, got + n)
                continue
            return pickle.loads(memoryview(buf))

    def qsize(self) -> int:
        return int(self._lib.sq_count(self._h))

    # Consumer-progress marker: the consumer publishes a monotonically
    # increasing sequence (e.g. next batch index); producers block in
    # wait_progress() to bound how far ahead they run.
    def set_progress(self, value: int) -> None:
        self._lib.sq_set_useq(self._h, value)

    def get_progress(self) -> int:
        return int(self._lib.sq_get_useq(self._h))

    def wait_progress(self, min_value: int, timeout: float = 120.0) -> None:
        rc = self._lib.sq_wait_useq(self._h, min_value, int(timeout * 1000))
        if rc == -1:
            raise QueueTimeout(
                f"progress wait (>= {min_value}) timed out after {timeout}s")
        if rc == -2:
            raise QueueClosed()
        if rc == -5:
            raise QueueCorrupted()

    def shutdown(self) -> None:
        """Close for writing and wake all waiters (consumers drain)."""
        if self._h:
            self._lib.sq_shutdown(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.sq_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
