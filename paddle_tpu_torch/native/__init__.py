"""Native runtime primitives over ctypes (``paddle_tpu/native``
counterpart).

:class:`ShmQueue` is a process-shared POSIX-shm ring of variable-length
byte records guarded by PTHREAD_PROCESS_SHARED mutex/condvars (a robust
mutex, so a dead worker cannot wedge the trainer), with a consumer-progress
marker producers use to pace themselves. The DataLoader's subprocess
workers ship their batches through it. The source, ``shm_queue.cpp``, is
the JAX package's; :mod:`.build` compiles it with ``g++`` at first use into
``paddle_tpu_torch/_build/``. The library exports a C ABI bound with
ctypes.
"""

from __future__ import annotations

import ctypes
import os
import pickle
import uuid

from .build import lib_path

__all__ = ["ShmQueue", "QueueClosed", "QueueTimeout", "QueueCorrupted",
           "load_library"]

_lib = None


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
        # Size the buffer off the next record; retry if a different (larger)
        # record lands between peek and pop.
        size = self._lib.sq_peek_size(self._h)
        buf_len = max(size, 4096)
        while True:
            buf = ctypes.create_string_buffer(buf_len)
            rc = self._lib.sq_pop(self._h, buf, buf_len,
                                  int(timeout * 1000))
            if rc >= 0:
                return buf.raw[:rc]
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
        self.push_bytes(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL),
                        timeout)

    def get(self, timeout: float = 120.0):
        return pickle.loads(self.pop_bytes(timeout))

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
