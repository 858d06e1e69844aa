"""Multiprocess DataLoader worker (``paddle_tpu/io/worker.py`` counterpart).

Subprocess workers index the dataset, collate in numpy and ship batches
back through the native :class:`paddle_tpu_torch.native.ShmQueue` (POSIX
shm ring, robust pshared mutex), so a batch crosses the process boundary
with one pickle and one ring copy, and a dead worker can never wedge the
trainer. A worker never touches CUDA: a process forked after the trainer
initialised CUDA may not use it, so batches stay numpy until the trainer
moves them.

Work assignment is static round-robin by worker id — the consumer reorders
by batch index, so no index feed queue is needed (the reference's
``_IndexQueue`` collapses away).
"""

from __future__ import annotations

import os
import traceback


class WorkerError:
    """Pickled marker carrying a worker-side exception traceback."""

    def __init__(self, batch_index: int, exc: BaseException):
        self.batch_index = batch_index
        self.message = "".join(
            traceback.format_exception(type(exc), exc, exc.__traceback__))


class WorkerDone:
    """Pickled marker: worker finished its slice."""

    def __init__(self, worker_id: int):
        self.worker_id = worker_id


class WorkerInfo:
    """Visible to dataset code inside a worker (ref get_worker_info())."""

    def __init__(self, id: int, num_workers: int, seed: int):
        self.id = id
        self.num_workers = num_workers
        self.seed = seed


_worker_info: WorkerInfo | None = None


def get_worker_info() -> WorkerInfo | None:
    """Inside a worker process, returns its WorkerInfo; None in the
    trainer."""
    return _worker_info


def worker_loop(dataset, collate_fn, batches, worker_id: int,
                num_workers: int, queue_name: str, base_seed: int,
                worker_init_fn=None, prefetch_window: int = 0,
                capacity: int = 64 << 20) -> None:
    """Entry point run in each spawned worker process.

    Blocking on a full ring or on the pacing window is normal flow control
    (the trainer may pause minutes for eval/checkpoint), so puts use a long
    timeout; if it still expires, the trainer is gone or wedged and the
    worker exits quietly — the trainer's own ``DataLoader.timeout`` is the
    user-visible failure signal.
    """
    global _worker_info
    from ..native import QueueClosed, QueueTimeout, ShmQueue

    _worker_info = WorkerInfo(worker_id, num_workers, base_seed + worker_id)
    try:
        import numpy as _np
        _np.random.seed(base_seed + worker_id)
    except Exception:
        pass
    if worker_init_fn is not None:
        worker_init_fn(worker_id)

    _STALL = 3600.0  # generous: covers long trainer pauses, not a hang
    q = ShmQueue(name=queue_name, capacity=capacity, owner=False)
    exit_code = 0

    def ship_error(i, exc):
        # Best-effort: if even the (small) error record can't be shipped,
        # die with a nonzero code so the trainer's dead-worker check fires
        # instead of a silent stall.
        nonlocal exit_code
        try:
            q.put((i, WorkerError(i, exc)), timeout=30.0)
        except BaseException:
            exit_code = 1

    try:
        for i in range(worker_id, len(batches), num_workers):
            if prefetch_window and i >= prefetch_window:
                # Run at most `prefetch_window` batches ahead of the
                # trainer's published consume position.
                q.wait_progress(i - prefetch_window + 1, timeout=_STALL)
            try:
                data = collate_fn([dataset[j] for j in batches[i]])
            except BaseException as e:  # ship the traceback to the trainer
                ship_error(i, e)
                return
            try:
                q.put((i, data), timeout=_STALL)
            except (QueueClosed, QueueTimeout):
                return  # consumer went away (or wedged longer than _STALL)
            except BaseException as e:  # unpicklable / oversized batch
                ship_error(i, e)
                return
        q.put(WorkerDone(worker_id), timeout=_STALL)
    except (QueueClosed, QueueTimeout):
        pass  # consumer went away (or wedged longer than _STALL)
    except BaseException:
        exit_code = 1
    finally:
        q.close()
        # Forked workers inherit the trainer's CUDA state; skip Python
        # finalization (atexit handlers, CUDA teardown) entirely.
        os._exit(exit_code)
