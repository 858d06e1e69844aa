"""DataLoader (``paddle_tpu/io/dataloader.py`` counterpart).

- ``num_workers=0`` assembles batches in the caller's thread.
- Workers are threads by default (batch assembly is numpy, which releases
  the GIL), pulling index batches from the sampler and collating.
- ``use_shared_memory=True`` switches to subprocess workers shipping batches
  through the native shared-memory ring queue
  (``paddle_tpu_torch/native/shm_queue.cpp``), for datasets whose
  per-sample work holds the GIL (decode, tokenize). The start method comes
  from ``PADDLE_TPU_WORKER_START_METHOD`` (default ``fork``). Workers never
  touch CUDA, so forking after the trainer initialised it is safe.
- Batches are numpy, as in the JAX package, except under
  ``prefetch_to_device``, which overlaps the host-to-device copy with the
  current step: each array of the next batch is copied into pinned host
  memory and then to the device with ``non_blocking=True`` on a side
  stream, while the caller works on the current batch. The caller's stream
  waits on that copy's event before it gets the batch, and
  ``record_stream`` keeps the device buffers from being reused while the
  caller's stream may still read them; a pinned buffer comes from the
  caching host allocator, which keeps it until the copy that reads it is
  done. The device is the one ``places`` names, else
  :func:`~..core.device.resolve_device`'s (``cuda:0``).
- Each batch the caller waits for is timed under the step timeline's
  ``data`` phase and counted as ``dataloader.batches``, as in JAX.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Any, Callable, Iterator, List, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..observability import step_monitor
from ..profiler.monitor import stat_add
from .dataset import Dataset, IterableDataset
from .sampler import BatchSampler

__all__ = ["DataLoader", "default_collate_fn"]


def default_collate_fn(batch: List[Any]):
    """Stack samples into batched numpy arrays (ref: default_collate_fn in
    io/dataloader/collate.py)."""
    sample = batch[0]
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, dtype=np.int64)
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, dtype=np.float32)
    if isinstance(sample, (tuple, list)):
        transposed = list(zip(*batch))
        return type(sample)(default_collate_fn(list(col)) for col in transposed)
    if isinstance(sample, dict):
        return {k: default_collate_fn([d[k] for d in batch]) for k in sample}
    if isinstance(sample, torch.Tensor):
        return np.stack([s.detach().cpu().numpy() for s in batch])
    if hasattr(sample, "shape"):  # array-like
        return np.stack([np.asarray(s) for s in batch])
    return batch


def _make_queue(capacity: int):
    # In-process handoff: plain queue.Queue passes object references with no
    # serialization. The native shm queue (..native.ShmQueue) is for
    # the multiprocess path, where one pickle per batch is unavoidable.
    return queue.Queue(maxsize=capacity)


class _Sentinel:
    pass


_END = _Sentinel()


class DataLoader:
    def __init__(self, dataset: Dataset, feed_list=None, places=None,
                 return_list: bool = True, batch_sampler: Optional[BatchSampler] = None,
                 batch_size: Optional[int] = 1, shuffle: bool = False,
                 drop_last: bool = False, collate_fn: Optional[Callable] = None,
                 num_workers: int = 0, use_buffer_reader: bool = True,
                 prefetch_factor: int = 2, use_shared_memory: bool = False,
                 timeout: float = 120.0, worker_init_fn=None,
                 prefetch_to_device: bool = False):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = max(0, int(num_workers))
        self.prefetch_factor = max(1, int(prefetch_factor))
        self.timeout = timeout
        self.prefetch_to_device = prefetch_to_device
        self.use_shared_memory = use_shared_memory
        self.worker_init_fn = worker_init_fn
        self.places = places
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            if batch_size is None:
                raise ValueError("batch_size or batch_sampler required")
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)

    # -- iteration -----------------------------------------------------------

    def _batches_sync(self) -> Iterator[Any]:
        if self._iterable_mode:
            batch = []
            for item in self.dataset:
                batch.append(item)
                if len(batch) == self.batch_size:
                    yield self.collate_fn(batch)
                    batch = []
            if batch and not self.drop_last:
                yield self.collate_fn(batch)
        else:
            for indices in self.batch_sampler:
                yield self.collate_fn([self.dataset[i] for i in indices])

    def _batches_threaded(self) -> Iterator[Any]:
        assert not self._iterable_mode
        index_q: "queue.Queue" = queue.Queue()
        # capacity covers max in-flight data items + one END marker per
        # worker, so worker puts can never block (no leaked stuck threads
        # if the consumer abandons the iterator mid-epoch).
        out_q = _make_queue(self.num_workers * (self.prefetch_factor + 1))
        batches = list(self.batch_sampler)
        n_batches = len(batches)
        # Reorder buffer keyed by batch index. Backpressure: at most
        # `max_inflight` tasks are outstanding (issued - yielded), so a slow
        # head-of-line batch can't let the buffer grow past the cap.
        results = {}
        max_inflight = self.num_workers * self.prefetch_factor
        issued = 0
        stop = threading.Event()

        def issue_some(next_idx: int):
            nonlocal issued
            while issued < n_batches and issued - next_idx < max_inflight:
                index_q.put((issued, batches[issued]))
                issued += 1

        def worker():
            while not stop.is_set():
                task = index_q.get()
                if task is None:
                    out_q.put(_END)
                    return
                i, indices = task
                try:
                    data = self.collate_fn([self.dataset[j] for j in indices])
                    out_q.put((i, data))
                except Exception as e:  # propagate to consumer
                    out_q.put((i, e))

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()

        done_workers = 0
        next_idx = 0
        try:
            issue_some(next_idx)
            while next_idx < n_batches:
                while next_idx in results:
                    data = results.pop(next_idx)
                    if isinstance(data, Exception):
                        raise data
                    yield data
                    next_idx += 1
                    issue_some(next_idx)
                if next_idx >= n_batches:
                    break
                item = out_q.get(timeout=self.timeout)
                if item is _END:
                    done_workers += 1
                    if done_workers == self.num_workers and next_idx < n_batches \
                            and not results:
                        raise RuntimeError("DataLoader workers exited early")
                    continue
                i, data = item
                results[i] = data
        finally:
            stop.set()
            for _ in range(self.num_workers):
                index_q.put(None)

    def _batches_multiprocess(self) -> Iterator[Any]:
        """Subprocess workers + native shm queue (ref worker.py _worker_loop)."""
        assert not self._iterable_mode
        import multiprocessing as mp

        from ..native import QueueTimeout, ShmQueue
        from .worker import WorkerDone, WorkerError, worker_loop

        batches = list(self.batch_sampler)
        n_batches = len(batches)
        if n_batches == 0:
            return
        n_workers = min(self.num_workers, n_batches)
        q = ShmQueue(capacity=max(64 << 20,
                                  n_workers * self.prefetch_factor * (8 << 20)))
        base_seed = int(np.random.randint(0, 2**31 - 1))
        method = os.environ.get(
            "PADDLE_TPU_WORKER_START_METHOD",
            "fork" if hasattr(os, "fork") else "spawn")
        ctx = mp.get_context(method)
        # Producers run at most `window` batches ahead of the consumed
        # position, which bounds the reorder buffer below to `window`
        # entries even when one slow batch holds up the head of the line.
        window = n_workers * self.prefetch_factor
        procs = [
            ctx.Process(
                target=worker_loop,
                args=(self.dataset, self.collate_fn, batches, wid, n_workers,
                      q.name, base_seed, self.worker_init_fn, window),
                daemon=True)
            for wid in range(n_workers)
        ]
        for p in procs:
            p.start()
        results = {}
        done = set()
        next_idx = 0
        deadline_slack = self.timeout
        try:
            while next_idx < n_batches:
                while next_idx in results:
                    yield results.pop(next_idx)
                    next_idx += 1
                    q.set_progress(next_idx)
                if next_idx >= n_batches:
                    break
                try:
                    item = q.get(timeout=min(5.0, deadline_slack))
                except QueueTimeout:
                    dead = [p for p in procs if not p.is_alive()
                            and p.exitcode not in (0, None)]
                    if dead:
                        raise RuntimeError(
                            f"DataLoader worker (pid {dead[0].pid}) exited "
                            f"unexpectedly with code {dead[0].exitcode}")
                    deadline_slack -= 5.0
                    if deadline_slack <= 0:
                        raise QueueTimeout(
                            f"DataLoader timed out after {self.timeout}s "
                            f"waiting for batch {next_idx}")
                    continue
                deadline_slack = self.timeout
                if isinstance(item, WorkerDone):
                    done.add(item.worker_id)
                    if len(done) == n_workers and next_idx < n_batches \
                            and not results and q.qsize() == 0:
                        raise RuntimeError("DataLoader workers exited early")
                    continue
                i, data = item
                if isinstance(data, WorkerError):
                    raise RuntimeError(
                        f"DataLoader worker failed on batch {i}:\n"
                        f"{data.message}")
                results[i] = data
        finally:
            q.shutdown()
            for p in procs:
                p.join(timeout=5.0)
                if p.is_alive():
                    p.terminate()
            q.close()

    def _device(self) -> torch.device:
        place = self.places
        if isinstance(place, (list, tuple)):
            place = place[0] if place else None
        return resolve_device(place)

    def _prefetched(self, source: Iterator[Any]) -> Iterator[Any]:
        """``source``'s batches as tensors on the device, one batch in
        flight: the next batch's copy is issued before the current one is
        handed over."""
        device = self._device()
        if device.type != "cuda":
            def put(batch):
                return _tree_map(lambda a: torch.from_numpy(a).to(device),
                                 batch), None
        else:
            stream = torch.cuda.Stream(device)

            def copy(a):
                return torch.from_numpy(a).pin_memory().to(
                    device, non_blocking=True)

            def put(batch):
                with torch.cuda.stream(stream):
                    out = _tree_map(copy, batch)
                    done = torch.cuda.Event()
                    done.record(stream)
                return out, done

        def ready(item):
            batch, done = item
            if done is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(done)
                _tree_map(lambda t: t.record_stream(consumer), batch,
                          kind=torch.Tensor)
            return batch

        prev = None
        for batch in source:
            cur = put(batch)
            if prev is not None:
                yield ready(prev)
            prev = cur
        if prev is not None:
            yield ready(prev)

    @staticmethod
    def _counted(source: Iterator[Any]) -> Iterator[Any]:
        # the telemetry "data" phase: the wall time the consumer spends
        # WAITING on the loader (assembly the workers already overlapped
        # does not show here, only the stalls the training loop feels)
        tm = step_monitor.current()
        while True:
            with tm.phase("data"):
                batch = next(source, _END)
            if batch is _END:
                return
            stat_add("dataloader.batches")
            yield batch

    def __iter__(self) -> Iterator[Any]:
        if self.num_workers == 0:
            source = self._batches_sync()
        elif self.use_shared_memory and not self._iterable_mode:
            source = self._batches_multiprocess()
        else:
            source = self._batches_threaded()
        source = self._counted(source)
        if self.prefetch_to_device:
            source = self._prefetched(source)
        yield from source


def _tree_map(fn, batch, kind=np.ndarray):
    """``fn`` over the ``kind`` leaves of a batch (tuples, lists, dicts);
    other leaves pass as they are."""
    if isinstance(batch, kind):
        return fn(batch)
    if isinstance(batch, dict):
        return {k: _tree_map(fn, v, kind) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_tree_map(fn, v, kind) for v in batch)
    return batch
