"""Samplers (``paddle_tpu/io/sampler.py`` counterpart; ref
python/paddle/io/dataloader/sampler.py, batch_sampler.py). Numpy code, the
JAX package's: under one ``np.random`` state both packages draw the same
orders."""

from __future__ import annotations

import math
from typing import Iterator, List, Optional, Sequence

import numpy as np

__all__ = ["Sampler", "SequenceSampler", "RandomSampler", "BatchSampler",
           "DistributedBatchSampler", "WeightedRandomSampler"]


def _world():
    """``(world size, rank)`` of the ``torch.distributed`` group when one
    is up, else ``(1, 0)``: one process, as ``jax.process_count()`` and
    ``jax.process_index()`` give them in the JAX package."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self) -> Iterator[int]:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))

    def __len__(self):
        return len(self.data_source)


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement: bool = False,
                 num_samples: Optional[int] = None, generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        # Seed from numpy's global RNG (reseeded by paddle.seed) so epoch
        # order is reproducible while still varying across epochs.
        rng = np.random.default_rng(np.random.randint(0, 2 ** 31))
        n = len(self.data_source)
        if self.replacement:
            yield from rng.integers(0, n, self.num_samples).tolist()
        else:
            yield from rng.permutation(n)[:self.num_samples].tolist()

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights: Sequence[float], num_samples: int,
                 replacement: bool = True):
        super().__init__()
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        rng = np.random.default_rng(np.random.randint(0, 2 ** 31))
        p = self.weights / self.weights.sum()
        yield from rng.choice(len(self.weights), self.num_samples,
                              replace=self.replacement, p=p).tolist()

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler: Optional[Sampler] = None,
                 shuffle: bool = False, batch_size: int = 1,
                 drop_last: bool = False):
        if sampler is None:
            sampler = RandomSampler(dataset) if shuffle else SequenceSampler(dataset)
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self) -> Iterator[List[int]]:
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Per-rank sharded batches (ref DistributedBatchSampler): each data-
    parallel rank sees a disjoint 1/nranks slice, padded to equal length."""

    def __init__(self, dataset, batch_size: int, num_replicas: Optional[int] = None,
                 rank: Optional[int] = None, shuffle: bool = False,
                 drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        world, me = _world()
        self.nranks = num_replicas if num_replicas is not None else world
        self.local_rank = rank if rank is not None else me
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.epoch)
            indices = rng.permutation(n)
            self.epoch += 1
        if self.total_size > n:
            # Wrap-around padding (repeat as often as needed so every rank
            # gets exactly num_samples indices even when nranks > n).
            reps = -(-self.total_size // n)
            indices = np.tile(indices, reps)[: self.total_size]
        local = indices[self.local_rank:self.total_size:self.nranks].tolist()
        batch = []
        for idx in local:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch
