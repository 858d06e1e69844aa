"""Datasets, samplers and the DataLoader of the port (``paddle_tpu/io``
counterpart)."""

from .dataset import ChainDataset  # noqa: F401
from .dataset import (Dataset, IterableDataset, TensorDataset,  # noqa: F401
                      ComposeDataset, Subset, random_split)
from .sampler import (Sampler, SequenceSampler, RandomSampler,  # noqa: F401
                      BatchSampler, DistributedBatchSampler,
                      WeightedRandomSampler)
from .dataloader import DataLoader, default_collate_fn  # noqa: F401
from .worker import get_worker_info  # noqa: F401
