"""Datasets (``paddle_tpu/io/dataset.py`` counterpart; ref
python/paddle/io/dataloader/dataset.py). Numpy code, the JAX package's."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "Subset", "random_split"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise TypeError("IterableDataset is not subscriptable")

    def __len__(self):
        raise TypeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors: Sequence):
        arrays = [np.asarray(t) for t in tensors]
        n = arrays[0].shape[0]
        assert all(a.shape[0] == n for a in arrays), \
            "all tensors must have the same first dimension"
        self.tensors = arrays

    def __getitem__(self, idx):
        return tuple(a[idx] for a in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets: Sequence[Dataset]):
        self.datasets = list(datasets)
        n = len(self.datasets[0])
        assert all(len(d) == n for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, (tuple, list)) else [item])
        return tuple(out)

    def __len__(self):
        return len(self.datasets[0])


class Subset(Dataset):
    def __init__(self, dataset: Dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset: Dataset, lengths: Sequence[int], generator=None) -> List[Subset]:
    total = sum(lengths)
    assert total == len(dataset)
    perm = np.random.default_rng().permutation(total)
    out, offset = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[offset:offset + n].tolist()))
        offset += n
    return out


class ChainDataset(IterableDataset):
    """ref dataset.py ChainDataset: concatenated ITERABLE datasets."""

    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for ds in self.datasets:
            yield from ds
