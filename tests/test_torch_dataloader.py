"""Port parity: ``paddle_tpu_torch.io`` (datasets, samplers, the
DataLoader in its three modes) and ``paddle_tpu_torch.native.ShmQueue``.

Under one ``np.random`` seed the port's DataLoader gives the JAX package's
batches, in order and bit for bit, with no workers, with thread workers and
with shared-memory process workers (each held against JAX's loader with no
workers, which all of JAX's modes equal). A worker's exception reaches the
caller; a worker that dies is reported; the queue is the port's own build
(``paddle_tpu_torch/_build``). Device prefetch runs here on the CPU
(``places="cpu"``); on the card ``chip_smoke.py``'s ``hapi_lenet`` runs it.
"""

import os

import numpy as np
import pytest
import torch

from paddle_tpu import io as jio
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.native import (QueueClosed, QueueTimeout, ShmQueue,
                                     build)
from paddle_tpu_torch.vision.datasets import MNIST as TMNIST
from paddle_tpu.vision.datasets import MNIST as JMNIST


def _jax_batches(ds, seed, **kw):
    np.random.seed(seed)
    return [tuple(np.asarray(a) for a in b)
            for b in jio.DataLoader(ds, **kw)]


def _port_batches(ds, seed, **kw):
    np.random.seed(seed)
    return list(tio.DataLoader(ds, **kw))


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert isinstance(a, np.ndarray) and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def mnist():
    port, jax = TMNIST(mode="train", synthetic_size=300), \
        JMNIST(mode="train", synthetic_size=300)
    np.testing.assert_array_equal(port.images, jax.images)
    np.testing.assert_array_equal(port.labels, jax.labels)
    return port


@pytest.mark.parametrize("mode", ["sync", "threads", "shm"])
def test_batches_match_jax(mnist, mode):
    """Two epochs of shuffled batches (B=64, the last one short)."""
    kw = dict(batch_size=64, shuffle=True)
    want = _jax_batches(mnist, 7, **kw) + _jax_batches(mnist, 8, **kw)
    extra = {"sync": {}, "threads": dict(num_workers=3),
             "shm": dict(num_workers=2, use_shared_memory=True)}[mode]
    got = _port_batches(mnist, 7, **kw, **extra) + \
        _port_batches(mnist, 8, **kw, **extra)
    _same(got, want)
    assert [len(b[1]) for b in got[:5]] == [64, 64, 64, 64, 44]


def test_samplers_match_jax(mnist):
    np.random.seed(3)
    want = [list(jio.RandomSampler(mnist)) for _ in range(2)]
    want.append(list(jio.DistributedBatchSampler(
        mnist, 32, num_replicas=3, rank=1, shuffle=True)))
    np.random.seed(3)
    got = [list(tio.RandomSampler(mnist)) for _ in range(2)]
    got.append(list(tio.DistributedBatchSampler(
        mnist, 32, num_replicas=3, rank=1, shuffle=True)))
    assert got == want
    # no process group: world size 1, rank 0
    sampler = tio.DistributedBatchSampler(mnist, 50)
    assert (sampler.nranks, sampler.local_rank) == (1, 0)
    assert len(sampler) == 6


def test_prefetch_to_device_on_the_cpu(mnist):
    want = _port_batches(mnist, 1, batch_size=100)
    got = _port_batches(mnist, 1, batch_size=100, prefetch_to_device=True,
                        places="cpu")
    assert len(got) == len(want)
    for (x, y), (wx, wy) in zip(got, want):
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        np.testing.assert_array_equal(x.numpy(), wx)
        np.testing.assert_array_equal(y.numpy(), wy)


class Faulty(tio.Dataset):
    """Raises at index 13; with ``die`` a worker process exits there
    instead."""

    def __init__(self, die=False):
        self.die = die

    def __len__(self):
        return 40

    def __getitem__(self, i):
        if i == 13:
            if self.die and tio.get_worker_info() is not None:
                os._exit(3)
            raise KeyError(f"bad sample {i}")
        return np.float32(i)


@pytest.mark.parametrize("mode", ["threads", "shm"])
def test_worker_exception_reaches_the_caller(mode):
    kw = dict(batch_size=4, num_workers=2,
              use_shared_memory=mode == "shm")
    it = iter(tio.DataLoader(Faulty(), **kw))
    assert next(it).tolist() == [0, 1, 2, 3]
    err = (RuntimeError, KeyError)
    with pytest.raises(err, match="bad sample 13"):
        list(it)


def test_dead_worker_is_detected():
    loader = tio.DataLoader(Faulty(die=True), batch_size=4, num_workers=2,
                            use_shared_memory=True, timeout=1.0)
    with pytest.raises(RuntimeError, match="exited unexpectedly with code 3"):
        list(loader)


def test_worker_info_and_seeds():
    class Info(tio.Dataset):
        def __len__(self):
            return 8

        def __getitem__(self, i):
            info = tio.get_worker_info()
            return np.array([info.id, info.num_workers, i], np.int64)

    out = np.concatenate(list(tio.DataLoader(
        Info(), batch_size=2, num_workers=2, use_shared_memory=True)))
    assert sorted(out[:, 2].tolist()) == list(range(8))
    assert set(out[:, 0].tolist()) == {0, 1} and set(out[:, 1]) == {2}
    assert tio.get_worker_info() is None


def test_shm_queue_is_the_ports_own_build():
    path = build.lib_path()
    assert os.path.dirname(path) == str(build.BUILD_DIR)
    assert build.BUILD_DIR.parts[-2:] == ("paddle_tpu_torch", "_build")
    assert build.lib_path() == path      # reused, not rebuilt
    q = ShmQueue(capacity=1 << 16)
    try:
        pid = os.fork()
        if pid == 0:
            child = ShmQueue(name=q.name, owner=False)
            child.put({"from": "child", "a": np.arange(3)}, timeout=10)
            child.close()
            os._exit(0)
        got = q.get(timeout=10)
        os.waitpid(pid, 0)
        assert got["from"] == "child"
        np.testing.assert_array_equal(got["a"], np.arange(3))
        with pytest.raises(QueueTimeout):
            q.get(timeout=0.05)
        with pytest.raises(ValueError):
            q.push_bytes(b"x" * (1 << 17), timeout=0.05)
        q.shutdown()
        with pytest.raises(QueueClosed):
            q.get(timeout=0.05)
    finally:
        q.close()
