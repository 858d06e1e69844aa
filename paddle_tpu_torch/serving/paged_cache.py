"""Block-paged KV cache: device page pool + free-list allocator + host spill.

Port of ``paddle_tpu/serving/paged_cache.py``. The KV store is a pool of
fixed-size blocks — ``[L, num_blocks, block_size, KH, D]`` per k and v —
and each sequence owns an ordered block list. Allocation is a min-id free
list (the same request schedule always gives the same block assignment,
the JAX engine's included), and capacity pressure preempts a sequence:
its blocks are gathered to host memory (pinned on a GPU), freed, and
later restored bitwise into freshly allocated blocks.

Block 0 is reserved as the **null sink**: padded table entries point at
it, so the bucketed prefill/decode steps scatter the KV of padding tokens
somewhere harmless. Nothing reads block 0 through an attention mask.

The pool is updated in place (``index_put_``) — the port's counterpart of
the JAX engine donating the pool to each executable. The allocator keeps
JAX's gauges (``serving.kv_blocks_free``, ``serving.kv_blocks_used``,
``serving.blocks_shared``) and the cache its counters
(``serving.kv_spills``, ``serving.kv_restores``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..fault.injection import fire as _fault_fire
from ..observability import metrics
from ..observability.trace import telemetry_mode

__all__ = ["BlockAllocator", "PagedKVCache", "NULL_BLOCK",
           "OutOfBlocksError", "SpillError"]

# Block id every padded table slot points at (reserved at init).
NULL_BLOCK = 0


class OutOfBlocksError(RuntimeError):
    """The pool cannot grant a block even after preemption. The engine
    ends the request that needed it FAILED (F003); it never crosses the
    engine loop."""


class SpillError(RuntimeError):
    """A host spill failed. The engine fails the victim sequence (freeing
    its device blocks) instead of the serving loop."""


class BlockAllocator:
    """Min-id free list over ``num_blocks`` KV blocks (block 0 reserved).

    Lowest-id-first allocation keeps the assignment deterministic under a
    fixed request schedule and re-uses freed blocks immediately.
    ``alloc`` is all-or-nothing. Every allocated block carries a refcount:
    ``alloc`` grants 1, :meth:`ref` adds an owner, :meth:`free` drops one
    and returns the block to the free list when its last owner lets go;
    freeing past zero is a ``double-free`` error.
    """

    def __init__(self, num_blocks: int,
                 reserved: Sequence[int] = (NULL_BLOCK,)):
        if num_blocks < 2:
            raise ValueError(f"need >= 2 blocks (one is the null sink), "
                             f"got {num_blocks}")
        self.num_blocks = int(num_blocks)
        self._reserved = frozenset(int(r) for r in reserved)
        self._free = sorted(set(range(self.num_blocks)) - self._reserved)
        self._used: set = set()
        self._refs: Dict[int, int] = {}

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return len(self._used)

    @property
    def n_shared(self) -> int:
        """Blocks currently held by more than one owner."""
        return sum(1 for r in self._refs.values() if r > 1)

    def refcount(self, i: int) -> int:
        return self._refs.get(int(i), 0)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n lowest free block ids, or None when fewer than n are free."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        got, self._free = self._free[:n], self._free[n:]
        self._used.update(got)
        for i in got:
            self._refs[i] = 1
        self._gauges()
        return got

    def ref(self, ids: Sequence[int]) -> None:
        """Add one owner to each allocated block."""
        ids = [int(i) for i in ids]
        for i in ids:
            if i not in self._used:
                raise ValueError(f"ref of unallocated block {i}")
        for i in ids:
            self._refs[i] += 1
        self._gauges()

    def free(self, ids: Sequence[int]) -> None:
        """Drop one owner per block; last-owner blocks return to the free
        list."""
        ids = [int(i) for i in ids]
        for i in ids:
            if i in self._reserved:
                raise ValueError(f"freeing reserved block {i}")
            if i not in self._used:
                raise ValueError(f"double-free of block {i}")
            if ids.count(i) > self._refs[i]:
                raise ValueError(
                    f"double-free of block {i} (repeated past its "
                    f"refcount in one free call)")
        released = []
        for i in ids:
            self._refs[i] -= 1
            if self._refs[i] == 0:
                del self._refs[i]
                self._used.discard(i)
                released.append(i)
        if released:
            self._free = sorted(self._free + released)
        self._gauges()

    def _gauges(self) -> None:
        if telemetry_mode() == "off":
            return
        metrics.gauge("serving.kv_blocks_free",
                      "free KV blocks in the paged pool").set(self.n_free)
        metrics.gauge("serving.kv_blocks_used",
                      "allocated KV blocks in the paged pool").set(self.n_used)
        metrics.gauge("serving.blocks_shared",
                      "KV blocks held by more than one owner").set(
                          self.n_shared)


HostKV = Tuple[torch.Tensor, torch.Tensor]


class PagedKVCache:
    """The device page pool for one model: k/v tensors of shape
    ``[n_layers, num_blocks, block_size, kv_heads, head_dim]``.

    The serving engine's prefill and decode steps write the pool in place;
    spill and restore move whole per-sequence block lists between the pool
    and host memory (pinned when the pool is on a GPU)."""

    def __init__(self, n_layers: int, num_blocks: int, block_size: int,
                 kv_heads: int, head_dim: int,
                 dtype: torch.dtype = torch.float32,
                 device=torch.device("cpu")):
        self.n_layers = int(n_layers)
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.kv_heads = int(kv_heads)
        self.head_dim = int(head_dim)
        self.dtype = dtype
        self.device = torch.device(device)
        shape = (self.n_layers, self.num_blocks, self.block_size,
                 self.kv_heads, self.head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=dtype, device=self.device)
        self.allocator = BlockAllocator(num_blocks)
        self.pinned = self.device.type == "cuda"

    @property
    def bytes_per_block(self) -> int:
        return (2 * self.n_layers * self.block_size * self.kv_heads *
                self.head_dim * self.k.element_size())

    def swap(self, k: torch.Tensor, v: torch.Tensor) -> None:
        """Adopt new pool tensors (the steps update the pool in place, so
        the engine never needs this; kept for the reference's API)."""
        if k.shape != self.k.shape or v.shape != self.v.shape:
            raise ValueError(f"pool shape {tuple(self.k.shape)} != "
                             f"{tuple(k.shape)}")
        self.k, self.v = k, v

    def _ids(self, block_ids: Sequence[int]) -> torch.Tensor:
        return torch.as_tensor(list(block_ids), dtype=torch.long,
                               device=self.device)

    def _to_host(self, x: torch.Tensor) -> torch.Tensor:
        if not self.pinned:
            return x.clone()
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x, non_blocking=True)
        return host

    def snapshot(self, block_ids: Sequence[int]) -> HostKV:
        """Gather ``block_ids`` to host memory without freeing them.

        The copies run asynchronously into pinned memory; the stream is
        synchronised before this returns, so the host tensors are complete
        and the blocks may be overwritten as soon as the caller frees
        them."""
        ids = self._ids(block_ids)
        k_host = self._to_host(self.k[:, ids])
        v_host = self._to_host(self.v[:, ids])
        if self.pinned:
            torch.cuda.current_stream(self.device).synchronize()
        return k_host, v_host

    def spill(self, block_ids: Sequence[int]) -> HostKV:
        """Gather ``block_ids`` to host and free them. Returns the host KV
        pair :meth:`restore` takes; the device blocks are reusable
        immediately after.

        The ``serve.mid_spill`` fire point runs after the copy and before
        the blocks are freed. What it raises comes out as
        :class:`SpillError` (a ``RuntimeError``, ``MemoryError`` or
        ``ValueError`` is wrapped, as the reference wraps its host
        commit's), and the blocks stay allocated: the caller owns the
        cleanup. An error of the device copy itself is not wrapped."""
        host = self.snapshot(block_ids)
        try:
            _fault_fire("serve.mid_spill")
        except SpillError:
            raise
        except (RuntimeError, MemoryError, ValueError) as e:
            raise SpillError(
                f"host spill of {len(block_ids)} block(s) failed: {e}"
            ) from e
        self.allocator.free(list(block_ids))
        if telemetry_mode() != "off":
            metrics.counter("serving.kv_spills",
                            "sequence KV spills to host memory").inc()
        return host

    def restore(self, host_kv: HostKV, block_ids: Sequence[int]) -> None:
        """Scatter a spilled KV pair into freshly allocated blocks (ids may
        differ from the spilled ones; the caller rewrites the block table).
        Bitwise: the round trip is a copy, not a cast."""
        k_host, v_host = host_kv
        ids = self._ids(block_ids)
        if int(ids.shape[0]) != int(k_host.shape[1]):
            raise ValueError(
                f"restore of {k_host.shape[1]} blocks into "
                f"{ids.shape[0]} ids")
        # pinned host -> device copies are stream-ordered before the scatter;
        # the caching host allocator keeps the buffer alive until they end
        for pool, host in ((self.k, k_host), (self.v, v_host)):
            pool[:, ids] = host.to(self.device, non_blocking=self.pinned)
        if telemetry_mode() != "off":
            metrics.counter("serving.kv_restores",
                            "sequence KV restores from host memory").inc()

    def read_blocks(self, block_ids: Sequence[int]) -> HostKV:
        """Host copies of the given blocks (tests / debugging)."""
        ids = self._ids(block_ids)
        return self.k[:, ids].cpu(), self.v[:, ids].cpu()
