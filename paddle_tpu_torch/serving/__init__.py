"""paddle_tpu_torch.serving — continuous batching over a paged KV cache.

Port of ``paddle_tpu/serving`` on its flag-off path: a block-paged KV cache
in device memory with a deterministic free-list allocator and pinned host
spill for preempted sequences, a continuous-batching FCFS scheduler, and
bucketed prefill/decode shapes. Prefill runs the flash-attention forward
kernel (K1) on the GPU.
"""

from .buckets import BucketSet, pad_axis, pow2_buckets  # noqa: F401
from .engine import ServingEngine  # noqa: F401
from .paged_cache import BlockAllocator, NULL_BLOCK, PagedKVCache  # noqa: F401
from .scheduler import (FCFSScheduler, Request, Sequence,  # noqa: F401
                        Status, TERMINAL_STATUSES)

__all__ = [
    "BlockAllocator", "BucketSet", "FCFSScheduler", "NULL_BLOCK",
    "PagedKVCache", "Request", "Sequence",
    "ServingEngine", "Status", "TERMINAL_STATUSES", "pad_axis",
    "pow2_buckets",
]
