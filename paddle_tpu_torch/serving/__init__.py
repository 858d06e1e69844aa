"""paddle_tpu_torch.serving — continuous batching over a paged KV cache.

Port of ``paddle_tpu/serving``: a block-paged KV cache in device memory
with a deterministic refcounted free-list allocator and pinned host spill
for preempted sequences, a continuous-batching FCFS scheduler, bucketed
prefill/decode shapes, and the three throughput tiers: radix prefix
sharing (:class:`PrefixCache`), chunked prefill, and speculative decoding
(:class:`NGramDrafter`, :class:`ModelDrafter`, with the draft depth in the
autotune cache). Prefill runs the flash-attention forward kernel (K1) on
the GPU.
"""

from .buckets import BucketSet, pad_axis, pow2_buckets  # noqa: F401
from .engine import ServingEngine  # noqa: F401
from .paged_cache import BlockAllocator, NULL_BLOCK, PagedKVCache  # noqa: F401
from .prefix_tree import PrefixCache, PrefixNode  # noqa: F401
from .scheduler import (FCFSScheduler, Request, Sequence,  # noqa: F401
                        Status, TERMINAL_STATUSES)
from .speculative import (ModelDrafter, NGramDrafter,  # noqa: F401
                          pick_gamma, store_gamma, tune_gamma)

__all__ = [
    "BlockAllocator", "BucketSet", "FCFSScheduler", "ModelDrafter",
    "NGramDrafter", "NULL_BLOCK", "PagedKVCache", "PrefixCache",
    "PrefixNode", "Request", "Sequence", "ServingEngine", "Status",
    "TERMINAL_STATUSES", "pad_axis", "pick_gamma", "pow2_buckets",
    "store_gamma", "tune_gamma",
]
