"""paddle_tpu_torch.serving — continuous batching over a paged KV cache.

Port of ``paddle_tpu/serving``: a block-paged KV cache in device memory
with a deterministic refcounted free-list allocator and pinned host spill
for preempted sequences, a continuous-batching FCFS scheduler, bucketed
prefill/decode shapes, and the three throughput tiers: radix prefix
sharing (:class:`PrefixCache`), chunked prefill, and speculative decoding
(:class:`NGramDrafter`, :class:`ModelDrafter`, with the draft depth in the
autotune cache), and the resilience tier: bounded admission with a typed
:class:`Rejected`, deadlines, load shedding (:class:`ShedPolicy`), the
exactly-once :class:`RequestJournal` and per-request failure isolation.
Prefill runs the flash-attention forward kernel (K1) on the GPU.
"""

from .buckets import BucketSet, pad_axis, pow2_buckets  # noqa: F401
from .engine import ServingEngine  # noqa: F401
from .paged_cache import (BlockAllocator, NULL_BLOCK,  # noqa: F401
                          OutOfBlocksError, PagedKVCache, SpillError)
from .prefix_tree import PrefixCache, PrefixNode  # noqa: F401
from .resilience import (Rejected, RequestJournal,  # noqa: F401
                         ShedPolicy, prompt_hash)
from .scheduler import (FCFSScheduler, Request, Sequence,  # noqa: F401
                        Status, TERMINAL_STATUSES)
from .speculative import (ModelDrafter, NGramDrafter,  # noqa: F401
                          pick_gamma, store_gamma, tune_gamma)

__all__ = [
    "BlockAllocator", "BucketSet", "FCFSScheduler", "ModelDrafter",
    "NGramDrafter", "NULL_BLOCK", "OutOfBlocksError", "PagedKVCache",
    "PrefixCache", "PrefixNode", "Rejected", "Request", "RequestJournal",
    "Sequence", "ServingEngine", "ShedPolicy", "SpillError", "Status",
    "TERMINAL_STATUSES", "pad_axis", "pick_gamma", "pow2_buckets",
    "prompt_hash", "store_gamma", "tune_gamma",
]
