"""Radix prefix-sharing KV cache: a token trie over immutable full blocks.

Port of ``paddle_tpu/serving/prefix_tree.py`` (the RadixAttention idea,
SGLang, Zheng et al. 2023). Every **full** KV block of a committed prompt
(``block_size`` tokens; the ragged tail block stays private) becomes a
node whose edge label is its token tuple. A new request walks the trie
with its own prompt and attaches copy-on-write to every page it matches:
no prefill compute and no new device memory for the shared span; only the
suffix is computed and stored privately.

Ownership is refcounts on :class:`~.paged_cache.BlockAllocator`: each
attached sequence holds one ref per shared block, and the tree holds one
*cache* ref of its own, so pages outlive the request that made them.
``seq_refs`` (live attachments) drives eviction: LRU over refcount-0
leaves. Eviction spills a node that earned a re-use **once** to the host
tier (:meth:`~.paged_cache.PagedKVCache.snapshot`, pinned memory on a
GPU); a later match restores it bitwise into a fresh block, for every
current and future sharer. A node never re-matched is dropped.

Write isolation: tree-resident blocks are immutable. The engine asserts
before every write that no write slot lands in :meth:`device_block_ids`.

Matching is capped at ``prompt_len - 1`` tokens: the engine always
recomputes the final prompt token, whose logits give the first generated
token.

The JAX module's ``serving.prefix_*`` gauges and counters wait for the
port's observability tier; their values stay readable here
(:meth:`hit_rate`, ``hit_tokens``, ``lookup_tokens``, :attr:`n_nodes`,
``evictions``) and through ``ServingEngine.prefix_report``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .paged_cache import PagedKVCache

__all__ = ["PrefixCache", "PrefixNode"]


class PrefixNode:
    """One full KV block of some committed prompt prefix.

    ``key`` is the block's token tuple (the trie edge label);
    ``block_id`` is its device page while resident, ``host_kv`` the
    one-copy host spill while evicted. ``seq_refs`` counts live
    sequence attachments; ``last_use`` is the LRU tick.
    """

    __slots__ = ("key", "parent", "children", "block_id", "host_kv",
                 "seq_refs", "last_use", "hits")

    def __init__(self, key: Tuple[int, ...], parent: Optional["PrefixNode"]):
        self.key = key
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "PrefixNode"] = {}
        self.block_id: Optional[int] = None
        self.host_kv = None
        self.seq_refs = 0
        self.last_use = 0
        self.hits = 0       # attach events beyond the inserting sequence

    @property
    def on_device(self) -> bool:
        return self.block_id is not None


class PrefixCache:
    """The trie + its ownership/eviction policy over one paged pool."""

    def __init__(self, cache: PagedKVCache,
                 mirror: Optional[PagedKVCache] = None):
        self.cache = cache
        self.bs = cache.block_size
        #: optional drafter pool mirroring the target pool 1:1 by block
        #: id (speculative decoding) — its pages spill/restore alongside
        self.mirror = mirror
        self.root = PrefixNode((), None)
        self._tick = 0
        self._nodes = 0
        # kept up to date by attach/insert/release/evict, so the engine's
        # per-dispatch COW check and per-step peaks walk no trie
        self._held: set = set()     # device blocks the tree holds
        self._idle = 0              # of those, nodes with seq_refs == 0
        # cumulative hit accounting (hit_rate)
        self.hit_tokens = 0
        self.lookup_tokens = 0
        #: blocks evicted (spilled or dropped)
        self.evictions = 0

    # -- bookkeeping ---------------------------------------------------------

    def _touch(self, node: PrefixNode) -> None:
        self._tick += 1
        node.last_use = self._tick

    def _blocks_of(self, prompt_ids: np.ndarray,
                   limit: Optional[int] = None) -> List[Tuple[int, ...]]:
        """Full-block token tuples of a prompt, capped at ``limit``
        blocks (``None`` = every full block)."""
        ids = np.asarray(prompt_ids).reshape(-1)
        n_full = ids.size // self.bs
        if limit is not None:
            n_full = min(n_full, limit)
        return [tuple(int(t) for t in ids[i * self.bs:(i + 1) * self.bs])
                for i in range(n_full)]

    def device_block_ids(self) -> frozenset:
        """Every device block the tree currently holds — the engine's
        per-dispatch COW write-isolation assert set."""
        return frozenset(self._held)

    @property
    def n_nodes(self) -> int:
        return self._nodes

    def n_idle_device_blocks(self) -> int:
        """Device blocks held ONLY as cache (seq_refs == 0) — evictable
        on demand, so they don't count against live pool pressure."""
        return self._idle

    def hit_rate(self) -> float:
        """Cumulative fraction of looked-up prompt tokens served from
        the tree (JAX's ``serving.prefix_hit_rate`` gauge)."""
        if not self.lookup_tokens:
            return 0.0
        return self.hit_tokens / self.lookup_tokens

    # -- match / attach ------------------------------------------------------

    def match(self, prompt_ids: np.ndarray) -> List[PrefixNode]:
        """The longest chain of tree nodes covering full blocks of the
        prompt's first ``prompt_len - 1`` tokens (device- or
        host-resident — attach restores the spilled ones). Pure lookup:
        no refs taken, no LRU advance."""
        ids = np.asarray(prompt_ids).reshape(-1)
        keys = self._blocks_of(ids, limit=max(0, (ids.size - 1) // self.bs))
        chain: List[PrefixNode] = []
        node = self.root
        for key in keys:
            child = node.children.get(key)
            if child is None:
                break
            chain.append(child)
            node = child
        return chain

    def attach(self, seq_rid: str, chain: Sequence[PrefixNode],
               alloc_fn) -> List[int]:
        """Take one sequence ref on every node of ``chain``, restoring
        host-resident nodes into fresh blocks (``alloc_fn(n) ->
        Optional[List[int]]`` — the engine's evict-aware allocator).
        Returns the chain's device block ids in order. On an allocation
        shortfall the chain is attached only up to the last restorable
        node (the caller prefills the rest — a partial hit, not an
        error)."""
        out: List[int] = []
        for node in chain:
            if not node.on_device:
                got = alloc_fn(1)
                if got is None:
                    break
                self.cache.restore(node.host_kv[0], got)
                if self.mirror is not None and node.host_kv[1] is not None:
                    self.mirror.restore(node.host_kv[1], got)
                node.block_id = got[0]
                node.host_kv = None
                self._held.add(node.block_id)
                # the restore consumed alloc's refcount-1 grant as the
                # tree's own cache hold
            elif node.seq_refs == 0:
                self._idle -= 1
            node.seq_refs += 1
            node.hits += 1
            self.cache.allocator.ref([node.block_id])
            self._touch(node)
            out.append(node.block_id)
        return out

    def account(self, prompt_len: int, hit_len: int) -> None:
        """Record one successful admission's lookup/hit token counts
        (the hit rate's input) — called once per admitted sequence,
        never on retried admission attempts."""
        self.lookup_tokens += int(prompt_len)
        self.hit_tokens += int(hit_len)

    # -- insert --------------------------------------------------------------

    def insert(self, prompt_ids: np.ndarray, block_ids: Sequence[int],
               filled_tokens: int, have: int = 0) -> List[PrefixNode]:
        """Register the fully-written blocks of a (possibly partially
        prefilled) prompt: block *i* is inserted once its ``block_size``
        tokens are all committed AND ``block_ids[i]`` is the device page
        holding them. ``have`` is the caller's existing chain length
        (attached or previously inserted nodes) — only keys past it are
        processed, making progressive chunked insertion idempotent.

        A newly inserted node takes the tree's cache ref on the block
        (``allocator.ref``) and inherits the inserting sequence's
        attachment (``seq_refs = 1`` — the sequence's original alloc
        ref IS its attachment, so release() is uniform across attached
        and inserted nodes). A key that already exists under a
        *different* block (two cold prefills raced the same prefix)
        stops the insertion — the remainder stays private. Returns the
        NEW nodes only; the caller appends them to its chain."""
        limit = min(int(filled_tokens) // self.bs, len(block_ids))
        keys = self._blocks_of(prompt_ids, limit=limit)
        node = self.root
        for key in keys[:have]:
            node = node.children[key]
        new: List[PrefixNode] = []
        for i in range(have, len(keys)):
            key = keys[i]
            child = node.children.get(key)
            if child is not None:
                if child.block_id != int(block_ids[i]):
                    break       # concurrent duplicate: keep ours private
                node = child
                continue
            child = PrefixNode(key, node)
            child.block_id = int(block_ids[i])
            child.seq_refs = 1
            node.children[key] = child
            self._nodes += 1
            self._held.add(child.block_id)
            self.cache.allocator.ref([child.block_id])
            self._touch(child)
            new.append(child)
            node = child
        return new

    # -- release / evict -----------------------------------------------------

    def release(self, chain: Sequence[PrefixNode]) -> None:
        """Drop one sequence ref per node (the sequence's terminal exit
        or its preemption hand-back). The tree's cache ref keeps the
        page resident until eviction needs it."""
        for node in chain:
            if node.seq_refs < 1:
                raise ValueError(
                    f"release of unattached prefix node {node.key[:4]}...")
            node.seq_refs -= 1
            if node.seq_refs == 0:
                self._idle += 1
            self.cache.allocator.free([node.block_id])

    def _evictable(self) -> List[PrefixNode]:
        out = []
        stack = [self.root]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if (n is not self.root and n.on_device and n.seq_refs == 0
                    and not any(c.on_device for c in n.children.values())):
                out.append(n)
        return out

    def evict(self, n_blocks: int, spill: bool = True) -> int:
        """Free up to ``n_blocks`` device blocks, LRU-first over
        refcount-0 leaves. A victim that earned at least one re-use
        (``hits > 0``) is snapshotted to the host tier exactly once —
        one host copy no matter how many future sharers restore it; a
        never-re-matched page is simply dropped (a D2H on the
        allocation critical path must be earned). ``spill=False``
        forces the drop path (hard pressure: even host memory refused).
        The device block returns to the free list via the tree's last
        ref. Returns the number of blocks actually freed."""
        freed = 0
        cands: List[PrefixNode] = []
        while freed < n_blocks:
            if not cands:
                # one scan amortizes a batch of evictions; a parent only
                # becomes evictable after its children go, so the list
                # is re-scanned when it runs dry
                cands = sorted(self._evictable(),
                               key=lambda nd: -nd.last_use)
            if not cands:
                break
            victim = cands.pop()
            # retain a node that earned a re-use, or that anchors a
            # (host-resident) subtree the match path still walks
            keep = spill and (victim.hits > 0 or bool(victim.children))
            if keep:
                host = self.cache.snapshot([victim.block_id])
                mhost = (self.mirror.snapshot([victim.block_id])
                         if self.mirror is not None else None)
                victim.host_kv = (host, mhost)
            self.cache.allocator.free([victim.block_id])
            self._held.discard(victim.block_id)
            self._idle -= 1
            victim.block_id = None
            if not keep:
                self._drop(victim)
            self.evictions += 1
            freed += 1
        return freed

    def _drop(self, node: PrefixNode) -> None:
        """Remove a node (and its subtree — callers only drop leaves)
        from the trie entirely."""
        if node.parent is not None:
            node.parent.children.pop(node.key, None)
            self._nodes -= 1

    def drop_host_tier(self) -> int:
        """Forget every host-spilled node (frees host memory; future
        matches for those prefixes miss and re-prefill). Returns the
        count dropped."""
        dropped = 0
        stack = [self.root]
        victims = []
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n is not self.root and not n.on_device and not n.children:
                victims.append(n)
        for n in victims:
            self._drop(n)
            dropped += 1
        return dropped

    def assert_consistent(self) -> None:
        """Test hook: every device node's block is allocator-owned with
        refcount >= 1 + seq_refs, no node is both resident and spilled,
        and the held set and idle count agree with the trie."""
        held, idle = set(), 0
        stack = [self.root]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n is self.root:
                continue
            if n.on_device:
                held.add(n.block_id)
                idle += n.seq_refs == 0
                assert n.host_kv is None
                rc = self.cache.allocator.refcount(n.block_id)
                assert rc >= 1 + n.seq_refs, \
                    (n.key, n.block_id, rc, n.seq_refs)
            else:
                assert n.host_kv is not None or n.children
        assert held == self._held and idle == self._idle, \
            (sorted(held ^ self._held), idle, self._idle)
