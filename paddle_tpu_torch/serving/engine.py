"""The serving engine: continuous batching over a paged KV cache.

Port of ``paddle_tpu/serving/engine.py``:

- **paged KV** (:mod:`.paged_cache`): every sequence's KV lives in
  fixed-size blocks of one device pool, allocated from a deterministic
  free list and spilled to pinned host memory under pressure;
- **continuous batching** (:mod:`.scheduler`): requests join and leave the
  decode batch at token-iteration granularity; the decode step runs every
  iteration over whoever is resident, padded to a batch-width bucket;
- **bucketed shapes** (:mod:`.buckets`): prefill lengths and decode widths
  are padded to small bucket sets.

Three throughput tiers compose on top, each off by default (``None``
reads its ``FLAGS_serve_*`` flag) and leaving the engine's behaviour
unchanged when off:

- **radix prefix sharing** (``prefix_cache``, :mod:`.prefix_tree`):
  prompts sharing a full-block prefix attach copy-on-write to the same
  pages through the refcounted allocator; only the suffix is prefilled,
  through the ``extend`` step. Eviction is LRU over refcount-0 trie
  leaves with a one-copy host spill tier;
- **chunked prefill** (``chunked_prefill``): long prompts prefill in
  whole-block chunks of at most the per-iteration token budget,
  interleaved with decode iterations, so a long prompt no longer freezes
  the resident decodes;
- **speculative decoding** (``speculative``, :mod:`.speculative`): a
  drafter (n-gram lookup, or a small LM over a mirrored paged pool)
  proposes gamma tokens that the target verifies in ONE ``extend``
  dispatch at a decode-bucket width (the greedy accept-prefix rule: the
  target's own token commits at the first mismatch).

The prefill step runs the model's flash-attention forward (the K1 kernel
on the GPU) on one bucket-padded prompt and writes the per-layer K/V into
the sequence's pages; a cold one-shot prefill takes it in every tier. The
decode step is a batched single-query pass that gathers each sequence's
pages (``single_query_attention`` masks the padded tail by context
length) and writes the new token's KV. The ``extend`` step is the
multi-token form (offset-causal over gathered pages,
:func:`_multi_query_attention`: plain tensor code, as JAX computes it
outside any kernel) shared by chunked prefill, suffix prefill after a
prefix hit and speculative verification. Every step updates the page
pool in place with ``index_put_``, where the JAX engine donates the pool
to its executables. Before every write the engine asserts that no real
write slot lands in a block the prefix tree holds.

A failing step raises: unlike the reference, the engine does not fail one
request and carry on. Where the reference's tier code ends a request
FAILED (a pool that can never grant it), the port raises with the same
message. Not ported (ROADMAP Queue 1 items 5 and 10): the resilience
knobs (``max_waiting``, ``max_spilled_bytes``, ``shed_policy``,
``journal``, ``validate_capacity``), per-request ``FAILED`` isolation,
deadlines, metrics, request timelines, recompile sentinels and
``compile_report``, the AOT ``trace_steps``/``compile_*`` and the static
plan (``_build_plan``) with its lint. Decoding is greedy (argmax),
matching ``GPTForCausalLM.generate``.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence as Seq

import numpy as np
import torch

from ..core import flags as _flags
from ..core.device import resolve_device, same_device
from ..ops.flash_attention import (_masked_softmax, flash_attention,
                                   single_query_attention)
from .buckets import BucketSet, pad_axis, pow2_buckets
from .paged_cache import NULL_BLOCK, PagedKVCache
from .prefix_tree import PrefixCache
from .scheduler import FCFSScheduler, Request, Sequence, Status
from .speculative import (DEFAULT_GAMMA, ModelDrafter, NGramDrafter,
                          pick_gamma, tune_gamma)

__all__ = ["ServingEngine"]


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _multi_query_attention(q, k, v, pos):
    """Offset-causal attention for the ``extend`` step: ``q`` is
    ``[B, L, H, D]`` (L query tokens at absolute positions ``pos``
    ``[B, L]``); ``k``/``v`` are ``[B, Sk, KH, D]`` gathered pages. Query
    ``(b, i)`` attends keys ``j <= pos[b, i]`` (its own KV was written
    before the gather, as the decode step's ``lengths = pos + 1``). The
    same GQA head reshape, f32 scores and masked-row-safe softmax as
    :func:`single_query_attention`, probabilities cast to q's dtype before
    the value product: agreement with the decode step is what keeps
    chunked and speculative outputs token-exact."""
    b, L, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, L, kh, g, d)
    scores = torch.einsum("blkgd,bskd->blkgs", qg.float(), k.float()) * scale
    valid = torch.arange(sk, device=q.device)[None, None, :] <= \
        pos[:, :, None]                                        # [B, L, Sk]
    scores = scores.masked_fill(~valid[:, :, None, None, :], float("-inf"))
    probs = _masked_softmax(scores).to(q.dtype)
    out = torch.einsum("blkgs,bskd->blkgd", probs, v)
    return out.reshape(b, L, h, d)


def _model_desc(cfg) -> str:
    return f"gpt_l{cfg.num_layers}_h{cfg.hidden_size}_v{cfg.vocab_size}"


class ServingEngine:
    """Paged-KV continuous-batching server over one causal-LM model.

    ``device=None`` means ``cuda:0`` and raises without CUDA; the model
    (and a :class:`ModelDrafter`'s model) must already be on the engine's
    device. Step accounting for benchmarks is kept in plain attributes:
    ``n_prefills`` (one-shot prefills, each one K1 launch a layer),
    ``n_extend_prefills`` (prefill spans through the ``extend`` step),
    ``n_preemptions``, ``prefill_tokens``/``prefill_s``, ``decode_ms``
    (one entry per decode or verify iteration, ``decode_tokens`` tokens
    committed in all), ``n_iterations``, ``peak_blocks_used`` and
    ``peak_live_blocks``."""

    def __init__(self, model, *, block_size: int = 8, num_blocks: int = 64,
                 max_batch: int = 8, max_seq_len: Optional[int] = None,
                 prefill_buckets: Optional[Seq[int]] = None,
                 decode_buckets: Optional[Seq[int]] = None,
                 detokenizer: Optional[Callable[[np.ndarray], Any]] = None,
                 prefix_cache: Optional[bool] = None,
                 chunked_prefill: Optional[int] = None,
                 speculative: Optional[int] = None,
                 drafter: Optional[Any] = None,
                 device=None):
        """Throughput knobs (``None`` reads the matching ``FLAGS_serve_*``
        flag): ``prefix_cache`` arms the radix prefix-sharing tree;
        ``chunked_prefill`` is the per-iteration prefill token budget
        (0 = one-shot prefill; rounded down to whole blocks, at least
        one); ``speculative`` is the draft depth gamma (0 = off, -1 = the
        autotune cache's choice for this target and drafter) with
        ``drafter`` an :class:`NGramDrafter` (the default) or a
        :class:`ModelDrafter`."""
        self.device = resolve_device(device)
        if not same_device(model.device, self.device):
            raise ValueError(f"model is on {model.device}, engine on "
                             f"{self.device}; move the model first")
        model.eval()
        cfg = model.cfg
        self.model = model
        self.block_size = int(block_size)
        limit = int(cfg.max_position_embeddings)
        self.max_seq_len = min(int(max_seq_len or limit), limit)
        self.max_blocks_per_seq = _ceil_div(self.max_seq_len, self.block_size)
        if num_blocks - 1 < self.max_blocks_per_seq:
            raise ValueError(
                f"pool of {num_blocks} blocks cannot hold one max-length "
                f"sequence ({self.max_blocks_per_seq} blocks of "
                f"{self.block_size})")
        self.detokenizer = detokenizer

        # prefill lengths: whole blocks, by default a power-of-two count
        max_prefill = self.max_blocks_per_seq * self.block_size
        if prefill_buckets is None:
            prefill_buckets = [min(b * self.block_size, max_prefill)
                               for b in pow2_buckets(
                                   1, self.max_blocks_per_seq)]
        for s in prefill_buckets:
            if s % self.block_size or s > max_prefill:
                raise ValueError(
                    f"prefill bucket {s} must be a multiple of "
                    f"block_size={self.block_size} and <= {max_prefill}")
        self.prefill_buckets = BucketSet(prefill_buckets)
        self.decode_buckets = BucketSet(
            decode_buckets if decode_buckets is not None
            else pow2_buckets(1, max_batch))

        # -- throughput tiers ------------------------------------------------
        self.prefix_on = bool(_flags.flag("serve_prefix_cache")) \
            if prefix_cache is None else bool(prefix_cache)
        chunk = int(_flags.flag("serve_chunked_prefill")) \
            if chunked_prefill is None else int(chunked_prefill)
        # the budget is whole blocks (a chunk writes whole blocks); a
        # sub-block budget rounds up to one block
        self.chunk_tokens = 0 if chunk <= 0 else max(
            self.block_size, (chunk // self.block_size) * self.block_size)
        spec = int(_flags.flag("serve_speculative")) \
            if speculative is None else int(speculative)
        self.drafter = None
        self.spec_gamma = 0
        self._draft_cache: Optional[PagedKVCache] = None
        if spec != 0:
            self.drafter = drafter if drafter is not None else NGramDrafter()
            d_desc = self.drafter.kind
            if isinstance(self.drafter, ModelDrafter):
                d_desc = _model_desc(self.drafter.model.cfg)
            t_desc = _model_desc(cfg)
            self.spec_gamma = spec if spec > 0 else pick_gamma(
                t_desc, d_desc, default=DEFAULT_GAMMA)
            self._spec_desc = (t_desc, d_desc)
        self._accept_lens: List[int] = []
        self.spec_stats = {"iterations": 0, "proposed": 0, "accepted": 0}

        # -- device state ----------------------------------------------------
        head_dim = cfg.hidden_size // cfg.num_heads
        self.cache = PagedKVCache(cfg.num_layers, num_blocks,
                                  self.block_size, cfg.kv_heads, head_dim,
                                  dtype=model.gpt.wte.weight.dtype,
                                  device=self.device)
        if isinstance(self.drafter, ModelDrafter):
            dm = self.drafter.model
            dcfg = dm.cfg
            if int(dcfg.vocab_size) != int(cfg.vocab_size):
                raise ValueError(
                    f"drafter vocab {dcfg.vocab_size} != target vocab "
                    f"{cfg.vocab_size}")
            if not same_device(dm.device, self.device):
                raise ValueError(f"drafter model is on {dm.device}, engine "
                                 f"on {self.device}; move it first")
            # the mirrored pool: the target's block ids and tables,
            # drafter-sized pages (its allocator is never used)
            self._draft_cache = PagedKVCache(
                dcfg.num_layers, num_blocks, self.block_size,
                dcfg.kv_heads, dcfg.hidden_size // dcfg.num_heads,
                dtype=dm.gpt.wte.weight.dtype, device=self.device)
        self.prefix = PrefixCache(self.cache, mirror=self._draft_cache) \
            if self.prefix_on else None
        self.sched = FCFSScheduler(max_batch)
        self._seqs: Dict[str, Sequence] = {}
        self.n_iterations = 0
        self.n_prefills = 0
        self.n_extend_prefills = 0
        self.n_preemptions = 0
        self.prefill_tokens = 0
        self.prefill_s = 0.0
        self.decode_ms: List[float] = []
        self.decode_tokens = 0
        self.peak_blocks_used = 0
        #: peak blocks referenced by live sequences (the tree's idle
        #: cache holds excluded: they evict on demand); the fair
        #: pool-pressure comparison across prefix-cache arms
        self.peak_live_blocks = 0

        # -- the steps -------------------------------------------------------
        self._prefill_fn = self._make_prefill()
        self._decode_fn = self._make_decode()
        self._chunk_fn = None
        if self.prefix_on or self.chunk_tokens:
            self._chunk_fn = self._make_extend(self.model, self.cache,
                                               last_only=True)
        self._verify_fn = None
        if self.spec_gamma:
            self._verify_fn = self._make_extend(self.model, self.cache,
                                                last_only=False)
        self._draft_decode_fn = None
        self._draft_extend_fn = None
        if self._draft_cache is not None:
            dm = self.drafter.model
            self._draft_decode_fn = self._make_decode(dm, self._draft_cache)
            self._draft_extend_fn = self._make_extend(
                dm, self._draft_cache, last_only=True)

    # ------------------------------------------------------------------
    # The bucketed steps
    # ------------------------------------------------------------------

    def _make_prefill(self, model=None, cache: Optional[PagedKVCache] = None):
        m = model if model is not None else self.model
        cache = cache if cache is not None else self.cache
        bs = self.block_size

        @torch.no_grad()
        def prefill(ids, block_ids, n_tokens: int):
            """ids [1, S] bucket-padded; block_ids [S//bs] (null-padded);
            n_tokens: true prompt length. Writes the prompt KV into the
            pages and returns the first generated token."""
            s = ids.shape[1]
            # pad slots of the last block may pass the position table: they
            # read its last row. (The JAX engine's gather gives NaN there,
            # which reaches the real rows through 0 * NaN in attention.)
            pos = torch.arange(s, device=ids.device).clamp_(
                max=m.cfg.max_position_embeddings - 1)[None, :]
            x = m.gpt.wte(ids) + m.gpt.wpe(pos)
            for li, blk in enumerate(m.gpt.h):
                xn = blk.ln_1(x)
                q, k, v = blk.attn._project_qkv(xn)
                o = flash_attention(q, k, v, causal=True, training=False)
                kv_shape = (s // bs, bs) + tuple(k.shape[2:])
                cache.k[li].index_put_(
                    (block_ids,), k[0].reshape(kv_shape).to(cache.dtype))
                cache.v[li].index_put_(
                    (block_ids,), v[0].reshape(kv_shape).to(cache.dtype))
                x = x + blk.attn.out_proj(o.reshape(1, s, -1))
                x = x + blk.mlp(blk.ln_2(x))
            hidden = m.gpt.ln_f(x)
            logits = m.logits(hidden[:, n_tokens - 1:n_tokens])[0, 0]
            return torch.argmax(logits, dim=-1)

        return prefill

    def _make_decode(self, model=None, cache: Optional[PagedKVCache] = None):
        m = model if model is not None else self.model
        cache = cache if cache is not None else self.cache
        bs = self.block_size

        @torch.no_grad()
        def decode(tokens, tables, ctx_lens):
            """tokens [B] (each sequence's latest token, not yet in KV);
            tables [B, M] null-padded block tables; ctx_lens [B] tokens
            already cached (0 = inactive pad row, which harmlessly writes
            the null block and produces a discarded output). Writes each
            token's KV at position ctx_len, attends over ctx_len+1 keys,
            returns the next token."""
            b = tokens.shape[0]
            mx = tables.shape[1] * bs
            pos = ctx_lens
            x = m.gpt.wte(tokens[:, None]) + m.gpt.wpe(pos[:, None])
            bi = torch.gather(tables, 1, (pos // bs)[:, None])[:, 0]
            si = pos % bs
            for li, blk in enumerate(m.gpt.h):
                xn = blk.ln_1(x)
                q, k, v = blk.attn._project_qkv(xn)
                # pad rows all write (NULL_BLOCK, 0): duplicate indices race,
                # harmless since block 0 is never read unmasked
                cache.k[li].index_put_((bi, si), k[:, 0].to(cache.dtype))
                cache.v[li].index_put_((bi, si), v[:, 0].to(cache.dtype))
                keys = cache.k[li][tables].reshape(b, mx, *k.shape[2:])
                vals = cache.v[li][tables].reshape(b, mx, *v.shape[2:])
                o = single_query_attention(q, keys, vals, lengths=pos + 1)
                x = x + blk.attn.out_proj(o.reshape(b, 1, -1))
                x = x + blk.mlp(blk.ln_2(x))
            hidden = m.gpt.ln_f(x)
            return torch.argmax(m.logits(hidden)[:, 0], dim=-1)

        return decode

    def _make_extend(self, model, cache: PagedKVCache,
                     last_only: bool = False):
        """The multi-token paged step: chunk prefill, prefix-hit suffix
        prefill and speculative verify are this one step at different
        (B, L) buckets. ``last_only=True`` (the chunk form) projects
        logits for each row's final real token only; the verify form
        needs the argmax at every position for the accept-prefix rule."""
        m = model
        bs = self.block_size

        @torch.no_grad()
        def extend(tokens, tables, ctx_lens, n_real):
            """tokens [B, L]; tables [B, M] null-padded; ctx_lens [B]
            tokens already cached per row; n_real [B] real tokens in this
            dispatch. Writes tokens[b, i]'s KV at position ctx_lens[b] + i
            (pad slots write the null block, duplicate indices and all)
            and returns the greedy argmax: [B, L] (every query), or [B]
            (each row's last real query) under ``last_only``."""
            b, L = tokens.shape
            mx = tables.shape[1] * bs
            ar = torch.arange(L, device=tokens.device)
            pos = ctx_lens[:, None] + ar[None, :]                   # [B, L]
            real = ar[None, :] < n_real[:, None]                    # [B, L]
            pos_q = torch.where(real, pos, torch.zeros_like(pos))
            x = m.gpt.wte(tokens) + m.gpt.wpe(pos_q)
            bi = torch.gather(tables, 1,
                              (pos // bs).clamp(0, tables.shape[1] - 1))
            bi = torch.where(real, bi, torch.full_like(bi, NULL_BLOCK))
            si = pos % bs
            for li, blk in enumerate(m.gpt.h):
                xn = blk.ln_1(x)
                q, k, v = blk.attn._project_qkv(xn)
                cache.k[li].index_put_((bi, si), k.to(cache.dtype))
                cache.v[li].index_put_((bi, si), v.to(cache.dtype))
                keys = cache.k[li][tables].reshape(b, mx, *k.shape[2:])
                vals = cache.v[li][tables].reshape(b, mx, *v.shape[2:])
                o = _multi_query_attention(q, keys, vals, pos_q)
                x = x + blk.attn.out_proj(o.reshape(b, L, -1))
                x = x + blk.mlp(blk.ln_2(x))
            hidden = m.gpt.ln_f(x)
            if last_only:
                idx = (n_real - 1).clamp(min=0)[:, None, None]
                last = torch.gather(
                    hidden, 1, idx.expand(b, 1, hidden.shape[-1]))
                return torch.argmax(m.logits(last)[:, 0], dim=-1)
            return torch.argmax(m.logits(hidden), dim=-1)

        return extend

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.int64)).to(self.device)

    # ------------------------------------------------------------------
    # Allocation, COW isolation, shared-block accounting
    # ------------------------------------------------------------------

    def _alloc(self, n: int) -> Optional[List[int]]:
        """Evict-aware allocation: on a shortfall the prefix tree evicts
        LRU refcount-0 leaves until the grant fits (or nothing is
        evictable). Without the tree this is ``allocator.alloc``."""
        got = self.cache.allocator.alloc(n)
        if got is None and self.prefix is not None:
            # evict with headroom: the per-token alloc(1) pattern would
            # otherwise pay a tree scan per block under pressure
            deficit = max(n - self.cache.allocator.n_free, 4)
            if self.prefix.evict(deficit) > 0:
                got = self.cache.allocator.alloc(n)
        if got is not None:
            self.peak_blocks_used = max(self.peak_blocks_used,
                                        self.cache.allocator.n_used)
        return got

    def _assert_cow(self, write_ids) -> None:
        """No step may write a device block the prefix tree holds: shared
        pages are immutable; only the private tail is ever written.
        ``write_ids`` are the blocks of one dispatch's real write slots,
        every row's together."""
        if self.prefix is None:
            return
        bad = self.prefix.device_block_ids().intersection(
            int(i) for i in write_ids)
        if bad:
            raise AssertionError(
                f"COW write-isolation violated: dispatch would write "
                f"shared prefix blocks {sorted(bad)}")

    def _write_span_ids(self, seq: Sequence, start: int, n: int
                        ) -> List[int]:
        """Block ids covering token positions [start, start+n)."""
        if n <= 0:
            return []
        lo, hi = start // self.block_size, (start + n - 1) // self.block_size
        return seq.block_ids[lo:hi + 1]

    def _private_blocks(self, seq: Sequence) -> int:
        """Blocks a preemption of this sequence would actually free: its
        refcount-1 private tail, not the shared tree pages."""
        return len(seq.block_ids) - seq.n_shared_blocks

    def _cost_fn(self):
        """Victim-selection cost, armed only with the prefix cache (the
        flag-off victim order stays the historical one)."""
        return self._private_blocks if self.prefix is not None else None

    def _free_seq_blocks(self, seq: Sequence) -> None:
        """One exit for a sequence's device blocks: release the tree
        attachments (the tree's own ref keeps shared pages resident) and
        free the private tail."""
        if seq.prefix_nodes:
            self.prefix.release(seq.prefix_nodes)
            seq.prefix_nodes = []
        private = seq.block_ids[seq.n_shared_blocks:]
        if private:
            self.cache.allocator.free(private)
        seq.block_ids = []
        seq.n_shared_blocks = 0

    def _update_peaks(self) -> None:
        used = self.cache.allocator.n_used
        self.peak_blocks_used = max(self.peak_blocks_used, used)
        live = used - (self.prefix.n_idle_device_blocks()
                       if self.prefix is not None else 0)
        self.peak_live_blocks = max(self.peak_live_blocks, live)

    def reset_peaks(self) -> None:
        """Restart the peak-blocks watermarks (a benchmark's arm measures
        the steady state, not the warmup)."""
        self.peak_blocks_used = 0
        self.peak_live_blocks = 0
        self._update_peaks()

    # ------------------------------------------------------------------
    # Request lifecycle
    # ------------------------------------------------------------------

    def submit(self, request: Request) -> Sequence:
        """Queue one request. A total that can never fit ``max_seq_len``,
        or a prompt past the largest prefill bucket, raises."""
        total = request.prompt_ids.size + request.max_new_tokens
        if total > self.max_seq_len:
            raise ValueError(
                f"request {request.rid!r}: prompt {request.prompt_ids.size} "
                f"+ max_new_tokens {request.max_new_tokens} exceeds "
                f"max_seq_len {self.max_seq_len}")
        self.prefill_buckets.fit(request.prompt_ids.size)
        seq = Sequence(request)
        seq.t_submit = time.perf_counter()
        self._seqs[request.rid] = seq
        self.sched.submit(seq)
        self._update_peaks()
        return seq

    def _try_admit(self) -> bool:
        seq = self.sched.peek_waiting()
        if seq is None or not self.sched.has_capacity():
            return False
        if seq.status is Status.PREEMPTED:
            return self._admit_restore(seq)
        return self._admit_extend(seq)

    def _admit_restore(self, seq: Sequence) -> bool:
        """Re-admit a preempted sequence: restore its spilled private
        blocks (a shared prefix never left the device: its refs were kept
        through the preemption)."""
        ids = self._alloc(int(seq.host_kv[0].shape[1]))
        if ids is None:
            return False
        self.sched.admit(seq)
        self._restore(seq, ids)
        return True

    def _admit_extend(self, seq: Sequence) -> bool:
        """Admit a new request: attach to the longest cached full-block
        prefix copy-on-write, allocate blocks for the first prefill span
        (the whole suffix, or one chunk under the budget), and prefill
        inline (one-shot) or leave the sequence to the chunk iterations.
        With both tiers off this is the one-shot K1 admission: allocate
        the whole prompt's blocks or wait for running sequences to free
        them."""
        prompt = seq.request.prompt_ids
        chain: List[Any] = []
        shared_ids: List[int] = []
        if self.prefix is not None and not seq.prefix_nodes:
            chain = self.prefix.match(prompt)
            if chain:
                shared_ids = self.prefix.attach(seq.rid, chain, self._alloc)
                chain = chain[:len(shared_ids)]
        cached = len(shared_ids) * self.block_size
        span = seq.prompt_len - cached
        if self.chunk_tokens:
            span = min(span, self.chunk_tokens)
        n_new = _ceil_div(cached + span, self.block_size) - len(shared_ids)
        ids = self._alloc(n_new)
        if ids is None:
            if chain:
                self.prefix.release(chain)      # clean retry next round
            if not self.sched.running and \
                    self.cache.allocator.n_used == len(
                        self.prefix.device_block_ids()
                        if self.prefix is not None else ()):
                raise RuntimeError(
                    f"request {seq.rid!r} needs {n_new} KV block(s) beyond "
                    f"the shared prefix, pool has only "
                    f"{self.cache.allocator.n_free}")
            return False
        self.sched.admit(seq)
        if self.prefix is not None:
            self.prefix.account(seq.prompt_len, cached)
        if not self.chunk_tokens and cached == 0:
            # cold full prompt, no chunk budget: the one-shot flash prefill
            # (it inserts the finished blocks into the tree)
            self._prefill(seq, ids)
            return True
        seq.add_phase("queue", time.perf_counter() - seq.t_enqueue)
        seq.prefix_nodes = list(chain)
        seq.n_shared_blocks = len(shared_ids)
        seq.block_ids = shared_ids + ids
        seq.block_log.extend(shared_ids + ids)
        seq.ctx_len = cached
        seq.prefill_pos = cached
        if self.chunk_tokens:
            return True             # the chunk iterations take it from here
        self._chunk_prefill(seq, span)
        return True

    def _prefill(self, seq: Sequence, block_ids: List[int]) -> None:
        now = time.perf_counter()
        seq.add_phase("queue", now - seq.t_enqueue)
        bucket = self.prefill_buckets.fit(seq.prompt_len)
        ids = pad_axis(seq.request.prompt_ids[None, :], 1, bucket)
        btab = np.full((bucket // self.block_size,), NULL_BLOCK, np.int64)
        btab[:len(block_ids)] = block_ids
        self._assert_cow(block_ids)
        tok = self._prefill_fn(self._to_device(ids), self._to_device(btab),
                               seq.prompt_len)
        tok = int(tok)  # host sync: honest prefill timing
        seq.block_ids = list(block_ids)
        seq.block_log.extend(block_ids)
        seq.ctx_len = seq.prompt_len
        seq.prefill_pos = seq.prompt_len
        seq.out_tokens.append(tok)
        seq.t_first_token = time.perf_counter()
        dur = seq.t_first_token - now
        seq.add_phase("prefill", dur)
        self.n_prefills += 1
        self.prefill_tokens += seq.prompt_len
        self.prefill_s += dur
        self._mirror_draft_prefill(seq)
        if self.prefix is not None:
            new_nodes = self.prefix.insert(
                seq.request.prompt_ids, seq.block_ids, seq.prompt_len,
                have=len(seq.prefix_nodes))
            seq.prefix_nodes += new_nodes
            seq.n_shared_blocks = len(seq.prefix_nodes)
        if seq.is_finished_by(tok):
            self._finish(seq)

    def _chunk_prefill(self, seq: Sequence, span: int) -> None:
        """Prefill ``span`` prompt tokens through the ``extend`` step from
        ``seq.prefill_pos`` (a block boundary): the prefix-hit suffix and
        the chunked-prefill paths. The final span commits the first
        generated token; every completed full block goes into the prefix
        tree as it fills."""
        now = time.perf_counter()
        start = seq.prefill_pos
        L = self.prefill_buckets.fit(span)
        toks = pad_axis(
            seq.request.prompt_ids[None, start:start + span], 1, L)
        table = np.full((1, self.max_blocks_per_seq), NULL_BLOCK, np.int64)
        table[0, :len(seq.block_ids)] = seq.block_ids
        args = (self._to_device(toks), self._to_device(table),
                self._to_device([start]), self._to_device([span]))
        self._assert_cow(self._write_span_ids(seq, start, span))
        out = self._chunk_fn(*args).cpu().numpy()  # host sync: honest timing
        if self._draft_extend_fn is not None:
            self._draft_extend_fn(*args)
            seq.draft_ctx = start + span
        seq.prefill_pos = start + span
        seq.ctx_len = seq.prefill_pos
        if self.prefix is not None:
            new_nodes = self.prefix.insert(
                seq.request.prompt_ids, seq.block_ids, seq.prefill_pos,
                have=len(seq.prefix_nodes))
            seq.prefix_nodes += new_nodes
            seq.n_shared_blocks = len(seq.prefix_nodes)
        dur = time.perf_counter() - now
        seq.add_phase("chunk_prefill", dur)
        self.n_extend_prefills += 1
        self.prefill_tokens += span
        self.prefill_s += dur
        if seq.prefill_pos >= seq.prompt_len:
            tok = int(out[0])       # last_only: each row's last real argmax
            seq.out_tokens.append(tok)
            seq.t_first_token = time.perf_counter()
            if seq.is_finished_by(tok):
                self._finish(seq)

    def _mirror_draft_prefill(self, seq: Sequence) -> None:
        """ModelDrafter: write the drafter's prompt KV into the mirrored
        pool (same block table) after a one-shot target prefill, through
        the drafter's ``extend`` step, as the reference does."""
        if self._draft_extend_fn is None or not seq.block_ids:
            return
        p = seq.prompt_len
        L = self.prefill_buckets.fit(p)
        toks = pad_axis(seq.request.prompt_ids[None, :], 1, L)
        table = np.full((1, self.max_blocks_per_seq), NULL_BLOCK, np.int64)
        table[0, :len(seq.block_ids)] = seq.block_ids
        self._draft_extend_fn(self._to_device(toks), self._to_device(table),
                              self._to_device([0]), self._to_device([p]))
        seq.draft_ctx = p

    def _chunk_iteration(self) -> None:
        """The chunked-prefill slot: at most ``chunk_tokens`` prompt tokens
        prefill per engine iteration (the oldest mid-prefill resident goes
        first), interleaved with the decode work."""
        if not self.chunk_tokens:
            return
        for seq in list(self.sched.running):
            if seq.status is not Status.RUNNING or \
                    seq.prefill_pos >= seq.prompt_len:
                continue
            span = min(self.chunk_tokens, seq.prompt_len - seq.prefill_pos)
            needed = _ceil_div(seq.prefill_pos + span, self.block_size)
            while len(seq.block_ids) < needed:
                got = self._alloc(1)
                if got is not None:
                    seq.block_ids.extend(got)
                    seq.block_log.extend(got)
                    continue
                victim = self.sched.preempt_victim(exclude=seq,
                                                   cost=self._cost_fn())
                if victim is None:
                    raise RuntimeError(
                        f"sequence {seq.rid!r} needs block "
                        f"{len(seq.block_ids) + 1} of {needed} mid-prefill "
                        "and there is nothing left to preempt — the "
                        "request outgrew the pool")
                self._preempt(victim)
            self._chunk_prefill(seq, span)
            break                     # one chunk per iteration: the budget

    def _restore(self, seq: Sequence, ids: List[int]) -> None:
        now = time.perf_counter()
        seq.add_phase("queue", now - seq.t_enqueue)
        self.cache.restore(seq.host_kv, ids)
        if self._draft_cache is not None and seq.host_draft_kv is not None:
            self._draft_cache.restore(seq.host_draft_kv, ids)
            seq.host_draft_kv = None
        seq.host_kv = None
        seq.spilled_bytes = 0
        # the shared prefix never left the device: the table is (pinned
        # shared ids) + (freshly restored private ids)
        seq.block_ids = seq.block_ids[:seq.n_shared_blocks] + list(ids)
        seq.block_log.append(-1)  # spill/restore boundary
        seq.block_log.extend(ids)
        # KV re-materialization substitutes for prefill on resume
        seq.add_phase("prefill", time.perf_counter() - now)

    def _preempt(self, seq: Sequence) -> None:
        self.sched.preempt(seq)
        shared = seq.n_shared_blocks
        private = seq.block_ids[shared:]
        # refcount-aware spill: the shared prefix pages stay on the device
        # (this sequence keeps its refs); only the private tail moves
        if self._draft_cache is not None and private:
            seq.host_draft_kv = self._draft_cache.snapshot(private)
        seq.host_kv = self.cache.spill(private)
        seq.block_ids = seq.block_ids[:shared]
        draft_bytes = (self._draft_cache.bytes_per_block * len(private)
                       if self._draft_cache is not None else 0)
        seq.spilled_bytes = (len(private) * self.cache.bytes_per_block
                             + draft_bytes)
        # queue time restarts now; t_submit stays the true arrival
        seq.t_requeue = time.perf_counter()
        self.n_preemptions += 1

    # -- the decode iteration ------------------------------------------------

    def _decodable(self) -> List[Sequence]:
        """Resident sequences with a committed frontier token (a
        mid-prefill chunked sequence is resident but not yet
        decodable)."""
        return [s for s in self.sched.iteration_batch() if s.out_tokens]

    def _lookahead(self, seq: Sequence) -> int:
        """Draft positions a speculative iteration may write past
        ``ctx_len``: gamma, cut where the block table ends (the reference
        has no cut and fails there)."""
        room = self.max_blocks_per_seq * self.block_size - seq.ctx_len - 1
        return max(0, min(self.spec_gamma, room))

    def _ensure_decode_blocks(self) -> None:
        """Every decodable sequence needs real blocks through position
        ctx_len (+ the draft positions under speculation) before the next
        iteration; preempt (lowest priority, most private blocks under
        the prefix cache, else youngest) to make room."""
        for seq in list(self.sched.running):
            if seq.status is not Status.RUNNING or not seq.out_tokens:
                continue
            needed = (seq.ctx_len + self._lookahead(seq)) \
                // self.block_size + 1
            while len(seq.block_ids) < needed:
                got = self._alloc(1)
                if got is not None:
                    seq.block_ids.extend(got)
                    seq.block_log.extend(got)
                    continue
                victim = self.sched.preempt_victim(exclude=seq,
                                                   cost=self._cost_fn())
                if victim is None:  # ruled out by the capacity check
                    raise RuntimeError(
                        f"sequence {seq.rid!r} needs block "
                        f"{len(seq.block_ids) + 1} of {needed} and there is "
                        "nothing left to preempt")
                self._preempt(victim)

    def _decode_iteration(self) -> List[Sequence]:
        batch = self._decodable()
        if not batch:
            return []
        if self.spec_gamma:
            return self._spec_iteration(batch)
        t0 = time.perf_counter()
        width = self.decode_buckets.fit(len(batch))
        tokens = np.zeros((width,), np.int64)
        tables = np.full((width, self.max_blocks_per_seq), NULL_BLOCK,
                         np.int64)
        lens = np.zeros((width,), np.int64)
        for i, seq in enumerate(batch):
            tokens[i] = seq.out_tokens[-1]
            tables[i, :len(seq.block_ids)] = seq.block_ids
            lens[i] = seq.ctx_len
        self._assert_cow([i for seq in batch
                          for i in self._write_span_ids(seq, seq.ctx_len, 1)])
        out = self._decode_fn(self._to_device(tokens),
                              self._to_device(tables), self._to_device(lens))
        out = out.cpu().numpy()  # host sync per iteration (token commit)
        dur = time.perf_counter() - t0
        self.decode_ms.append(dur * 1e3)
        self.decode_tokens += len(batch)
        finished: List[Sequence] = []
        for i, seq in enumerate(batch):
            seq.add_phase("decode", dur)
            seq.ctx_len += 1
            tok = int(out[i])
            seq.out_tokens.append(tok)
            if seq.is_finished_by(tok):
                finished.append(seq)
        for seq in finished:
            self._finish(seq)
        return finished

    # -- speculative decoding ------------------------------------------------

    def _draft_proposals(self, batch: List[Sequence], width: int,
                         tables: np.ndarray) -> List[List[int]]:
        """Per-sequence proposals (each at most its lookahead). The n-gram
        drafter is host work; the ModelDrafter runs sequential decode
        steps over the mirrored pool. Each feed writes the fed token's KV
        at its position, catch-up feeds (committed tokens whose drafter KV
        a rejection invalidated) first."""
        depth = [self._lookahead(s) for s in batch]
        if not isinstance(self.drafter, ModelDrafter):
            return [self.drafter.propose(
                list(s.request.prompt_ids) + s.out_tokens, g)
                for s, g in zip(batch, depth)]
        hists = [list(int(t) for t in s.request.prompt_ids) + s.out_tokens
                 for s in batch]
        feeds = [h[s.draft_ctx:] for h, s in zip(hists, batch)]
        # feeds ends with the frontier token t0 (KV absent); catch-up
        # length is len(feeds)-1; one proposal lands per feed from t0 on
        steps = max(len(f) - 1 for f in feeds) + self.spec_gamma
        proposals: List[List[int]] = [[] for _ in batch]
        cur = [list(f) for f in feeds]
        pos0 = [s.draft_ctx for s in batch]
        d_tables = self._to_device(tables)
        for t in range(steps):
            toks = np.zeros((width,), np.int64)
            ctxs = np.zeros((width,), np.int64)
            for i, seq in enumerate(batch):
                hi = min(t, len(cur[i]) - 1)
                toks[i] = cur[i][hi] if t < len(cur[i]) else cur[i][-1]
                ctxs[i] = min(pos0[i] + t, seq.ctx_len + depth[i])
            out = self._draft_decode_fn(self._to_device(toks), d_tables,
                                        self._to_device(ctxs))
            out = out.cpu().numpy()
            for i in range(len(batch)):
                catchup = len(feeds[i]) - 1
                if t >= catchup and len(proposals[i]) < depth[i]:
                    proposals[i].append(int(out[i]))
                    cur[i].append(int(out[i]))
        return proposals

    def _spec_iteration(self, batch: List[Sequence]) -> List[Sequence]:
        """One speculative iteration: draft proposals per resident
        sequence, verify the whole batch in ONE ``extend`` step at a
        decode-bucket width, and commit each row's accepted prefix plus
        the target's own token at the first mismatch (1..gamma+1 tokens):
        exactly the target's greedy stream, drafts or no drafts."""
        gamma = self.spec_gamma
        L = gamma + 1
        width = self.decode_buckets.fit(len(batch))
        tables = np.full((width, self.max_blocks_per_seq), NULL_BLOCK,
                         np.int64)
        for i, seq in enumerate(batch):
            tables[i, :len(seq.block_ids)] = seq.block_ids
        t0 = time.perf_counter()
        proposals = self._draft_proposals(batch, width, tables)
        t_draft = time.perf_counter() - t0
        tokens = np.zeros((width, L), np.int64)
        lens = np.zeros((width,), np.int64)
        n_real = np.zeros((width,), np.int64)
        for i, seq in enumerate(batch):
            fed = [seq.out_tokens[-1]] + proposals[i]
            tokens[i, :len(fed)] = fed
            lens[i] = seq.ctx_len
            n_real[i] = len(fed)
        self._assert_cow([j for i, seq in enumerate(batch)
                          for j in self._write_span_ids(seq, seq.ctx_len,
                                                        int(n_real[i]))])
        out = self._verify_fn(self._to_device(tokens),
                              self._to_device(tables), self._to_device(lens),
                              self._to_device(n_real))
        out = out.cpu().numpy()
        dur = time.perf_counter() - t0
        t_verify = dur - t_draft
        self.decode_ms.append(dur * 1e3)
        self.spec_stats["iterations"] += 1
        finished: List[Sequence] = []
        for i, seq in enumerate(batch):
            seq.add_phase("draft", t_draft)
            seq.add_phase("verify", t_verify)
            props = proposals[i]
            o = out[i]
            accepted = 0
            while accepted < len(props) and \
                    props[accepted] == int(o[accepted]):
                accepted += 1
            committed = [int(props[j]) for j in range(accepted)]
            committed.append(int(o[accepted]))
            self.spec_stats["proposed"] += len(props)
            self.spec_stats["accepted"] += accepted
            self._accept_lens.append(accepted)
            ctx0 = seq.ctx_len
            done = False
            for tok in committed:
                seq.out_tokens.append(tok)
                seq.ctx_len += 1
                self.decode_tokens += 1
                if seq.is_finished_by(tok):
                    done = True
                    break
            if isinstance(self.drafter, ModelDrafter):
                # drafter KV is valid through the accepted prefix it fed
                # (t0 + the accepted proposals it chained); the fallback
                # token's KV is next round's catch-up feed
                seq.draft_ctx = min(ctx0 + 1 + min(accepted, gamma - 1)
                                    if gamma > 1 else ctx0 + 1,
                                    seq.ctx_len)
            if done:
                finished.append(seq)
        for seq in finished:
            self._finish(seq)
        return finished

    def record_spec_tuning(self) -> Optional[int]:
        """Store the accepted-length-derived gamma for this target and
        drafter in the autotune cache (read by ``speculative=-1``).
        Returns the stored gamma."""
        if not self.spec_gamma or not self._accept_lens:
            return None
        return tune_gamma(self._spec_desc[0], self._spec_desc[1],
                          self._accept_lens)

    def _finish(self, seq: Sequence) -> None:
        t0 = time.perf_counter()
        self.sched.finish(seq)
        self._free_seq_blocks(seq)
        seq.output = seq.full_output()
        if self.detokenizer is not None:
            seq.text = self.detokenizer(seq.output)
        seq.add_phase("detokenize", time.perf_counter() - t0)

    # ------------------------------------------------------------------
    # Driving loop
    # ------------------------------------------------------------------

    def step(self) -> List[Sequence]:
        """One scheduler iteration: admit whatever fits (prefill or
        restore), run one prefill chunk under the chunked budget, top up
        decode blocks (preempting under pressure), run one decode (or
        speculative) iteration. Returns the sequences that finished."""
        n0 = len(self.sched.finished)
        while self._try_admit():
            pass
        self._chunk_iteration()
        self._ensure_decode_blocks()
        self._decode_iteration()
        self._update_peaks()
        self.n_iterations += 1
        return self.sched.finished[n0:]

    def serve(self, requests: Seq[Request],
              respect_arrivals: bool = False) -> Dict[str, Sequence]:
        """Drive the trace to completion; returns rid -> Sequence (with
        ``.output``, and ``.text`` under a detokenizer).
        ``respect_arrivals`` replays each request's ``arrival_s`` offset
        instead of submitting everything up front."""
        order = sorted(requests, key=lambda r: r.arrival_s) \
            if respect_arrivals else list(requests)
        t0 = time.perf_counter()
        idx = 0
        done: Dict[str, Sequence] = {}
        while idx < len(order) or self.sched.n_pending:
            now = time.perf_counter() - t0
            while idx < len(order) and (
                    not respect_arrivals or order[idx].arrival_s <= now):
                self.submit(order[idx])
                idx += 1
            if not self.sched.n_pending:
                if idx < len(order) and respect_arrivals:
                    time.sleep(
                        max(0.0, order[idx].arrival_s -
                            (time.perf_counter() - t0)))
                continue
            for seq in self.step():
                done[seq.rid] = seq
        self.sched.assert_idle()
        return done

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------

    def prefix_report(self) -> Dict[str, Any]:
        """Prefix-sharing effectiveness: hit rate, live tree size, and the
        pool-pressure headline (peak blocks in use)."""
        rep = {
            "enabled": self.prefix is not None,
            "peak_blocks_used": self.peak_blocks_used,
            "peak_live_blocks": self.peak_live_blocks,
            "blocks_shared_now": self.cache.allocator.n_shared,
        }
        if self.prefix is not None:
            rep.update({
                "hit_rate": round(self.prefix.hit_rate(), 4),
                "hit_tokens": self.prefix.hit_tokens,
                "lookup_tokens": self.prefix.lookup_tokens,
                "tree_nodes": self.prefix.n_nodes,
                "device_blocks_held": len(self.prefix.device_block_ids()),
            })
        return rep

    def spec_report(self) -> Dict[str, Any]:
        """Speculative-decoding effectiveness: acceptance and the mean
        committed tokens per verify dispatch."""
        it = self.spec_stats["iterations"]
        prop = self.spec_stats["proposed"]
        acc = self.spec_stats["accepted"]
        rows = len(self._accept_lens)   # per-sequence verify samples
        return {
            "enabled": bool(self.spec_gamma),
            "gamma": self.spec_gamma,
            "drafter": getattr(self.drafter, "kind", None),
            "iterations": it,
            "proposed": prop,
            "accepted": acc,
            "accept_rate": round(acc / prop, 4) if prop else 0.0,
            "mean_accept_len": round(acc / rows, 4) if rows else 0.0,
            "tokens_per_verify": round((acc + rows) / rows, 4)
            if rows else 0.0,
        }
