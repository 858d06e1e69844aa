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

The resilience knobs are ported (``max_waiting``, ``max_spilled_bytes``,
``shed_policy``, ``journal``, ``validate_capacity``): bounded admission
answers with a typed :class:`~.resilience.Rejected`, deadlines expire
requests at iteration granularity, the shed policy sheds or degrades under
overload (``mode``: healthy, shedding or degraded), the journal records
every submission and acknowledgment, and a request that outgrows the pool
or loses its spill ends FAILED with an F003 record in ``diagnostics``
while the loop goes on. Unlike the reference, which fails one request
for any ``Exception``, the engine isolates only what is the request's
own: :class:`~.paged_cache.OutOfBlocksError`,
:class:`~.paged_cache.SpillError` (also what the ``serve.mid_spill`` fire
point raises) and a ``ValueError`` raised outside the kernel wrappers. A
kernel's launch error (:class:`~paddle_tpu_torch.ops._hopper.
KernelLaunchError`), any CUDA error and anything raised in
``ops/_hopper`` stop ``serve()``: no fault of a kernel ends as a quietly
FAILED request.

Telemetry (:mod:`paddle_tpu_torch.observability`, under
``FLAGS_telemetry``) is wired as in the reference, under the same names:
the ``serving.*`` counters, gauges and histograms; one request-timeline
record per ending (phases, ``ttft_ms``, ``total_ms``, preemptions, the
deadline); and one recompile sentinel per step kind, whose signature counts
:meth:`ServingEngine.compile_report` holds against the bucket budget. Unlike
the reference's engine, which reports under every flag value,
``FLAGS_telemetry=off`` (read at each ``submit`` and ``step``) switches
all of it off, the pool's and the prefix tree's series too, as the flag's
help promises.

Not ported: the AOT ``trace_steps``/``compile_*`` and the static plan
(``_build_plan``) with its lint, the live fleet exporter's progress note,
and the subprocess kill-and-replay drill. Decoding is greedy (argmax), as
the reference engine's is; sampling lives in ``GPTForCausalLM.generate``.
"""

from __future__ import annotations

import math
import os
import time
import traceback
from collections import deque
from typing import (Any, Callable, Dict, List, Optional, Sequence as Seq,
                    Union)

import numpy as np
import torch

from ..analysis.diagnostics import Diagnostic, emit
from ..core import flags as _flags
from ..core.device import resolve_device, same_device
from ..fault.injection import fire as _fault_fire
from ..observability import metrics, request_timeline
from ..observability.request_timeline import percentile
from ..observability.step_monitor import RecompileSentinel
from ..observability.trace import telemetry_mode
from ..ops.flash_attention import (_masked_softmax, flash_attention,
                                   single_query_attention)
from .buckets import BucketSet, pad_axis, pow2_buckets
from .paged_cache import (NULL_BLOCK, OutOfBlocksError, PagedKVCache,
                          SpillError)
from .prefix_tree import PrefixCache
from .resilience import Rejected, RequestJournal, ShedPolicy
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


#: the errors that fail one request and not the loop: its own
_ISOLATED = (OutOfBlocksError, SpillError, ValueError)
_KERNEL_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "ops", "_hopper") + os.sep


def _isolable(e: BaseException) -> bool:
    """Whether ``e`` is a request's own failure: one of ``_ISOLATED``, not
    raised inside a kernel wrapper (``ops/_hopper``). A launch error
    (``KernelLaunchError``) and CUDA errors are ``RuntimeError``s outside
    ``_ISOLATED``; they and a wrapper's refusal stop the loop."""
    if not isinstance(e, _ISOLATED):
        return False
    return not any(os.path.abspath(f.filename).startswith(_KERNEL_DIR)
                   for f in traceback.extract_tb(e.__traceback__))


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
    ``peak_live_blocks``; the resilience tier's ``rejections``,
    ``diagnostics`` (F003 records) and ``mode``."""

    def __init__(self, model, *, block_size: int = 8, num_blocks: int = 64,
                 max_batch: int = 8, max_seq_len: Optional[int] = None,
                 prefill_buckets: Optional[Seq[int]] = None,
                 decode_buckets: Optional[Seq[int]] = None,
                 detokenizer: Optional[Callable[[np.ndarray], Any]] = None,
                 max_waiting: Optional[int] = None,
                 max_spilled_bytes: Optional[int] = None,
                 shed_policy: Optional[ShedPolicy] = None,
                 journal: Optional[RequestJournal] = None,
                 validate_capacity: bool = True,
                 prefix_cache: Optional[bool] = None,
                 chunked_prefill: Optional[int] = None,
                 speculative: Optional[int] = None,
                 drafter: Optional[Any] = None,
                 device=None):
        """Resilience knobs (all off by default): ``max_waiting`` and
        ``max_spilled_bytes`` bound admission (an over-budget submission
        returns a typed :class:`Rejected`), ``shed_policy`` arms load
        shedding, ``journal`` records admitted-request state for
        exactly-once replay, and ``validate_capacity=False`` lets a pool
        smaller than one max-length sequence serve: a request that
        outgrows it ends FAILED instead of the constructor refusing.

        Throughput knobs (``None`` reads the matching ``FLAGS_serve_*``
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
        if validate_capacity and num_blocks - 1 < self.max_blocks_per_seq:
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
        self.sched = FCFSScheduler(max_batch, max_waiting=max_waiting)
        self._seqs: Dict[str, Sequence] = {}
        #: FLAGS_telemetry != "off", read at each submit and step
        self._telemetry = telemetry_mode() != "off"
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

        # -- resilience state ------------------------------------------------
        self.max_spilled_bytes = max_spilled_bytes
        self.shed_policy = shed_policy
        self.journal = journal
        self.rejections: List[Rejected] = []
        self.diagnostics: List[Diagnostic] = []   # F003, newest last
        self.mode = "healthy"                # healthy | shedding | degraded
        self._spilled_bytes = 0
        self._degraded_width: Optional[int] = None
        #: the shed policy's rolling window of decode-iteration times (ms)
        self._decode_window: deque = deque(
            maxlen=shed_policy.window if shed_policy else 64)
        if journal is not None:
            journal.launch()

        # -- the steps and their sentinels (the reference's thresholds:
        # a step kind's budget of signatures is its bucket count) ----------
        self._prefill_fn = self._make_prefill()
        self._decode_fn = self._make_decode()
        self._sent_prefill = RecompileSentinel(
            threshold=len(self.prefill_buckets))
        self._sent_decode = RecompileSentinel(
            threshold=len(self.decode_buckets))
        self._chunk_fn = None
        self._sent_chunk = None
        if self.prefix_on or self.chunk_tokens:
            self._chunk_fn = self._make_extend(self.model, self.cache,
                                               last_only=True)
            self._sent_chunk = RecompileSentinel(
                threshold=len(self.prefill_buckets))
        self._verify_fn = None
        self._sent_verify = None
        if self.spec_gamma:
            self._verify_fn = self._make_extend(self.model, self.cache,
                                                last_only=False)
            self._sent_verify = RecompileSentinel(
                threshold=len(self.decode_buckets))
        self._draft_decode_fn = None
        self._draft_extend_fn = None
        self._sent_draft = None
        if self._draft_cache is not None:
            dm = self.drafter.model
            self._draft_decode_fn = self._make_decode(dm, self._draft_cache)
            self._draft_extend_fn = self._make_extend(
                dm, self._draft_cache, last_only=True)
            self._sent_draft = RecompileSentinel(
                threshold=len(self.decode_buckets) +
                len(self.prefill_buckets))

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

    def _gauges(self) -> None:
        """The peak-blocks watermarks and the engine's gauges."""
        used = self.cache.allocator.n_used
        self.peak_blocks_used = max(self.peak_blocks_used, used)
        live = used - (self.prefix.n_idle_device_blocks()
                       if self.prefix is not None else 0)
        self.peak_live_blocks = max(self.peak_live_blocks, live)
        if not self._telemetry:
            return
        metrics.gauge("serving.queue_depth",
                      "requests waiting for admission").set(
                          len(self.sched.waiting))
        metrics.gauge("serving.running",
                      "sequences resident in the decode batch").set(
                          len(self.sched.running))
        usable = self.cache.num_blocks - 1
        metrics.gauge("serving.free_block_frac",
                      "free fraction of the usable KV pool (the shed "
                      "policy's admission signal)").set(
                          self.cache.allocator.n_free / usable
                          if usable else 0.0)
        p99 = percentile(list(self._decode_window), 99)
        if p99 is not None:
            metrics.gauge("serving.decode_p99_ms",
                          "sliding-window decode-iteration p99 (ms, "
                          "the shed policy's latency signal)").set(p99)

    def reset_peaks(self) -> None:
        """Restart the peak-blocks watermarks (a benchmark's arm measures
        the steady state, not the warmup)."""
        self.peak_blocks_used = 0
        self.peak_live_blocks = 0
        self._gauges()

    # ------------------------------------------------------------------
    # Request lifecycle
    # ------------------------------------------------------------------

    def submit(self, request: Request) -> Union[Sequence, Rejected]:
        """Queue one request, or answer with a typed :class:`Rejected` when
        the bounded queue or the host-spill budget is over capacity. A
        malformed request (a total that can never fit ``max_seq_len``, or
        a prompt past the largest prefill bucket) raises: a client contract
        error, not overload."""
        total = request.prompt_ids.size + request.max_new_tokens
        if total > self.max_seq_len:
            raise ValueError(
                f"request {request.rid!r}: prompt {request.prompt_ids.size} "
                f"+ max_new_tokens {request.max_new_tokens} exceeds "
                f"max_seq_len {self.max_seq_len}")
        self.prefill_buckets.fit(request.prompt_ids.size)
        self._telemetry = telemetry_mode() != "off"
        if self._telemetry:
            metrics.counter("serving.requests", "requests submitted").inc()
        if not self.sched.can_accept():
            return self._reject(
                request, "queue_full",
                f"waiting queue at max_waiting={self.sched.max_waiting}")
        if (self.max_spilled_bytes is not None
                and self._spilled_bytes > self.max_spilled_bytes):
            return self._reject(
                request, "spill_budget",
                f"host spill {self._spilled_bytes}B over budget "
                f"{self.max_spilled_bytes}B")
        seq = Sequence(request)
        seq.t_submit = time.perf_counter()
        self._seqs[request.rid] = seq
        if self.journal is not None:
            self.journal.submitted(request)
        self.sched.submit(seq)
        self._gauges()
        return seq

    def _reject(self, request: Request, reason: str,
                detail: str) -> Rejected:
        rej = Rejected(request.rid, reason, detail)
        self.rejections.append(rej)
        if self.journal is not None:
            self.journal.terminal(request.rid, "rejected", reason)
        if self._telemetry:
            metrics.counter("serving.rejected",
                            "submissions refused by bounded admission").inc()
            request_timeline.current().record(
                rid=request.rid, prompt_tokens=request.prompt_ids.size,
                new_tokens=0, phases_ms={}, total_ms=0.0,
                outcome="rejected", error=f"{reason}: {detail}",
                deadline_ms=(None if request.deadline_s is None
                             else request.deadline_s * 1e3))
        return rej

    # -- terminal non-success paths (isolation, deadlines, shedding) ---------

    def _cancel(self, seq: Sequence, status: Status, reason: str,
                *, diagnose: bool = False) -> None:
        """The one exit for every non-FINISHED ending: scheduler
        retirement, reclamation of the device blocks and the host-spill
        copy, the journal's acknowledgment."""
        self.sched.retire(seq, status)
        self._free_seq_blocks(seq)
        if seq.host_kv is not None:
            seq.host_kv = None
            seq.host_draft_kv = None
            self._account_spill(-seq.spilled_bytes)
            seq.spilled_bytes = 0
        seq.error = reason
        seq.t_done = time.perf_counter()
        outcome = status.value
        if diagnose:
            self._diagnose_failure(seq, reason)
        if self.journal is not None:
            self.journal.terminal(seq.rid, outcome, reason)
        if self._telemetry:
            metrics.counter(f"serving.{outcome}",
                            f"requests ending {outcome}").inc()
            self._record(seq, outcome, error=reason)
        self._gauges()

    def _record(self, seq: Sequence, outcome: str,
                error: Optional[str] = None) -> None:
        """The request timeline's record of one ending."""
        req = seq.request
        request_timeline.current().record(
            rid=seq.rid, prompt_tokens=seq.prompt_len,
            new_tokens=seq.n_generated,
            phases_ms={k: v * 1e3 for k, v in seq.phase_s.items()},
            total_ms=(seq.t_done - seq.t_submit) * 1e3,
            ttft_ms=((seq.t_first_token - seq.t_submit) * 1e3
                     if seq.t_first_token is not None else None),
            preemptions=seq.preemptions, outcome=outcome, error=error,
            deadline_ms=(None if req.deadline_s is None
                         else req.deadline_s * 1e3))

    def _fail(self, seq: Sequence, e: BaseException) -> None:
        """Fail ``seq`` for ``e`` if it is the request's own error
        (:func:`_isolable`); re-raise anything else."""
        if not _isolable(e):
            raise e
        self._cancel(seq, Status.FAILED, f"{type(e).__name__}: {e}",
                     diagnose=True)

    def _diagnose_failure(self, seq: Sequence, reason: str) -> None:
        d = Diagnostic(
            rule="F003", name="serving-request-failed", severity="warning",
            message=f"request {seq.rid!r} failed after "
                    f"{seq.n_generated} token(s): {reason}",
            hint="the failure is isolated to this request; the engine "
                 "loop continues and its blocks were reclaimed",
            where="serving.engine")
        self.diagnostics.append(d)
        # an operational finding: printed even under
        # FLAGS_static_analysis=off, as in the reference
        emit([d], where="serving.engine", mode="warn")

    def _account_spill(self, delta_bytes: int) -> None:
        self._spilled_bytes = max(0, self._spilled_bytes + delta_bytes)
        if self._telemetry:
            metrics.gauge("serving.spilled_bytes",
                          "bytes of preempted KV held in the host "
                          "tier").set(self._spilled_bytes)

    def _expire_deadlines(self) -> None:
        """Cancel every live sequence past its deadline, at iteration
        granularity, measured from the true submission time (``t_submit``
        is never rewritten by a preemption)."""
        now = time.perf_counter()
        for seq in list(self.sched.waiting) + list(self.sched.running):
            d = seq.request.deadline_s
            if d is not None and now - seq.t_submit > d:
                self._cancel(seq, Status.EXPIRED,
                             f"deadline {d * 1e3:.0f}ms exceeded "
                             f"({(now - seq.t_submit) * 1e3:.0f}ms elapsed)")

    def _apply_shed_policy(self) -> None:
        """One policy consult an iteration: set ``mode``, shed at most one
        request (lowest priority, then most private blocks under the
        prefix cost model, youngest last; waiting first), and in degraded
        mode compute the smaller decode-bucket cap."""
        pol = self.shed_policy
        if pol is None:
            return
        usable = self.cache.num_blocks - 1
        free_frac = self.cache.allocator.n_free / usable if usable else 0.0
        why = pol.overloaded(free_frac,
                             percentile(list(self._decode_window), 99))
        if why is None:
            self.mode = "healthy"
            self._degraded_width = None
            return
        self.mode = "degraded" if pol.degrade else "shedding"
        if self._telemetry:
            metrics.counter("serving.overload_iterations",
                            "iterations spent in shed/degraded mode").inc()
        # degrade mode keeps residents (they get a smaller bucket); pure
        # shed mode may drop running work to free blocks
        victim = self.sched.shed_candidate(waiting_only=pol.degrade,
                                           cost=self._cost_fn())
        if victim is not None:
            self._cancel(victim, Status.SHED, f"load shed: {why}")
        if pol.degrade and len(self.sched.running) > 1:
            fit = self.decode_buckets.fit(len(self.sched.running))
            smaller = [b for b in self.decode_buckets.sizes if b < fit]
            self._degraded_width = smaller[-1] if smaller else 1

    def _enforce_degraded_width(self) -> None:
        """Degraded mode shrinks the active decode bucket: preempt the
        lowest-priority residents (the normal spill path) until the batch
        fits the smaller bucket."""
        cap = self._degraded_width
        if cap is None:
            return
        while len(self.sched.running) > cap:
            victim = self.sched.preempt_victim(cost=self._cost_fn())
            if victim is None:
                break
            self._preempt_or_fail(victim)

    def _preempt_or_fail(self, victim: Sequence) -> None:
        """Preempt ``victim``; a failed spill fails it alone."""
        try:
            self._preempt(victim)
        except SpillError as e:
            if not _isolable(e):
                raise
            self._cancel(victim, Status.FAILED, f"KV spill failed: {e}",
                         diagnose=True)

    def _try_admit(self) -> bool:
        if self.mode != "healthy":
            return False            # overload: pause fresh admissions
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
        try:
            self._restore(seq, ids)
        except _ISOLATED as e:
            if not set(ids) <= set(seq.block_ids):
                self.cache.allocator.free(ids)
            self._fail(seq, e)
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
                # an idle pool that cannot grant the front request never
                # will: fail it (isolation) and keep going
                what = "" if self.prefix is None and not self.chunk_tokens \
                    else " beyond the shared prefix"
                self._cancel(
                    seq, Status.FAILED,
                    f"needs {n_new} KV block(s){what}, pool has only "
                    f"{self.cache.allocator.n_free}", diagnose=True)
                return True
            return False
        self.sched.admit(seq)
        if self.prefix is not None:
            self.prefix.account(seq.prompt_len, cached)
        if not self.chunk_tokens and cached == 0:
            # cold full prompt, no chunk budget: the one-shot flash prefill
            # (it inserts the finished blocks into the tree)
            try:
                self._prefill(seq, ids)
            except _ISOLATED as e:
                if not seq.block_ids:
                    seq.block_ids = list(ids)
                self._fail(seq, e)
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
        try:
            self._chunk_prefill(seq, span)
        except _ISOLATED as e:
            self._fail(seq, e)
        return True

    def _prefill(self, seq: Sequence, block_ids: List[int]) -> None:
        now = time.perf_counter()
        seq.add_phase("queue", now - seq.t_enqueue)
        bucket = self.prefill_buckets.fit(seq.prompt_len)
        ids = pad_axis(seq.request.prompt_ids[None, :], 1, bucket)
        btab = np.full((bucket // self.block_size,), NULL_BLOCK, np.int64)
        btab[:len(block_ids)] = block_ids
        self._assert_cow(block_ids)
        args = (self._to_device(ids), self._to_device(btab), seq.prompt_len)
        if self._telemetry:
            self._sent_prefill.observe_tree(
                "serving.prefill", args, donate=(1, 2),
                where="serving.prefill")
        tok = int(self._prefill_fn(*args))  # host sync: honest timing
        seq.block_ids = list(block_ids)
        seq.block_log.extend(block_ids)
        seq.ctx_len = seq.prompt_len
        seq.prefill_pos = seq.prompt_len
        seq.out_tokens.append(tok)
        seq.t_first_token = time.perf_counter()
        dur = seq.t_first_token - now
        seq.add_phase("prefill", dur)
        if self._telemetry:
            metrics.histogram("serving.prefill_ms",
                              "prefill step wall time (ms)").observe(
                                  dur * 1e3)
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
        if self._telemetry:
            self._sent_chunk.observe_tree(
                "serving.extend", args, donate=(1, 2),
                where="serving.extend")
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
        if self._telemetry:
            if self.chunk_tokens:
                metrics.counter(
                    "serving.chunked_prefill_iterations",
                    "prefill chunks interleaved with decode").inc()
            metrics.histogram("serving.prefill_ms",
                              "prefill step wall time (ms)").observe(
                                  dur * 1e3)
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
            ok = True
            while len(seq.block_ids) < needed:
                got = self._alloc(1)
                if got is not None:
                    seq.block_ids.extend(got)
                    seq.block_log.extend(got)
                    continue
                victim = self.sched.preempt_victim(exclude=seq,
                                                   cost=self._cost_fn())
                if victim is None:
                    self._cancel(
                        seq, Status.FAILED,
                        f"needs block {len(seq.block_ids) + 1} of "
                        f"{needed} mid-prefill and there is nothing "
                        "left to preempt — the request outgrew the pool",
                        diagnose=True)
                    ok = False
                    break
                self._preempt_or_fail(victim)
            if ok:
                try:
                    self._chunk_prefill(seq, span)
                except _ISOLATED as e:
                    self._fail(seq, e)
            break                     # one chunk per iteration: the budget

    def _restore(self, seq: Sequence, ids: List[int]) -> None:
        now = time.perf_counter()
        seq.add_phase("queue", now - seq.t_enqueue)
        self.cache.restore(seq.host_kv, ids)
        if self._draft_cache is not None and seq.host_draft_kv is not None:
            self._draft_cache.restore(seq.host_draft_kv, ids)
            seq.host_draft_kv = None
        seq.host_kv = None
        self._account_spill(-seq.spilled_bytes)
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
        self._account_spill(seq.spilled_bytes)
        # queue time restarts now; t_submit stays the true arrival
        seq.t_requeue = time.perf_counter()
        self.n_preemptions += 1
        if self._telemetry:
            metrics.counter("serving.preemptions",
                            "sequences preempted for KV capacity").inc()

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
        the prefix cache, else youngest) to make room. Pool exhaustion
        with nothing left to preempt fails *that* sequence (F003)."""
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
                if victim is None:
                    err = OutOfBlocksError(
                        f"sequence {seq.rid!r} needs block "
                        f"{len(seq.block_ids) + 1} of {needed} and there "
                        "is nothing left to preempt — the request "
                        "outgrew the pool")
                    self._cancel(seq, Status.FAILED, str(err),
                                 diagnose=True)
                    break
                self._preempt_or_fail(victim)

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
        args = (self._to_device(tokens), self._to_device(tables),
                self._to_device(lens))
        if self._telemetry:
            self._sent_decode.observe_tree(
                "serving.decode", args, donate=(1, 2),
                where="serving.decode")
        out = self._decode_fn(*args)
        out = out.cpu().numpy()  # host sync per iteration (token commit)
        # the seam after the iteration's compute, before any of its tokens
        # is committed
        _fault_fire("serve.mid_decode")
        dur = time.perf_counter() - t0
        self.decode_ms.append(dur * 1e3)
        self._decode_window.append(dur * 1e3)
        if self._telemetry:
            metrics.histogram("serving.decode_step_ms",
                              "decode iteration wall time (ms)").observe(
                                  dur * 1e3)
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
            dargs = (self._to_device(toks), d_tables, self._to_device(ctxs))
            if t == 0 and self._telemetry:
                self._sent_draft.observe_tree(
                    "serving.draft", dargs, donate=(1, 2),
                    where="serving.draft")
            out = self._draft_decode_fn(*dargs)
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
        args = (self._to_device(tokens), self._to_device(tables),
                self._to_device(lens), self._to_device(n_real))
        if self._telemetry:
            self._sent_verify.observe_tree(
                "serving.verify", args, donate=(1, 2),
                where="serving.verify")
        out = self._verify_fn(*args).cpu().numpy()
        _fault_fire("serve.mid_decode")
        dur = time.perf_counter() - t0
        t_verify = dur - t_draft
        self.decode_ms.append(dur * 1e3)
        self._decode_window.append(dur * 1e3)
        if self._telemetry:
            metrics.histogram("serving.decode_step_ms",
                              "decode iteration wall time (ms)").observe(
                                  dur * 1e3)
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
            if self._telemetry:
                metrics.histogram(
                    "serving.spec_accept_len",
                    "draft tokens accepted per speculative iteration"
                ).observe(accepted)
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
        # acknowledge before the detokenizer: once the journal holds the
        # done record (fsynced), a relaunch does not replay this request
        if self.journal is not None:
            self.journal.done(seq.rid, seq.out_tokens)
        if self.detokenizer is not None:
            seq.text = self.detokenizer(seq.output)
        seq.t_done = time.perf_counter()
        seq.add_phase("detokenize", seq.t_done - t0)
        if self._telemetry:
            self._record(seq, "ok")

    # ------------------------------------------------------------------
    # Driving loop
    # ------------------------------------------------------------------

    def step(self) -> List[Sequence]:
        """One scheduler iteration: expire deadlines, consult the shed
        policy, admit whatever fits (prefill or restore), run one prefill
        chunk under the chunked budget, top up decode blocks (preempting
        under pressure), run one decode (or speculative) iteration.
        Returns every sequence that reached a terminal state this
        iteration: FINISHED, and EXPIRED, SHED or FAILED."""
        n0 = len(self.sched.finished)
        self._telemetry = telemetry_mode() != "off"
        self._expire_deadlines()
        self._apply_shed_policy()
        self._enforce_degraded_width()
        while self._try_admit():
            pass
        self._chunk_iteration()
        self._ensure_decode_blocks()
        self._decode_iteration()
        self._gauges()
        self.n_iterations += 1
        return self.sched.finished[n0:]

    def serve(self, requests: Seq[Request],
              respect_arrivals: bool = False
              ) -> Dict[str, Union[Sequence, Rejected]]:
        """Drive the trace to completion; returns rid -> Sequence (with
        ``.output``, and ``.text`` under a detokenizer; check ``.status``
        for the EXPIRED, SHED and FAILED endings) or the :class:`Rejected`
        answer of a request bounded admission refused.
        ``respect_arrivals`` replays each request's ``arrival_s`` offset
        instead of submitting everything up front."""
        order = sorted(requests, key=lambda r: r.arrival_s) \
            if respect_arrivals else list(requests)
        t0 = time.perf_counter()
        idx = 0
        done: Dict[str, Union[Sequence, Rejected]] = {}
        while idx < len(order) or self.sched.n_pending:
            now = time.perf_counter() - t0
            while idx < len(order) and (
                    not respect_arrivals or order[idx].arrival_s <= now):
                res = self.submit(order[idx])
                if isinstance(res, Rejected):
                    done[res.rid] = res
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

    def compile_report(self) -> Dict[str, Any]:
        """Distinct step signatures dispatched against the bucket budget:
        the reference's "at most n_buckets compilations, O001 silent"
        check. In the port a new signature's first dispatch pays the
        first-use kernel build, autotune and allocator growth."""
        n_pre = len(self._sent_prefill._seen.get("serving.prefill", ()))
        n_dec = len(self._sent_decode._seen.get("serving.decode", ()))
        n_ext = (len(self._sent_chunk._seen.get("serving.extend", ()))
                 if self._sent_chunk is not None else 0)
        n_ver = (len(self._sent_verify._seen.get("serving.verify", ()))
                 if self._sent_verify is not None else 0)
        ext_budget = (self._sent_chunk.threshold
                      if self._sent_chunk is not None else 0)
        ver_budget = (self._sent_verify.threshold
                      if self._sent_verify is not None else 0)
        sentinels = (self._sent_prefill, self._sent_decode, self._sent_chunk,
                     self._sent_verify, self._sent_draft)
        return {
            "prefill_signatures": n_pre,
            "decode_signatures": n_dec,
            "extend_signatures": n_ext,
            "verify_signatures": n_ver,
            "budget": (len(self.prefill_buckets) +
                       len(self.decode_buckets) + ext_budget +
                       ver_budget),
            "prefill_buckets": self.prefill_buckets.sizes,
            "decode_buckets": self.decode_buckets.sizes,
            "within_budget": (n_pre <= len(self.prefill_buckets) and
                              n_dec <= len(self.decode_buckets) and
                              n_ext <= ext_budget and
                              n_ver <= ver_budget),
            "o001_fired": any(s is not None and bool(s.diagnostics)
                              for s in sentinels),
        }

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
