"""The serving engine: continuous batching over a paged KV cache.

Port of ``paddle_tpu/serving/engine.py`` on its flag-off path:

- **paged KV** (:mod:`.paged_cache`): every sequence's KV lives in
  fixed-size blocks of one device pool, allocated from a deterministic
  free list and spilled to pinned host memory under pressure;
- **continuous batching** (:mod:`.scheduler`): requests join and leave the
  decode batch at token-iteration granularity; the decode step runs every
  iteration over whoever is resident, padded to a batch-width bucket;
- **bucketed shapes** (:mod:`.buckets`): prefill lengths and decode widths
  are padded to small bucket sets.

The prefill step runs the model's flash-attention forward (the K1 kernel
on the GPU) on one bucket-padded prompt and writes the per-layer K/V into
the sequence's pages; the decode step is a batched single-query pass that
gathers each sequence's pages (``single_query_attention`` masks the padded
tail by context length) and writes the new token's KV. Both update the
page pool in place with ``index_put_``, where the JAX engine donates the
pool to its executables.

A failing step raises: unlike the reference, the engine does not fail one
request and carry on (per-request isolation comes with the resilience
tier). Not ported yet: prefix sharing, chunked prefill, the ``extend``
step, speculative decoding, deadlines, shedding, the journal, metrics and
the static plan. Decoding is greedy (argmax), matching
``GPTForCausalLM.generate``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence as Seq

import numpy as np
import torch

from ..core.device import resolve_device, same_device
from ..ops.flash_attention import flash_attention, single_query_attention
from .buckets import BucketSet, pad_axis, pow2_buckets
from .paged_cache import NULL_BLOCK, PagedKVCache
from .scheduler import FCFSScheduler, Request, Sequence, Status

__all__ = ["ServingEngine"]


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class ServingEngine:
    """Paged-KV continuous-batching server over one causal-LM model.

    ``device=None`` means ``cuda:0`` and raises without CUDA; the model
    must already be on the engine's device. Step accounting for benchmarks
    is kept in plain attributes: ``n_prefills``, ``n_preemptions``,
    ``prefill_tokens``/``prefill_s`` and ``decode_ms`` (one entry per
    decode iteration, ``decode_tokens`` tokens in all)."""

    def __init__(self, model, *, block_size: int = 8, num_blocks: int = 64,
                 max_batch: int = 8, max_seq_len: Optional[int] = None,
                 device=None):
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

        # prefill lengths: whole blocks, a power-of-two count of them
        max_prefill = self.max_blocks_per_seq * self.block_size
        self.prefill_buckets = BucketSet(
            min(b * self.block_size, max_prefill)
            for b in pow2_buckets(1, self.max_blocks_per_seq))
        self.decode_buckets = BucketSet(pow2_buckets(1, max_batch))

        head_dim = cfg.hidden_size // cfg.num_heads
        self.cache = PagedKVCache(cfg.num_layers, num_blocks,
                                  self.block_size, cfg.kv_heads, head_dim,
                                  dtype=model.gpt.wte.weight.dtype,
                                  device=self.device)
        self.sched = FCFSScheduler(max_batch)
        self.n_prefills = 0
        self.n_preemptions = 0
        self.prefill_tokens = 0
        self.prefill_s = 0.0
        self.decode_ms: List[float] = []
        self.decode_tokens = 0
        self._prefill_fn = self._make_prefill()
        self._decode_fn = self._make_decode()

    # ------------------------------------------------------------------
    # The bucketed steps
    # ------------------------------------------------------------------

    def _make_prefill(self):
        m = self.model
        bs = self.block_size
        cache = self.cache

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

    def _make_decode(self):
        m = self.model
        bs = self.block_size
        cache = self.cache

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

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.int64)).to(self.device)

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
        self.sched.submit(seq)
        return seq

    def _try_admit(self) -> bool:
        seq = self.sched.peek_waiting()
        if seq is None or not self.sched.has_capacity():
            return False
        if seq.status is Status.PREEMPTED:
            return self._admit_restore(seq)
        ids = self.cache.allocator.alloc(
            _ceil_div(seq.prompt_len, self.block_size))
        if ids is None:
            # the capacity check makes an idle pool always grant a prompt,
            # so waiting for running sequences to free blocks terminates
            return False
        self.sched.admit(seq)
        self._prefill(seq, ids)
        return True

    def _admit_restore(self, seq: Sequence) -> bool:
        """Re-admit a preempted sequence: restore its spilled blocks."""
        ids = self.cache.allocator.alloc(int(seq.host_kv[0].shape[1]))
        if ids is None:
            return False
        self.sched.admit(seq)
        self._restore(seq, ids)
        return True

    def _prefill(self, seq: Sequence, block_ids: List[int]) -> None:
        now = time.perf_counter()
        seq.add_phase("queue", now - seq.t_enqueue)
        bucket = self.prefill_buckets.fit(seq.prompt_len)
        ids = pad_axis(seq.request.prompt_ids[None, :], 1, bucket)
        btab = np.full((bucket // self.block_size,), NULL_BLOCK, np.int64)
        btab[:len(block_ids)] = block_ids
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
        if seq.is_finished_by(tok):
            self._finish(seq)

    def _restore(self, seq: Sequence, ids: List[int]) -> None:
        now = time.perf_counter()
        seq.add_phase("queue", now - seq.t_enqueue)
        self.cache.restore(seq.host_kv, ids)
        seq.host_kv = None
        seq.spilled_bytes = 0
        seq.block_ids = list(ids)
        seq.block_log.append(-1)  # spill/restore boundary
        seq.block_log.extend(ids)
        # KV re-materialization substitutes for prefill on resume
        seq.add_phase("prefill", time.perf_counter() - now)

    def _preempt(self, seq: Sequence) -> None:
        self.sched.preempt(seq)
        blocks = seq.block_ids
        seq.host_kv = self.cache.spill(blocks)
        seq.block_ids = []
        seq.spilled_bytes = len(blocks) * self.cache.bytes_per_block
        # queue time restarts now; t_submit stays the true arrival
        seq.t_requeue = time.perf_counter()
        self.n_preemptions += 1

    # -- the decode iteration ------------------------------------------------

    def _decodable(self) -> List[Sequence]:
        """Resident sequences with a committed frontier token."""
        return [s for s in self.sched.iteration_batch() if s.out_tokens]

    def _ensure_decode_blocks(self) -> None:
        """Every decodable sequence needs real blocks through position
        ctx_len before the next iteration; preempt the youngest resident
        (LIFO) to make room."""
        for seq in list(self.sched.running):
            if seq.status is not Status.RUNNING or not seq.out_tokens:
                continue
            needed = seq.ctx_len // self.block_size + 1
            while len(seq.block_ids) < needed:
                got = self.cache.allocator.alloc(1)
                if got is not None:
                    seq.block_ids.extend(got)
                    seq.block_log.extend(got)
                    continue
                victim = self.sched.preempt_victim(exclude=seq)
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

    def _finish(self, seq: Sequence) -> None:
        t0 = time.perf_counter()
        self.sched.finish(seq)
        self.cache.allocator.free(seq.block_ids)
        seq.block_ids = []
        seq.output = seq.full_output()
        seq.add_phase("detokenize", time.perf_counter() - t0)

    # ------------------------------------------------------------------
    # Driving loop
    # ------------------------------------------------------------------

    def step(self) -> List[Sequence]:
        """One scheduler iteration: admit whatever fits (prefill or
        restore), top up decode blocks (preempting under pressure), run one
        decode iteration. Returns the sequences that finished."""
        n0 = len(self.sched.finished)
        while self._try_admit():
            pass
        self._ensure_decode_blocks()
        self._decode_iteration()
        return self.sched.finished[n0:]

    def serve(self, requests: Seq[Request]) -> Dict[str, Sequence]:
        """Drive the trace to completion; returns rid -> Sequence (with
        ``.output``)."""
        for req in requests:
            self.submit(req)
        done: Dict[str, Sequence] = {}
        while self.sched.n_pending:
            for seq in self.step():
                done[seq.rid] = seq
        self.sched.assert_idle()
        return done
