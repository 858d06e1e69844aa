"""Speculative decoding: drafters and the accepted-length-driven gamma.

Port of ``paddle_tpu/serving/speculative.py`` (Leviathan et al. 2023). A
cheap **drafter** proposes ``gamma`` tokens per iteration and the target
verifies the whole proposal in ONE bucketed decode-gamma dispatch (the
engine's ``extend`` step: gamma+1 query positions over the gathered
pages, KV written in the same step as the decode step writes it). The
greedy accept rule keeps ``d_j`` while it equals the target's own argmax
after the accepted prefix, then commits the target's token at the first
mismatch: every iteration commits between 1 and gamma+1 tokens, and the
committed stream is exactly the target's greedy decode.

Two drafters:

- :class:`NGramDrafter` (the default): prompt lookup, the continuation of
  the longest committed-history suffix match. Host work only;
- :class:`ModelDrafter`: a small causal LM over a **mirrored paged pool**
  (the target pool's block count, block size and block ids, drafter-sized
  pages), so the drafter's KV rides the same block tables, spills and
  restores with its sequence and shares prefix pages when the target
  does. The engine makes its steps with the functions that make the
  target's.

Accepted lengths feed :func:`tune_gamma`, which stores a gamma in the
port's autotune cache (:mod:`paddle_tpu_torch.ops._hopper.autotune`);
``FLAGS_serve_speculative=-1`` reads it back through :func:`pick_gamma`.
"""


from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np

from ..ops._hopper import autotune as _autotune

__all__ = ["NGramDrafter", "ModelDrafter", "pick_gamma", "tune_gamma",
           "store_gamma", "DEFAULT_GAMMA"]

DEFAULT_GAMMA = 4
_TUNE_KERNEL = "serve_spec_gamma"


class NGramDrafter:
    """Prompt-lookup drafter: longest-suffix-match continuation.

    Given the committed token history (prompt + generated), find the
    most recent earlier occurrence of the longest current suffix (down
    to ``min_match`` tokens) and propose the tokens that followed it.
    No device state, no weights — the proposal either matches the
    target's greedy continuation (repetitive spans) and multiple tokens
    commit per dispatch, or it costs one ordinary-sized verify step.
    """

    kind = "ngram"

    def __init__(self, max_match: int = 4, min_match: int = 1,
                 repeat_fallback: bool = True):
        if min_match < 1 or max_match < min_match:
            raise ValueError(f"bad match window [{min_match}, {max_match}]")
        self.max_match = int(max_match)
        self.min_match = int(min_match)
        #: with no suffix match, propose repeating the frontier token —
        #: greedy decodes spend long spans in fixed points/short cycles,
        #: and a wrong free proposal costs nothing (the verify dispatch
        #: runs at gamma width either way)
        self.repeat_fallback = bool(repeat_fallback)

    def propose(self, history: Sequence[int], gamma: int) -> List[int]:
        """Up to ``gamma`` proposed tokens (possibly fewer/empty)."""
        h = list(int(t) for t in history)
        n = len(h)
        for m in range(min(self.max_match, n - 1), self.min_match - 1, -1):
            suffix = h[n - m:]
            # newest earlier occurrence wins (recent context repeats)
            for start in range(n - m - 1, -1, -1):
                if h[start:start + m] == suffix:
                    cont = h[start + m:start + m + gamma]
                    if cont:
                        return cont
        if self.repeat_fallback and h:
            return [h[-1]] * gamma
        return []


class ModelDrafter:
    """A drafter causal LM sharing the target's block geometry.

    Thin policy object: the serving engine owns the mirrored
    :class:`~.paged_cache.PagedKVCache` and the drafter's decode and
    extend steps (made by the same functions as the target's). The
    drafter model must share the target's vocabulary and
    ``GPTForCausalLM`` surface (``.gpt.wte/wpe/h/ln_f``, ``.logits``)
    and already be on the engine's device; it may differ in
    depth/width/heads — its pages are sized from its own config.
    """

    kind = "model"

    def __init__(self, model):
        model.eval()
        self.model = model


def _cache_key(target_desc: str, drafter_desc: str) -> str:
    return f"{target_desc}|{drafter_desc}"


def pick_gamma(target_desc: str, drafter_desc: str,
               default: int = DEFAULT_GAMMA) -> int:
    """The persisted accepted-length-derived gamma for this target/
    drafter pair, or ``default`` when never tuned."""
    hit = _autotune.get_cache().get(
        _TUNE_KERNEL, _cache_key(target_desc, drafter_desc))
    if isinstance(hit, (int, float)) and int(hit) >= 1:
        return int(hit)
    return int(default)


def store_gamma(target_desc: str, drafter_desc: str, gamma: int,
                measured_ms: float = 0.0) -> int:
    """Persist a measured-winner gamma directly (the bench's gamma
    sweep stores the throughput-best arm; :func:`tune_gamma` is the
    accepted-length heuristic for when no sweep ran)."""
    gamma = int(gamma)
    _autotune.get_cache().put(
        _TUNE_KERNEL, _cache_key(target_desc, drafter_desc), gamma,
        measured_ms=measured_ms)
    return gamma


def tune_gamma(target_desc: str, drafter_desc: str,
               accept_lens: Sequence[int],
               max_gamma: int = 8) -> Optional[int]:
    """Persist the gamma the measured accepted-length distribution
    supports: mean accepted length rounded up, clamped to
    ``[1, max_gamma]`` — proposing far past the mean acceptance buys
    only rejected drafter work. Returns the stored gamma (None when the
    sample is empty)."""
    lens = [int(x) for x in accept_lens]
    if not lens:
        return None
    mean = float(np.mean(lens))
    gamma = int(min(max(1, int(np.ceil(mean))), max_gamma))
    _autotune.get_cache().put(
        _TUNE_KERNEL, _cache_key(target_desc, drafter_desc), gamma,
        measured_ms=mean)
    return gamma
