"""Sequence ops of the port (``paddle_tpu/text/ops.py`` counterpart).

``viterbi_decode`` runs JAX's two scans as loops over time on the
potentials' device: a step's sums, maxima and first-maximum argmaxes are
JAX's, so the paths are JAX's exactly. ``edit_distance`` is a host-side
dynamic programme, as in JAX, a row of the table at a time in numpy (a
cell's left neighbour enters through a running minimum), with JAX's
integer results. ``gather_tree`` is :func:`..nn.functional.gather_tree`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import as_device_tensor as _tensor
from ..core.device import as_host_array
from ..nn.functional import gather_tree

__all__ = ["viterbi_decode", "edit_distance", "gather_tree", "shard_index"]


def viterbi_decode(potentials, transition, lengths=None,
                   include_bos_eos_tag: bool = False):
    """CRF Viterbi decoding: ``potentials`` ``[B, T, N]`` emissions,
    ``transition`` ``[N, N]`` (``[i, j]`` the score of i -> j),
    ``lengths`` ``[B]``. Returns ``(scores [B], paths [B, T])``; past a
    sequence's length its path repeats its last tag. Implicit BOS/EOS
    rows (``include_bos_eos_tag=True``) raise NotImplementedError, as in
    JAX."""
    if include_bos_eos_tag:
        raise NotImplementedError(
            "include_bos_eos_tag=True (implicit BOS/EOS transition rows) "
            "is not implemented; append explicit BOS/EOS tags instead")
    potentials = _tensor(potentials)
    transition = _tensor(transition).to(potentials.device)
    b, t, n = potentials.shape
    dev = potentials.device
    if lengths is None:
        lengths = torch.full((b,), t, dtype=torch.int64, device=dev)
    else:
        lengths = _tensor(lengths).to(dev)
    stay = torch.arange(n, device=dev)[None, :].expand(b, n)
    alpha = potentials[:, 0]
    backptrs = []
    for i in range(1, t):
        cand = alpha[:, :, None] + transition[None]          # [B, N, N]
        best, best_prev = cand.max(dim=1)
        active = (i < lengths)[:, None]
        alpha = torch.where(active, best + potentials[:, i], alpha)
        backptrs.append(torch.where(active, best_prev, stay))
    scores, tok = alpha.max(dim=-1)
    path = [tok]
    for ptrs in reversed(backptrs):
        tok = torch.gather(ptrs, 1, tok[:, None])[:, 0]
        path.append(tok)
    return scores, torch.stack(path[::-1], dim=1)


def _levenshtein(h: np.ndarray, r: np.ndarray) -> int:
    """The edit distance of ``h`` and ``r``, a DP row at a time: a cell is
    min(up + 1, diagonal + cost, left + 1), and the left chain is
    ``y + cummin(t[z] - z)`` over the row's other two terms ``t``."""
    n = r.shape[0]
    cols = np.arange(n + 1, dtype=np.int64)
    row = cols.copy()
    for x, tok in enumerate(h, start=1):
        t = np.empty(n + 1, np.int64)
        t[0] = x
        t[1:] = np.minimum(row[1:] + 1, row[:-1] + (r != tok))
        row = cols + np.minimum.accumulate(t - cols)
    return int(row[n])


def edit_distance(hyps, refs, normalized: bool = True):
    """The Levenshtein distance of each (hypothesis, reference) pair of
    int sequences, over the reference's length if ``normalized``. Returns
    ``([B, 1]`` float32, the count of pairs), host tensors."""
    if len(hyps) != len(refs):
        raise ValueError(
            f"edit_distance needs paired sequences; got {len(hyps)} "
            f"hypotheses vs {len(refs)} references")
    out = np.zeros((len(hyps), 1), np.float32)
    for i, (h, r) in enumerate(zip(hyps, refs)):
        h = as_host_array(h).reshape(-1)
        r = as_host_array(r).reshape(-1)
        d = float(_levenshtein(h, r))
        out[i, 0] = d / max(r.shape[0], 1) if normalized else d
    return torch.from_numpy(out), torch.tensor(len(hyps))


def shard_index(input, index_num: int, nshards: int, shard_id: int,
                ignore_value: int = -1):
    """Label ids for a sharded embedding or classifier: ids that shard
    ``shard_id`` owns become their offset in it, the others
    ``ignore_value``."""
    input = _tensor(input)
    shard_size = (index_num + nshards - 1) // nshards
    lo = shard_id * shard_size
    hi = lo + shard_size
    in_shard = (input >= lo) & (input < hi)
    return torch.where(in_shard, input - lo,
                       torch.full_like(input, ignore_value))
