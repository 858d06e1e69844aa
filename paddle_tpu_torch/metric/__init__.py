"""Metrics (``paddle_tpu/metric`` counterpart): Metric, Accuracy,
Precision, Recall, Auc and the functional ``accuracy``. Host-side numpy
accumulators over device results; a tensor argument is brought to the host
first.

:meth:`Accuracy.compute` ranks on the device and brings only the boolean
``correct`` ``[..., maxk]`` to the host. Ties rank the lower class index
first (a stable descending sort). The JAX package ranks with
``np.argsort(-pred)``, which is not stable: its order among tied scores is
numpy's, so where a tie straddles the k-th place the two may count a
sample differently.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _top_correct(pred, label, k: int) -> torch.Tensor:
    """``[..., k]`` bool: whether the i-th ranked class is the label."""
    pred = torch.as_tensor(pred)
    label = torch.as_tensor(label, device=pred.device)
    if label.dim() == pred.dim() and label.shape[-1] == 1:
        label = label[..., 0]
    top = torch.sort(pred, dim=-1, descending=True, stable=True).indices
    return top[..., :k] == label[..., None]

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


class Metric:
    def __init__(self, name: Optional[str] = None):
        self._name = name or type(self).__name__.lower()

    def name(self):
        return self._name

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def compute(self, pred, label, *args):
        """Optional pre-processing on device outputs; default passthrough."""
        return pred, label


class Accuracy(Metric):
    def __init__(self, topk: Union[int, Sequence[int]] = (1,), name=None):
        super().__init__(name or "acc")
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self.reset()

    def reset(self):
        self.total = np.zeros(len(self.topk))
        self.count = np.zeros(len(self.topk))

    def compute(self, pred, label, *args):
        return _host(_top_correct(pred, label, self.maxk))

    def update(self, correct):
        correct = _host(correct)
        n = correct[..., 0].size
        for i, k in enumerate(self.topk):
            self.total[i] += correct[..., :k].any(axis=-1).sum()
            self.count[i] += n
        res = self.total / np.maximum(self.count, 1)
        return res[0] if len(self.topk) == 1 else res

    def accumulate(self):
        res = self.total / np.maximum(self.count, 1)
        return float(res[0]) if len(self.topk) == 1 else res.tolist()

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name=None):
        super().__init__(name or "precision")
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = (_host(preds) > 0.5).astype(np.int32).reshape(-1)
        labels = _host(labels).astype(np.int32).reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fp += int(((preds == 1) & (labels == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return float(self.tp) / denom if denom else 0.0


class Recall(Metric):
    def __init__(self, name=None):
        super().__init__(name or "recall")
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = (_host(preds) > 0.5).astype(np.int32).reshape(-1)
        labels = _host(labels).astype(np.int32).reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fn += int(((preds == 0) & (labels == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return float(self.tp) / denom if denom else 0.0


class Auc(Metric):
    """Bucketed ROC-AUC (ref metrics.py Auc: histogram of positive/negative
    scores over num_thresholds buckets, trapezoid integration)."""

    def __init__(self, curve: str = "ROC", num_thresholds: int = 4095,
                 name=None):
        super().__init__(name or "auc")
        self.num_thresholds = num_thresholds
        self.curve = curve
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        """preds: [N, 2] class probabilities (or [N] positive scores)."""
        preds = _host(preds)
        labels = _host(labels).reshape(-1)
        pos_score = preds[:, 1] if preds.ndim == 2 else preds.reshape(-1)
        idx = np.clip((pos_score * self.num_thresholds).astype(np.int64), 0,
                      self.num_thresholds)
        np.add.at(self._stat_pos, idx, labels == 1)
        np.add.at(self._stat_neg, idx, labels == 0)

    def accumulate(self):
        tot_pos = tot_neg = auc = 0.0
        for i in range(self.num_thresholds, -1, -1):
            new_pos = tot_pos + self._stat_pos[i]
            new_neg = tot_neg + self._stat_neg[i]
            auc += (new_neg - tot_neg) * (new_pos + tot_pos) / 2.0
            tot_pos, tot_neg = new_pos, new_neg
        denom = tot_pos * tot_neg
        return float(auc / denom) if denom else 0.0


def accuracy(input, label, k: int = 1):
    """Functional top-k accuracy (``paddle.metric.accuracy``), ranked as
    :meth:`Accuracy.compute` ranks."""
    correct = _top_correct(input, label, k).any(dim=-1)
    return float(correct.float().mean())
