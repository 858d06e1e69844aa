"""Port parity: ``paddle_tpu_torch.metric`` against ``paddle_tpu.metric``.

Accuracy ranks on the device in the port (a stable descending sort, so a
tie ranks the lower class first) and with ``np.argsort(-pred)`` in JAX.
The batches here hold ties at the top of a row and across the k-th place;
for these rows numpy ranks the tied classes lower index first too, so the
counts agree exactly. Precision, Recall and Auc are numpy accumulators on
both sides; the port brings tensors to the host first.
"""

import numpy as np
import pytest
import torch

from paddle_tpu import metric as jm
from paddle_tpu_torch import metric as tm


def _scores(seed=0, n=64, c=10):
    rng = np.random.default_rng(seed)
    pred = rng.standard_normal((n, c)).astype(np.float32)
    label = rng.integers(0, c, (n, 1)).astype(np.int64)
    # ties: a tied maximum (the label the higher of the two classes), a
    # tie across the second place, a row of equal scores
    pred[0, [2, 6]] = 9.0
    label[0] = 6
    pred[1, [4, 1]] = 9.0
    label[1] = 1
    pred[2, :] = 0.5
    label[2] = 0
    pred[3, 5], pred[3, [3, 8]] = 9.0, 7.0
    label[3] = 8
    return pred, label


def test_tie_ranks_lower_class_first():
    pred, label = _scores()
    correct = tm.Accuracy(topk=(1, 2)).compute(torch.from_numpy(pred),
                                               label)
    assert correct.dtype == bool and correct.shape == (64, 2)
    assert correct[0].tolist() == [False, True]    # 2 then 6
    assert correct[1].tolist() == [True, False]    # 1 then 4
    assert correct[2].tolist() == [True, False]    # all equal: 0 first
    assert correct[3].tolist() == [False, False]   # 5, then 3 before 8
    want = jm.Accuracy(topk=(1, 2)).compute(pred, label)
    np.testing.assert_array_equal(correct, want)


@pytest.mark.parametrize("topk", [1, (1, 5)])
def test_accuracy_matches_jax(topk):
    jacc, tacc = jm.Accuracy(topk=topk), tm.Accuracy(topk=topk)
    assert tacc.name() == jacc.name()
    for seed in range(3):
        pred, label = _scores(seed)
        jr = jacc.update(jacc.compute(pred, label))
        tr = tacc.update(tacc.compute(torch.from_numpy(pred),
                                      torch.from_numpy(label)))
        np.testing.assert_array_equal(np.asarray(tr), np.asarray(jr))
    assert tacc.accumulate() == jacc.accumulate()
    tacc.reset()
    assert np.all(tacc.count == 0)
    pred, label = _scores(5)
    assert tm.accuracy(torch.from_numpy(pred), label, k=2) == \
        jm.accuracy(pred, label, k=2)


def test_precision_recall_auc_match_jax():
    rng = np.random.default_rng(1)
    metrics = [(jm.Precision(), tm.Precision()), (jm.Recall(), tm.Recall()),
               (jm.Auc(num_thresholds=255), tm.Auc(num_thresholds=255))]
    for _ in range(3):
        probs = rng.random(50).astype(np.float32)
        labels = (rng.random(50) < 0.4).astype(np.int64)
        two = np.stack([1 - probs, probs], axis=1)
        for j, t in metrics:
            jargs = (two, labels) if isinstance(j, jm.Auc) else \
                (probs, labels)
            j.update(*jargs)
            t.update(*(torch.from_numpy(a) for a in jargs))
    for j, t in metrics:
        assert t.name() == j.name()
        assert t.accumulate() == j.accumulate()
        assert 0.0 < t.accumulate() < 1.0
