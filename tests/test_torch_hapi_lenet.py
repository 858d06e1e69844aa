"""Port parity: ``paddle_tpu_torch.Model`` on LeNet (BASELINE config 1)
against the JAX package's ``paddle_tpu.Model``.

Both sides start from the JAX LeNet's weights (carried by
``convert.from_jax_state_dict``), draw their shuffles from one
``np.random`` seed and train on the synthetic MNIST (256 images, B=64, 2
epochs, Adam 1e-3). The convolutions are XLA's and torch's library
convolutions, summed in their own orders, so the losses are compared loss
by loss at rtol 1e-5 in float32 (found within 1.2e-7 over the eight
steps); under AMP O1 (bf16 products on both sides) at rtol 5e-3 (found
1.3e-3; O1 moves the losses 2.5e-3 from float32's). Then evaluate's
logs, predict's outputs, ``accumulate_grad_batches=2``, EarlyStopping, the
files ModelCheckpoint writes, and summary's table.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jpd
import paddle_tpu_torch as tpd
from paddle_tpu.hapi import callbacks as jcb
from paddle_tpu.vision.datasets import MNIST as JMNIST
from paddle_tpu.vision.models import LeNet as JLeNet
from paddle_tpu_torch.convert import from_jax_state_dict
from paddle_tpu_torch.hapi import callbacks as tcb
from paddle_tpu_torch.vision.datasets import MNIST as TMNIST
from paddle_tpu_torch.vision.models import LeNet as TLeNet

SEED = 11


def _recorder(base):
    class Recorder(base):
        def __init__(self):
            self.losses, self.epochs, self.evals = [], [], []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(float(np.asarray(logs["loss"])))

        def on_epoch_end(self, epoch, logs=None):
            self.epochs.append(epoch)

        def on_eval_end(self, logs=None):
            self.evals.append(dict(logs))

    return Recorder()


@pytest.fixture(scope="module")
def weights():
    jpd.seed(0)
    return {k: np.asarray(v) for k, v in JLeNet(10).state_dict().items()}


def _fit(side, weights, tmp=None, amp=None, eval_data=False, cbks=(),
         **fit_kw):
    """One ``fit`` on one side from the shared weights; the recorder, the
    model and the (train, test) datasets."""
    if side == "jax":
        net = JLeNet(10)
        net.set_state_dict({k: jpd.to_tensor(v) for k, v in weights.items()})
        P, MNIST, rec = jpd, JMNIST, _recorder(jcb.Callback)
    else:
        net = TLeNet(10, device="cpu")
        net.load_state_dict(from_jax_state_dict(weights))
        P, MNIST, rec = tpd, TMNIST, _recorder(tcb.Callback)
    model = P.Model(net)
    model.prepare(P.optimizer.Adam(1e-3), P.nn.CrossEntropyLoss(),
                  metrics=[P.metric.Accuracy()], amp_configs=amp)
    train = MNIST(mode="train", synthetic_size=256)
    test = MNIST(mode="test", synthetic_size=128)
    np.random.seed(SEED)
    model.fit(train, test if eval_data else None, batch_size=64, epochs=2,
              verbose=0, save_dir=tmp, callbacks=[rec, *cbks], **fit_kw)
    return rec, model, train, test


@pytest.fixture(scope="module")
def runs(weights, tmp_path_factory):
    out = {}
    for side in ("jax", "port"):
        tmp = str(tmp_path_factory.mktemp(f"ckpt_{side}"))
        rec, model, train, test = _fit(side, weights, tmp=tmp,
                                       eval_data=True)
        out[side] = dict(rec=rec, model=model, test=test, tmp=tmp)
    return out


def test_fit_matches_jax_loss_by_loss(runs):
    jl, tl = runs["jax"]["rec"].losses, runs["port"]["rec"].losses
    assert len(tl) == len(jl) == 8
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < 0.5 * tl[0]


def test_evaluate_and_predict_match_jax(runs):
    # the evaluation fit ran after each epoch
    je, te = runs["jax"]["rec"].evals, runs["port"]["rec"].evals
    assert len(te) == len(je) == 2
    for t, j in zip(te, je):
        assert set(t) == set(j) == {"loss", "acc"}
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-4)
        assert t["acc"] == j["acc"]
    jlog = runs["jax"]["model"].evaluate(runs["jax"]["test"], batch_size=64,
                                         verbose=0)
    tlog = runs["port"]["model"].evaluate(runs["port"]["test"],
                                          batch_size=64, verbose=0)
    np.testing.assert_allclose(tlog["loss"], jlog["loss"], rtol=1e-4)
    assert tlog["acc"] == jlog["acc"] > 0.9
    images = runs["port"]["test"].images[:, None]
    jout = runs["jax"]["model"].predict(jpd.io.TensorDataset([images]),
                                        batch_size=50, stack_outputs=True)
    tout = runs["port"]["model"].predict(tpd.io.TensorDataset([images]),
                                         batch_size=50, stack_outputs=True)
    assert tout.shape == jout.shape == (128, 10)
    np.testing.assert_allclose(tout, jout, rtol=1e-3, atol=1e-4)


def test_model_checkpoint_files_match_jax(runs):
    def names(d):
        return sorted(os.listdir(d))

    assert names(runs["port"]["tmp"]) == names(runs["jax"]["tmp"]) == sorted(
        f"{n}.{ext}" for n in ("0", "1", "final")
        for ext in ("pdparams", "pdparams.opver", "pdopt", "pdopt.opver"))
    # the final checkpoint reloads into a fresh model with equal logs
    model = tpd.Model(TLeNet(10, device="cpu", seed=9))
    model.prepare(tpd.optimizer.Adam(1e-3), tpd.nn.CrossEntropyLoss(),
                  metrics=[tpd.metric.Accuracy()])
    model.load(os.path.join(runs["port"]["tmp"], "final"))
    test = runs["port"]["test"]
    assert model.evaluate(test, batch_size=64, verbose=0) == \
        runs["port"]["model"].evaluate(test, batch_size=64, verbose=0)
    opt = tpd.load(os.path.join(runs["port"]["tmp"], "final.pdopt"),
                   return_numpy=True)
    jopt = jpd.load(os.path.join(runs["jax"]["tmp"], "final.pdopt"),
                    return_numpy=True)
    assert set(opt) == set(jopt)
    assert int(opt["step"]) == int(jopt["step"]) == 8


def test_accumulate_grad_batches_matches_jax(weights):
    """Two micro-batches a step, and the epoch's leftover (4 batches: two
    steps) flushed at its end."""
    (jr, jm, *_), (tr, tm, *_) = (
        _fit(side, weights, accumulate_grad_batches=2)
        for side in ("jax", "port"))
    np.testing.assert_allclose(tr.losses, jr.losses, rtol=1e-5)
    assert tm._step_count == jm._step_count == 4


def test_early_stopping_matches_jax(weights):
    """Stops once eval accuracy no longer improves (patience 0): both
    sides stop after the same epoch of the five allowed."""
    def run(side):
        cb = (jcb if side == "jax" else tcb).EarlyStopping(
            monitor="acc", mode="max", patience=0)
        rec, *_ = _fit(side, weights, eval_data=True, cbks=[cb])
        return rec.epochs

    assert run("port") == run("jax")


def test_summary_rows_match_jax(weights):
    outs = []
    for P, net in ((jpd, JLeNet(10)), (tpd, TLeNet(10, device="cpu"))):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            info = P.Model(net).summary((1, 1, 28, 28))
        outs.append((buf.getvalue(), info))
    assert outs[0] == outs[1]
    assert outs[1][1] == {"total_params": 61610, "trainable_params": 61610}
    assert "Linear (fc.0)           [1, 120]" in outs[1][0]


def test_amp_o1_matches_jax(weights, runs):
    """O1 casts the products' inputs to bf16 on both sides (the loss in
    float32 outside auto_cast); the parameters stay float32."""
    (jr, *_), (tr, tm, *_) = (_fit(side, weights, amp="O1")
                              for side in ("jax", "port"))
    np.testing.assert_allclose(tr.losses, jr.losses, rtol=5e-3)
    f32 = runs["port"]["rec"].losses
    assert abs(tr.losses[0] / f32[0] - 1) > 1e-5     # bf16 products ran
    assert all(p.dtype == torch.float32 for p in tm.parameters())
