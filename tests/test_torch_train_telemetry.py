"""Port parity: the training paths' telemetry.

``TrainStep`` reports into the step timeline as JAX's does (``h2d``, the
applied ``index``, ``compile`` on a signature's first dispatch and
``device`` after); ``FLAGS_telemetry=off`` leaves its losses and
parameters bit-equal to ``metrics`` (JAX's ``TestTelemetryOffBitwise``);
``Model.fit`` on LeNet (BASELINE config 1) logs the epoch stat snapshot
through ``StatsLoggerCallback`` with ``model.train_batches`` and
``dataloader.batches`` equal to JAX's, and records the same phases a step;
a flight recorder armed around the steps replays one ``step`` record per
step carrying the trainer's index.
"""

import logging

import numpy as np
import pytest
import torch

import paddle_tpu as jpd
import paddle_tpu_torch as tpd
from paddle_tpu.core import flags as jflags
from paddle_tpu.framework.functional import functional_call
from paddle_tpu.framework.sharded import make_sharded_train_step as jstep
from paddle_tpu.observability import flight_recorder as jfr
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.observability import step_monitor as jsm
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu.vision.datasets import MNIST as JMNIST
from paddle_tpu.vision.models import LeNet as JLeNet
from paddle_tpu_torch.convert import from_jax_state_dict
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.framework import make_sharded_train_step as tstep
from paddle_tpu_torch.hapi.callbacks import StatsLoggerCallback
from paddle_tpu_torch.observability import flight_recorder as tfr
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.observability import step_monitor as tsm
from paddle_tpu_torch.optimizer import AdamW as TAdamW
from paddle_tpu_torch.vision.datasets import MNIST as TMNIST
from paddle_tpu_torch.vision.models import LeNet as TLeNet
from test_torch_train import carried_pair, gpt_loss, ids_labels
from _torch_threads import one_torch_thread  # noqa: F401

SEQ = 32


@pytest.fixture
def mode():
    before = (jflags.flag("telemetry"), tflags.flag("telemetry"))

    def set_mode(m):
        jflags.set_flags({"telemetry": m})
        tflags.set_flags({"telemetry": m})

    set_mode("metrics")
    yield set_mode
    jflags.set_flags({"telemetry": before[0]})
    tflags.set_flags({"telemetry": before[1]})


def jax_loss(model, params, batch):
    ids, labels = batch
    return functional_call(model, params, ids, labels, training=True)


def batches(shapes):
    return [ids_labels(b, s, seed=20 + i) for i, (b, s) in enumerate(shapes)]


def step_records(tl):
    return [(s["step"], s.get("index"), sorted(s["phases"]))
            for s in tl.steps()]


def test_train_step_records_match_jax(mode):
    """Four steps, the fourth at a new batch shape: h2d every step,
    compile on each signature's first dispatch, device after, the applied
    index noted; ``index=`` pins it in both."""
    jm, tm = carried_pair(seed=5)
    # B = 8: JAX's default mesh shards the batch over the 8 CPU devices
    feed = batches([(8, SEQ)] * 3 + [(8, SEQ // 2)])
    jtl, ttl = jsm.reset_default(), tsm.reset_default()
    js = jstep(jm, JAdamW(1e-3), jax_loss)
    ts = tstep(tm, TAdamW(1e-3), gpt_loss)
    jl, tl = [], []
    for i, b in enumerate(feed):
        idx = 7 if i == 2 else None
        jl.append(float(js.step(b, index=idx)))
        tl.append(float(ts.step(b, index=idx)))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert step_records(ttl) == step_records(jtl) == [
        (1, 1, ["compile", "h2d"]), (2, 2, ["device", "h2d"]),
        (3, 7, ["device", "h2d"]), (4, 8, ["compile", "h2d"])]
    ts_sum, js_sum = ttl.summary(), jtl.summary()
    assert ts_sum["steps"] == js_sum["steps"] == 4
    assert sorted(ts_sum["phases"]) == sorted(js_sum["phases"])
    assert ts_sum["hbm_peak_gb"] is None       # CPU: no memory stats
    assert ts_sum["recompile_diagnostics"] == \
        js_sum["recompile_diagnostics"] == 0


def test_train_step_off_bitwise(mode):
    """``FLAGS_telemetry=off`` against ``metrics``: bit-equal losses and
    parameters over 3 steps, and nothing recorded under off."""
    out = {}
    for m in ("off", "metrics"):
        mode(m)
        tl = tsm.reset_default()
        _, tm = carried_pair(seed=6)
        ts = tstep(tm, TAdamW(1e-3, weight_decay=0.01), gpt_loss)
        losses = [ts.step(b).clone() for b in batches([(2, SEQ)] * 3)]
        out[m] = (losses, {k: v.detach().clone()
                           for k, v in tm.state_dict().items()})
        assert len(tl.steps()) == (0 if m == "off" else 3)
    for a, b in zip(out["off"][0], out["metrics"][0]):
        assert torch.equal(a, b)
    for k in out["off"][1]:
        assert torch.equal(out["off"][1][k], out["metrics"][1][k]), k


def test_flight_recorder_replays_step_index(mode, tmp_path):
    """The recorder armed (``FLAGS_flight_recorder=on``) around three
    steps: one ``step`` record a step with the trainer's index, readable
    by JAX's ``replay``."""
    before = tflags.flag("flight_recorder")
    try:
        tflags.set_flags({"flight_recorder": "on"})
        tsm.reset_default()
        rec = tfr.arm(str(tmp_path), "trainer", capacity_bytes=1 << 16)
        _, tm = carried_pair(seed=6)
        ts = tstep(tm, TAdamW(1e-3), gpt_loss)
        for i, b in enumerate(batches([(2, SEQ)] * 3)):
            ts.step(b, index=10 + i)
        tfr.disarm()
    finally:
        tfr.disarm()
        tflags.set_flags({"flight_recorder": before})
    for replay in (tfr.replay, jfr.replay):
        meta, recs, rep = replay(rec.path)
        steps = [r for r in recs if r["k"] == "step"]
        assert [(r["step"], r["index"]) for r in steps] == [
            (1, 10), (2, 11), (3, 12)]
        assert set(steps[0]["phases"]) == {"h2d", "compile"}
        assert rep["frames_torn"] == 0 and meta["role"] == "trainer"


# -- Model.fit on LeNet --------------------------------------------------------

class ListHandler(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.fixture(scope="module")
def fits():
    """``fit`` on LeNet in both packages (B=32, 2 epochs of 128 synthetic
    images) from JAX's weights, each after its registry is reset and with
    its ``StatsLoggerCallback``'s logger captured."""
    before = (jflags.flag("telemetry"), tflags.flag("telemetry"))
    jflags.set_flags({"telemetry": "metrics"})
    tflags.set_flags({"telemetry": "metrics"})
    jpd.seed(0)
    weights = {k: np.asarray(v) for k, v in JLeNet(10).state_dict().items()}
    out = {}
    try:
        for side in ("jax", "port"):
            if side == "jax":
                from paddle_tpu.profiler.monitor import get_logger
                net = JLeNet(10)
                net.set_state_dict({k: jpd.to_tensor(v)
                                    for k, v in weights.items()})
                P, MNIST, metrics, sm = jpd, JMNIST, jmetrics, jsm
                logger = get_logger("paddle_tpu.monitor")
            else:
                from paddle_tpu_torch.profiler.monitor import get_logger
                net = TLeNet(10, device="cpu")
                net.load_state_dict(from_jax_state_dict(weights))
                P, MNIST, metrics, sm = tpd, TMNIST, tmetrics, tsm
                logger = get_logger("paddle_tpu_torch.monitor")
            handler = ListHandler()
            logger.addHandler(handler)
            metrics.reset_all()
            tl = sm.reset_default()
            model = P.Model(net)
            model.prepare(P.optimizer.Adam(1e-3), P.nn.CrossEntropyLoss())
            np.random.seed(3)
            try:
                model.fit(MNIST(mode="train", synthetic_size=128),
                          batch_size=32, epochs=2, verbose=0)
            finally:
                logger.removeHandler(handler)
            out[side] = dict(
                log=[m for m in handler.messages if " stats " in m],
                stats=metrics.stats_snapshot(), steps=tl.steps())
    finally:
        jflags.set_flags({"telemetry": before[0]})
        tflags.set_flags({"telemetry": before[1]})
    return out


def test_fit_logs_epoch_stat_snapshots(fits):
    for side in ("jax", "port"):
        log = fits[side]["log"]
        assert [m.split(" stats ")[0] for m in log] == ["epoch 0", "epoch 1"]
    assert "'model.train_batches': 4" in fits["port"]["log"][0]
    assert "'dataloader.batches': 8" in fits["port"]["log"][1]


def test_fit_counts_match_jax(fits):
    for name in ("model.train_batches", "dataloader.batches"):
        assert fits["port"]["stats"][name] == fits["jax"]["stats"][name] \
            == 8, name


def test_fit_step_phases_match_jax(fits):
    phases = lambda s: [sorted(r["phases"]) for r in s]  # noqa: E731
    assert phases(fits["port"]["steps"]) == phases(fits["jax"]["steps"])
    assert phases(fits["port"]["steps"])[:2] == [
        ["callbacks", "compile"], ["callbacks", "device"]]


def test_stats_logger_installed_unless_off(mode):
    from paddle_tpu_torch.hapi.callbacks import config_callbacks

    def installed():
        return any(isinstance(c, StatsLoggerCallback)
                   for c in config_callbacks(verbose=0).callbacks)

    assert installed()
    mode("off")
    assert not installed()
    mode("trace")
    assert installed()


def test_grad_batch_phase_under_accumulation(mode):
    """``update=False`` runs under ``Model.grad_batch``'s sentinel key,
    as JAX's accumulation path."""
    tl = tsm.reset_default()
    model = tpd.Model(TLeNet(10, device="cpu", seed=1))
    model.prepare(tpd.optimizer.Adam(1e-3), tpd.nn.CrossEntropyLoss())
    x = np.random.default_rng(0).standard_normal((4, 1, 28, 28)).astype(
        np.float32)
    y = np.arange(4).reshape(4, 1).astype(np.int64)
    before = tmetrics.stat_get("model.train_batches")
    for update in (False, True, False, True):
        with tl.step():
            model.train_batch([x], [y], update=update)
    assert [sorted(s["phases"]) for s in tl.steps()] == [
        ["compile"], ["device"], ["device"], ["device"]]
    assert tl.sentinel._seen.keys() == {("Model.grad_batch", id(model))}
    assert tmetrics.stat_get("model.train_batches") == before + 4
