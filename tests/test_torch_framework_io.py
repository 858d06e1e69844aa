"""Port parity: ``paddle_tpu_torch.save`` / ``load`` against the JAX
package's ``paddle_tpu.save`` / ``load``, and ``Model.save`` / ``load``.

The file format is shared (a pickle with numpy arrays, bfloat16 as
``ml_dtypes``' bfloat16, and the ``.opver`` sidecar), so a file written by
either package loads in the other with equal arrays. A write killed midway
leaves the old file. A port ``Model`` saved and loaded into a fresh one
takes the same next step, bit for bit; a JAX ``Model`` checkpoint,
rewritten by ``convert.from_jax_checkpoint``, resumes in the port and takes
JAX's next step (float32 LeNet on both sides: rtol 1e-5).
"""

import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as jpd
import paddle_tpu_torch as tpd
from paddle_tpu.vision.models import LeNet as JLeNet
from paddle_tpu_torch.convert import from_jax_checkpoint, from_jax_state_dict
from paddle_tpu_torch.vision.models import LeNet as TLeNet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _payload():
    rng = np.random.default_rng(0)
    return {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "ids": np.arange(5, dtype=np.int64),
            "half": rng.standard_normal(6).astype(ml_dtypes.bfloat16),
            "nested": [np.ones(2, np.float32), {"step": np.int32(7)}],
            "meta": {"name": "x", "lr": 0.5}}


def _equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, torch.Tensor):
        _equal(tpd.framework.io._tensor_to_numpy(a), b)
    elif isinstance(a, np.ndarray) or hasattr(a, "dtype"):
        b = np.asarray(b)
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)
    else:
        assert a == b


def test_jax_file_loads_in_port_and_back(tmp_path):
    payload = _payload()
    jpd.save({k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
              for k, v in payload.items()}, str(tmp_path / "j.pd"))
    written = jpd.load(str(tmp_path / "j.pd"), return_numpy=True)
    _equal(written, {**payload, "ids": payload["ids"].astype(np.int32)})
    got = tpd.load(str(tmp_path / "j.pd"), device="cpu")
    assert isinstance(got["w"], torch.Tensor)
    assert got["half"].dtype == torch.bfloat16
    assert got["ids"].dtype == torch.int32    # JAX wrote int32
    _equal(got, written)
    _equal(tpd.load(str(tmp_path / "j.pd"), return_numpy=True), written)

    # the reverse: tensors saved by the port load in JAX, equal
    tpd.save(got, str(tmp_path / "t.pd"))
    back = jpd.load(str(tmp_path / "t.pd"), return_numpy=True)
    _equal(back, written)
    assert np.asarray(jpd.load(str(tmp_path / "t.pd"))["half"]).dtype == \
        jnp.bfloat16


def test_opver_sidecar_written_and_replayed(tmp_path):
    """Both packages write the same op-version map; an op-tagged payload
    saved under an older map is upgraded on load, as JAX upgrades it."""
    path = str(tmp_path / "cfg.pd")
    tpd.save({"opt": {"__op__": "adamw", "lr": 0.1}}, path)
    with open(path + ".opver") as f:
        saved = json.load(f)
    from paddle_tpu.core.op_version import op_version_map
    assert saved == op_version_map() == {"adamw": 1, "batch_norm": 1,
                                         "flash_attention": 1}
    assert tpd.load(path, device="cpu")["opt"] == {"__op__": "adamw",
                                                   "lr": 0.1}
    with open(path + ".opver", "w") as f:
        json.dump({}, f)    # written before any bump
    want = {"__op__": "adamw", "lr": 0.1, "multi_precision": False}
    assert tpd.load(path, device="cpu")["opt"] == want
    assert jpd.load(path, return_numpy=True)["opt"] == want


def test_killed_write_leaves_the_old_file(tmp_path):
    """A process killed by SIGKILL while it pickles leaves the previous
    file whole (the write goes to a temporary file, fsynced, then
    renamed)."""
    path = str(tmp_path / "ckpt.pd")
    tpd.save({"v": torch.arange(4)}, path)
    script = textwrap.dedent(f"""
        import os, signal, sys
        sys.path.insert(0, {REPO!r})
        import numpy as np
        import paddle_tpu_torch as tpd

        class Dies:
            def __reduce__(self):
                os.kill(os.getpid(), signal.SIGKILL)

        tpd.save({{"big": np.zeros(1 << 20, np.float32), "x": Dies()}},
                 {path!r})
    """)
    proc = subprocess.run([sys.executable, "-c", script], timeout=120)
    assert proc.returncode == -9
    leftovers = [p for p in os.listdir(tmp_path) if ".tmp." in p]
    assert leftovers and os.path.getsize(tmp_path / leftovers[0]) > 0
    np.testing.assert_array_equal(tpd.load(path, device="cpu")["v"].numpy(),
                                  np.arange(4))


def _lenet_pair():
    jpd.seed(0)
    jnet = JLeNet(10)
    sd = {k: np.asarray(v) for k, v in jnet.state_dict().items()}
    tnet = TLeNet(10, device="cpu")
    tnet.load_state_dict(from_jax_state_dict(sd))
    return jnet, tnet


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((16, 1, 28, 28)).astype(np.float32),
             rng.integers(0, 10, 16).astype(np.int64)) for _ in range(n)]


def _port_model(net):
    m = tpd.Model(net)
    m.prepare(tpd.optimizer.Adam(1e-3), tpd.nn.CrossEntropyLoss())
    return m


def test_model_save_load_resumes_bit_for_bit(tmp_path):
    model = _port_model(TLeNet(10, device="cpu"))
    data = _batches(4)
    for x, y in data[:3]:
        model.train_batch(x, y)
    model.save(str(tmp_path / "m"))
    want = model.train_batch(*data[3])
    resumed = _port_model(TLeNet(10, device="cpu", seed=5))
    resumed.load(str(tmp_path / "m"))
    assert int(resumed._opt_state["step"]) == 3
    assert resumed.train_batch(*data[3]) == want


def test_jax_checkpoint_resumes_in_port(tmp_path):
    jnet, _ = _lenet_pair()
    jmodel = jpd.Model(jnet)
    jmodel.prepare(jpd.optimizer.Adam(1e-3), jpd.nn.CrossEntropyLoss())
    data = _batches(4, seed=1)
    for x, y in data[:3]:
        jmodel.train_batch(x, y)
    jmodel.save(str(tmp_path / "jax"))
    want = float(jmodel.train_batch(*data[3]))
    from_jax_checkpoint(str(tmp_path / "jax"), str(tmp_path / "port"))
    port = _port_model(TLeNet(10, device="cpu", seed=5))
    port.load(str(tmp_path / "port"))
    st = port._opt_state["param_states"]["fc.0.weight"]
    assert tuple(st["moment1"].shape) == (120, 400)   # transposed with it
    np.testing.assert_allclose(float(port.train_batch(*data[3])), want,
                               rtol=1e-5)


def test_load_refuses_a_missing_card(tmp_path, monkeypatch):
    """``load`` without a device goes to cuda:0 and raises without one
    (the port never falls back to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tpd.save({"a": np.ones(1)}, str(tmp_path / "a.pd"))
    with pytest.raises(RuntimeError, match="CUDA"):
        tpd.load(str(tmp_path / "a.pd"))
