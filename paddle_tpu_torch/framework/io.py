"""``paddle.save`` / ``paddle.load`` (``paddle_tpu/framework/io.py``
counterpart).

The file is the JAX package's: a pickle (protocol 2-5) of the object with
every tensor turned into a numpy array (bfloat16 as ``ml_dtypes``'
bfloat16, as JAX arrays come to numpy), so a file written by either
package loads in the other. The write is atomic: a temporary file, fsync,
then ``os.replace``, so a process killed mid-write leaves the old file
whole. The op-version map goes beside it in ``<path>.opver`` and is
replayed on load (:mod:`..core.op_version`).

A state_dict keeps its package's layout: the port's Linear weights are
``[out, in]``, the JAX package's ``[in, out]``;
:mod:`paddle_tpu_torch.convert` carries one into the other.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Any

import numpy as np
import torch

from ..core.device import resolve_device

__all__ = ["save", "load"]


def _tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes   # numpy's bfloat16, as the JAX package writes it
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _numpy_to_tensor(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))   # an owned, writable copy
    return t.to(device)


def _to_host(obj):
    if isinstance(obj, torch.Tensor):
        return _tensor_to_numpy(obj)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _to_device(obj, device):
    if isinstance(obj, np.ndarray) and (obj.dtype.kind in "biufc" or
                                        obj.dtype.name == "bfloat16"):
        return _numpy_to_tensor(obj, device)
    if isinstance(obj, dict):
        return {k: _to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_device(v, device) for v in obj)
    return obj


def save(obj: Any, path: str, protocol: int = 4) -> None:
    """Write ``obj`` (tensors as numpy arrays) to ``path`` atomically, and
    the op-version map to ``path + ".opver"``."""
    from ..core.op_version import op_version_map
    if protocol < 2 or protocol > 5:
        raise ValueError(f"pickle protocol must be in [2, 5], got {protocol}")
    dirname = os.path.dirname(path)
    if dirname:
        os.makedirs(dirname, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            pickle.dump(_to_host(obj), f, protocol=protocol)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    try:
        with open(tmp + ".opver", "w") as f:
            json.dump(op_version_map(), f)
        os.replace(tmp + ".opver", path + ".opver")
    except OSError:
        pass


def load(path: str, return_numpy: bool = False, device=None) -> Any:
    """Read a :func:`save` file (of either package). Arrays come back as
    tensors on ``device`` (default ``cuda:0``, see
    :func:`~..core.device.resolve_device`), or as numpy arrays with
    ``return_numpy=True``. Op-tagged payloads written under an older
    op-version map are upgraded."""
    from ..core.op_version import apply_upgrades, op_version_map
    with open(path, "rb") as f:
        obj = pickle.load(f)
    try:
        with open(path + ".opver") as f:
            saved_versions = json.load(f)
    except (OSError, ValueError):
        saved_versions = {}   # written before the registry: version 0
    if isinstance(obj, dict) and saved_versions != op_version_map():
        obj = apply_upgrades(obj, saved_versions)
    return obj if return_numpy else _to_device(obj, resolve_device(device))
