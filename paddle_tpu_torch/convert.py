"""Carry weights from the JAX package's state_dict into the port's modules.

The JAX layers keep Linear weights as ``[in, out]`` (Paddle's layout); the
port's ``nn.Linear`` keeps ``[out, in]``. :func:`from_jax_state_dict`
transposes every Linear weight and copies everything else (biases,
embeddings, LayerNorm and BatchNorm scales, BatchNorm's running-stat
buffers, conv weights) as it is. Keys are the same on both sides,
so ``model.load_state_dict(from_jax_state_dict(sd))`` (strict) proves that
no key is dropped and none is left uninitialised. :func:`to_jax_state_dict`
is its inverse, and :func:`from_jax_optimizer_state` carries the JAX
optimizer state (moments, velocities and master weights laid out like
their parameters, so transposed with them) into the port's optimizers.
:func:`from_jax_checkpoint` rewrites the files of the JAX ``Model.save``
(``.pdparams``, ``.pdopt``) in the port's layout, for ``Model.load``.

Which weights are Linear weights: given the port's module (``module=``),
exactly the 2-D ``weight*`` parameters of its :class:`~.nn.layers.Linear`
sublayers (``weight``, and ``weight_g``/``weight_v``/``weight_orig``
under weight or spectral norm), whatever their names; without it, the
name rule of :data:`LINEAR_NAMES`, which the earlier models' keys follow.
The vision models need the module: VGG's and AlexNet's ``classifier.N``
and GoogLeNet's ``fc1``/``fc2`` are Linears the names miss, and
MobileNetV3's squeeze-excite ``fc1``/``fc2`` are 1x1 convolutions.

A transposed Linear keeps the JAX column order as row order: the fused
``qkv_proj`` output ``(3, H, D)`` and the GQA ``kv_proj`` output
``(2, KH, D)`` split the same way in both packages.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["LINEAR_NAMES", "linear_weight_keys", "from_jax_state_dict",
           "to_jax_state_dict",
           "from_jax_optimizer_state", "from_jax_checkpoint"]

#: attribute names of the Linear layers whose weights are transposed (GPT,
#: then BERT's encoder layers and heads, then ResNet's classifier, then
#: ERNIE's SOP head and its pipeline head's transform and untied MLM
#: projection). Conv weights are OIHW in both packages and copy as they are.
LINEAR_NAMES = frozenset({"qkv_proj", "q_proj", "kv_proj", "out_proj", "up",
                          "down", "lm_head", "k_proj", "v_proj", "linear1",
                          "linear2", "pooler", "mlm_transform", "nsp_head",
                          "fc", "sop_head", "transform", "proj"})


def _is_linear_weight(key: str) -> bool:
    parts = key.split(".")
    if len(parts) < 2 or parts[-1] != "weight":
        return False
    # a Linear under one of the names, or in a Sequential under one of them
    # (LeNet's fc.0, fc.1, fc.2)
    return parts[-2] in LINEAR_NAMES or (
        len(parts) >= 3 and parts[-2].isdigit() and parts[-3] in LINEAR_NAMES)


def linear_weight_keys(module) -> frozenset:
    """The state_dict keys of the 2-D ``weight*`` parameters of the
    module's Linear sublayers (the port's, or torch's ``nn.Linear``)."""
    keys = set()
    for name, mod in module.named_modules():
        if isinstance(mod, torch.nn.Linear):
            for pname, p in mod.named_parameters(recurse=False):
                if pname.startswith("weight") and p.dim() == 2:
                    keys.add(f"{name}.{pname}" if name else pname)
    return frozenset(keys)


def _linear_rule(module):
    if module is None:
        return _is_linear_weight
    return linear_weight_keys(module).__contains__


def from_jax_state_dict(np_dict: Mapping[str, np.ndarray], module=None
                        ) -> Dict[str, torch.Tensor]:
    """JAX ``state_dict()`` as numpy arrays -> a torch state_dict for the
    port's module of the same structure (Linear weights transposed: those
    of ``module`` when given, else by the name rule)."""
    is_linear = _linear_rule(module)
    out: Dict[str, torch.Tensor] = {}
    for key, arr in np_dict.items():
        a = np.asarray(arr)
        if is_linear(key):
            if a.ndim != 2:
                raise ValueError(f"{key}: Linear weight must be 2-D, got "
                                 f"shape {a.shape}")
            a = a.T
        out[key] = torch.from_numpy(np.array(a, order="C"))  # owned copy
    return out


def to_jax_state_dict(sd: Mapping[str, torch.Tensor], module=None
                      ) -> Dict[str, np.ndarray]:
    """The port's state_dict -> numpy arrays in the JAX layout (Linear
    weights, those of ``module`` when given, transposed back to ``[in,
    out]``); float32 copies of bf16."""
    is_linear = _linear_rule(module)
    out: Dict[str, np.ndarray] = {}
    for key, t in sd.items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        a = t.numpy()
        out[key] = np.array(a.T if is_linear(key) else a, order="C")
    return out


def from_jax_optimizer_state(state: Mapping[str, Any]) -> Dict[str, Any]:
    """JAX ``opt.init``/``apply_gradients`` state with numpy leaves ->
    the port's optimizer state: ``{"step": int32 tensor, "param_states":
    {name: {key: float32 tensor}}}``, each leaf of a Linear weight
    transposed like the weight."""
    pstates = {}
    for name, st in state["param_states"].items():
        pstates[name] = {}
        for key, arr in st.items():
            a = np.asarray(arr, dtype=np.float32)
            if _is_linear_weight(name) and a.ndim == 2:
                a = a.T
            pstates[name][key] = torch.from_numpy(np.array(a, order="C"))
    step = torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32)
    return {"step": step, "param_states": pstates}


def from_jax_checkpoint(src: str, dst: str) -> None:
    """Rewrite the JAX package's ``Model.save(src)`` files as the port's
    ``Model.save(dst)`` would write them: ``dst.pdparams`` with every Linear
    weight transposed, and ``dst.pdopt`` (where ``src.pdopt`` exists) with
    each ``"<name>@<key>"`` entry of a Linear weight transposed like it;
    ``step`` and ``LR_Scheduler`` as they are."""
    from .framework.io import load, save

    def port_layout(name, a):
        return np.ascontiguousarray(a.T) if _is_linear_weight(name) and \
            np.ndim(a) == 2 else a

    params = load(src + ".pdparams", return_numpy=True)
    save({k: port_layout(k, a) for k, a in params.items()},
         dst + ".pdparams")
    if os.path.exists(src + ".pdopt"):
        opt = load(src + ".pdopt", return_numpy=True)
        save({k: port_layout(k.rpartition("@")[0], v)
              for k, v in opt.items()}, dst + ".pdopt")
