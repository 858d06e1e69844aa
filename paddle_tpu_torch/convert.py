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

A transposed Linear keeps the JAX column order as row order: the fused
``qkv_proj`` output ``(3, H, D)`` and the GQA ``kv_proj`` output
``(2, KH, D)`` split the same way in both packages.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["LINEAR_NAMES", "from_jax_state_dict", "to_jax_state_dict",
           "from_jax_optimizer_state"]

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
    return (len(parts) >= 2 and parts[-1] == "weight"
            and parts[-2] in LINEAR_NAMES)


def from_jax_state_dict(np_dict: Mapping[str, np.ndarray]
                        ) -> Dict[str, torch.Tensor]:
    """JAX ``state_dict()`` as numpy arrays -> a torch state_dict for the
    port's module of the same structure (Linear weights transposed)."""
    out: Dict[str, torch.Tensor] = {}
    for key, arr in np_dict.items():
        a = np.asarray(arr)
        if _is_linear_weight(key):
            if a.ndim != 2:
                raise ValueError(f"{key}: Linear weight must be 2-D, got "
                                 f"shape {a.shape}")
            a = a.T
        out[key] = torch.from_numpy(np.array(a, order="C"))  # owned copy
    return out


def to_jax_state_dict(sd: Mapping[str, torch.Tensor]
                      ) -> Dict[str, np.ndarray]:
    """The port's state_dict -> numpy arrays in the JAX layout (Linear
    weights transposed back to ``[in, out]``); float32 copies of bf16."""
    out: Dict[str, np.ndarray] = {}
    for key, t in sd.items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        a = t.numpy()
        out[key] = np.array(a.T if _is_linear_weight(key) else a, order="C")
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
