"""Op-version compatibility registry (``paddle_tpu/core/op_version.py``
counterpart; ref ``paddle/phi/api/yaml/op_version.yaml``).

A saved checkpoint carries a ``{op: version}`` map beside it
(:func:`paddle_tpu_torch.save` writes it to ``<path>.opver``); loading an
older one replays the registered upgrades over every op-tagged payload
dict (``{"__op__": "<name>", ...attrs}``): ``add_attr`` defaults,
``delete_attr``, ``rename_attr`` and converter hooks. The registry and its
entries are the JAX package's, so a checkpoint written by either package
loads in the other with the same upgrades.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

__all__ = ["OpVersionRegistry", "registry", "register_op_version",
           "op_version_map", "apply_upgrades"]


class _VersionBump:
    __slots__ = ("note", "actions", "converter")

    def __init__(self, note: str, actions: Optional[List[dict]] = None,
                 converter: Optional[Callable[[dict], dict]] = None):
        self.note = note
        self.actions = actions or []
        self.converter = converter


class OpVersionRegistry:
    """op name -> ordered list of version bumps (version = len(bumps))."""

    def __init__(self):
        self._ops: Dict[str, List[_VersionBump]] = {}

    def register(self, op: str, note: str,
                 actions: Optional[List[dict]] = None,
                 converter: Optional[Callable[[dict], dict]] = None) -> None:
        self._ops.setdefault(op, []).append(
            _VersionBump(note, actions, converter))

    def version_of(self, op: str) -> int:
        return len(self._ops.get(op, []))

    def version_map(self) -> Dict[str, int]:
        return {op: len(bumps) for op, bumps in self._ops.items()}

    def checkpoints(self, op: str) -> List[str]:
        return [b.note for b in self._ops.get(op, [])]

    def upgrade(self, op: str, payload: dict, from_version: int) -> dict:
        """Replay bumps (from_version, current] over a saved payload:
        add_attr actions inject their defaults; converter hooks run last
        per bump."""
        for bump in self._ops.get(op, [])[from_version:]:
            for action in bump.actions:
                if "add_attr" in action:
                    payload.setdefault(str(action["add_attr"]),
                                       action.get("default"))
                elif "delete_attr" in action:
                    payload.pop(str(action["delete_attr"]), None)
                elif "rename_attr" in action:
                    old, new = action["rename_attr"]
                    if old in payload:
                        payload[new] = payload.pop(old)
            if bump.converter is not None:
                payload = bump.converter(payload)
        return payload


registry = OpVersionRegistry()


def register_op_version(op: str, note: str, actions=None, converter=None):
    registry.register(op, note, actions=actions, converter=converter)


def op_version_map() -> Dict[str, int]:
    return registry.version_map()


def apply_upgrades(payload: Any, saved_versions: Dict[str, int]) -> Any:
    """Bring a loaded checkpoint forward. Upgrades apply only to op-tagged
    payload dicts anywhere in the structure; state_dicts of plain arrays
    pass through untouched."""
    if isinstance(payload, dict):
        op = payload.get("__op__")
        if isinstance(op, str) and registry.version_of(op):
            saved = int(saved_versions.get(op, 0))
            payload = registry.upgrade(op, dict(payload), saved)
        return {k: apply_upgrades(v, saved_versions)
                for k, v in payload.items()}
    if isinstance(payload, (list, tuple)):
        return type(payload)(apply_upgrades(v, saved_versions)
                             for v in payload)
    return payload


# -- the JAX package's registered bumps, the same op names and order ------
register_op_version(
    "adamw", "AdamW gained multi_precision (fp32 master weights); older "
    "optimizer states carry no master copy and default it off.",
    actions=[{"add_attr": "multi_precision", "default": False}])
register_op_version(
    "batch_norm", "BatchNorm apply folded to per-channel FMA in input "
    "dtype (round 3); stats unchanged — no payload action needed.",
    actions=[])
register_op_version(
    "flash_attention", "flash_attention gained segment_ids (packed varlen) "
    "inputs; absent means dense attention.",
    actions=[{"add_attr": "segment_ids", "default": None}])
