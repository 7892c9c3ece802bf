"""Config surface: every ported architecture is a selectable ArchDef
carrying its exact published config, a reduced smoke variant, and its
own input-shape set (copied from the reference's ``configs/base.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

__all__ = ["ShapeSpec", "ArchDef", "register", "get_arch", "list_archs"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode | serve | retrieval | train_graph ...
    params: Dict[str, Any]
    note: str = ""


@dataclasses.dataclass
class ArchDef:
    arch_id: str
    family: str                          # lm | gnn | recsys | websearch
    source: str                          # [citation; verification tier]
    model_cfg: Callable[[bool], Any]     # reduced -> config object
    shapes: Dict[str, ShapeSpec]
    notes: str = ""

    def shape(self, name: str) -> ShapeSpec:
        return self.shapes[name]


_REGISTRY: Dict[str, ArchDef] = {}


def register(arch: ArchDef) -> ArchDef:
    _REGISTRY[arch.arch_id] = arch
    return arch


def get_arch(arch_id: str) -> ArchDef:
    """The arch ``arch_id``; ``KeyError`` for an unknown id, as in the
    reference."""
    from . import _load_all
    _load_all()
    return _REGISTRY[arch_id]


def list_archs():
    from . import _load_all
    _load_all()
    return dict(_REGISTRY)
