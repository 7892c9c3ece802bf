"""Nested containers of tensors in the reference's pytree order.

The reference's states are JAX pytrees; the port's are nested dicts,
lists and tuples of tensors.  ``tree_leaves`` orders leaves as
``jax.tree_util.tree_flatten`` does: a dict by sorted key, a list or
tuple in order; ``None`` holds no leaf; anything else is a leaf.  That
order is the optimizers' and the checkpoints' (``leaf_NNNNN.npy``).
"""
from __future__ import annotations

from typing import Any, Callable, List

__all__ = ["tree_leaves", "tree_unflatten", "tree_map", "leaf_paths",
           "treedef_str"]


def _children(node):
    """(keys, children) of a container node, in flatten order; None for
    a leaf."""
    if isinstance(node, dict):
        keys = sorted(node)
        return keys, [node[k] for k in keys]
    if isinstance(node, (list, tuple)):
        return list(range(len(node))), list(node)
    return None


def _walk(node, path, out):
    if node is None:
        return
    kids = _children(node)
    if kids is None:
        out.append((path, node))
        return
    for k, child in zip(*kids):
        _walk(child, path + (k,), out)


def tree_leaves(tree) -> List[Any]:
    """The leaves in the reference's order."""
    out: list = []
    _walk(tree, (), out)
    return [leaf for _, leaf in out]


def leaf_paths(tree) -> List[str]:
    """Each leaf's keys joined by "/", as the reference's checkpoint
    manifest writes them ("params/layers/attn/wq", "opt/count")."""
    out: list = []
    _walk(tree, (), out)
    return ["/".join(str(k) for k in path) for path, _ in out]


def tree_unflatten(structure, leaves):
    """A copy of ``structure`` (a tree) with its leaves, in flatten
    order, replaced by ``leaves``."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        kids = _children(node)
        if kids is None:
            return next(it)
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in kids[0]}
            return {k: built[k] for k in node}        # the input's key order
        return type(node)(build(c) for c in node)

    out = build(structure)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the structure holds")
    return out


_END = object()


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree``; ``rest`` are trees of the same
    structure down to ``tree``'s leaves, whose values there (leaves or
    whole subtrees, as ``flatten_up_to``) are passed along."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                      for i, v in enumerate(tree))


def treedef_str(tree) -> str:
    """The structure as ``str(jax.tree_util.tree_structure(tree))``
    writes it: ``PyTreeDef({'a': *, 'b': (*, None)})``."""
    def fmt(node):
        if node is None:
            return "None"
        kids = _children(node)
        if kids is None:
            return "*"
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {fmt(node[k])}" for k in kids[0]) + "}"
        inner = ", ".join(fmt(c) for c in node)
        if isinstance(node, tuple):
            return f"({inner},)" if len(node) == 1 else f"({inner})"
        return f"[{inner}]"

    return f"PyTreeDef({fmt(tree)})"
