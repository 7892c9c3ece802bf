"""Parameter / input partition specs per architecture family (the
reference's ``distributed/sharding_rules.py``), and the port's own
``PartitionSpec`` and ``NamedSharding`` in place of ``jax.sharding``'s.

Megatron-style TP over ``model`` (attention heads, FFN hidden, vocab,
experts, embedding rows), DP over ``pod`` x ``data``, ZeRO-1-style
optimizer state sharding over ``data`` (states replicate across pods),
KV-cache sequence sharding over ``model`` for decode.

Rules pattern-match on parameter-tree paths (the leaves' keys joined by
"/", as ``train/tree.py``'s ``leaf_paths``), so they work for any config
of a family without per-arch tables.  They are pure functions of shapes:
a ``mesh`` is a ``DeviceMesh`` or a plain ``{axis: size}`` mapping, so
that the production sizes can be planned without a world.

A spec turns into DTensor placements with :func:`to_placements`: mesh
dim ``a`` is ``Shard(d)`` where tensor dim ``d`` names ``a``, else
``Replicate()``.  A dim sharded over several axes lists them in the
mesh's order, major first, as ``P(("data", "model"))`` lays rows out
data-major.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

from repro_torch.train.tree import leaf_paths, tree_leaves, tree_map, tree_unflatten

__all__ = ["PartitionSpec", "P", "NamedSharding", "mesh_shape", "to_placements",
           "data_axes", "lm_param_specs", "zero1_state_specs", "kv_cache_specs",
           "kv_cache_spec",
           "gnn_param_specs", "recsys_param_specs", "spec_tree"]


def _entry(e):
    """One dim's entry as ``jax.sharding.PartitionSpec`` keeps it: None,
    an axis name, or a tuple of two or more names (``()`` is None,
    ``("a",)`` is ``"a"``)."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        if not e:
            return None
        return e[0] if len(e) == 1 else e
    return e


class PartitionSpec:
    """The reference's ``P``: one entry per tensor dim (None, a mesh-axis
    name, or a tuple of names), compared and iterated entry by entry.  Not
    a tuple, so that the tree functions take it as a leaf."""

    __slots__ = ("_entries",)

    def __init__(self, *entries):
        self._entries = tuple(_entry(e) for e in entries)

    def __iter__(self):
        return iter(self._entries)

    def __len__(self):
        return len(self._entries)

    def __getitem__(self, i):
        return self._entries[i]

    def __eq__(self, other):
        return (isinstance(other, PartitionSpec)
                and self._entries == other._entries)

    def __hash__(self):
        return hash(self._entries)

    def __repr__(self):
        return f"PartitionSpec{self._entries!r}"

    def axes(self):
        """Every axis name the spec uses, in order."""
        out = []
        for e in self._entries:
            out.extend(e if isinstance(e, tuple) else (() if e is None else (e,)))
        return out


P = PartitionSpec


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh`` or of a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def to_placements(spec: PartitionSpec, mesh) -> Tuple[Any, ...]:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    dim_of = {}
    for d, e in enumerate(spec):
        axes = e if isinstance(e, tuple) else (() if e is None else (e,))
        if [names.index(a) for a in axes] != sorted(names.index(a) for a in axes):
            raise ValueError(f"{spec}: the axes of dim {d} must follow the "
                             f"mesh's order {names}")
        for a in axes:
            if a in dim_of:
                raise ValueError(f"{spec}: axis {a!r} shards two dims")
            dim_of[a] = d
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate() for a in names)


class NamedSharding:
    """A spec on a mesh: the port's ``jax.sharding.NamedSharding``."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh, self.spec = mesh, spec

    @property
    def placements(self):
        return to_placements(self.spec, self.mesh)

    def __repr__(self):
        return f"NamedSharding({self.spec!r})"


def data_axes(mesh) -> Tuple[str, ...]:
    shape = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in shape)


def _lm_rule(path: str, shape=None, model_size=None, fsdp=False, zero3=False) -> P:
    """Path-pattern → spec for stacked transformer params (leading L dim)."""
    # MoE experts: (L, E, d, f). EP over model when E divides the axis;
    # otherwise TP over d_ff (grok-1: 8 experts on a 16-way axis).
    # With fsdp=True the d_model axis additionally shards over `data`.
    if "experts" in path:
        e = shape[1] if shape is not None else None
        d_axis = "data" if fsdp else None
        if model_size and e is not None and e % model_size != 0:
            if path.endswith("w_down"):
                return P(None, None, "model", d_axis)
            return P(None, None, d_axis, "model")
        if path.endswith("w_down"):
            return P(None, "model", None, d_axis)
        return P(None, "model", d_axis, None)
    if "router" in path:
        return P()
    if zero3 and path.endswith(("wq", "wk", "wv", "wo", "w_gate", "w_up",
                                 "w_down")):
        return P(None, "data", "model")       # ZeRO-3 dense: gathered per layer
    if zero3 and path.endswith(("b_up", "b_down")):
        return P(None, "model")
    if path.endswith(("wq", "wk", "wv", "w_uk", "w_uv")):
        return P(None, None, "model")          # (L, d, heads*dh) — heads sharded
    if path.endswith("w_dkv"):
        return P(None, None, None)             # (L, d, r+dr) — small, replicated
    if path.endswith("wo"):
        return P(None, "model", None)          # (L, heads*dh, d)
    if path.endswith(("w_gate", "w_up")):
        return P(None, None, "model")          # (L, d, dff)
    if path.endswith("w_down"):
        return P(None, "model", None)          # (L, dff, d)
    if path.endswith("b_up"):
        return P(None, "model")
    if path.endswith("embed"):
        if zero3:
            return P()                         # replicated: batch owns `model`
        return P("model", None)                # (V, d) vocab-sharded
    if path.endswith("lm_head"):
        if zero3:
            return P()
        return P(None, "model")                # (d, V)
    return P()                                 # norms, biases


def spec_tree(params, rule) -> Any:
    """``rule(path, leaf)`` over a tree, its structure kept."""
    specs = [rule(path, leaf)
             for path, leaf in zip(leaf_paths(params), tree_leaves(params))]
    return tree_unflatten(params, specs)


def lm_param_specs(params, model_size: int | None = None, fsdp: bool = False,
                   zero3: bool = False) -> Any:
    return spec_tree(
        params,
        lambda path, leaf: _lm_rule(path, tuple(leaf.shape), model_size, fsdp,
                                    zero3))


def zero1_state_specs(params, param_specs, mesh, axis: str = "data") -> Any:
    """Optimizer-moment specs: param spec + ``axis`` added on the largest
    still-unsharded dim that divides evenly (ZeRO-1)."""
    n = mesh_shape(mesh)[axis]

    def add_axis(p, spec: P) -> P:
        shape = tuple(p.shape)
        entries = list(spec) + [None] * (len(shape) - len(spec))
        if axis in spec.axes():
            return spec                  # FSDP leaves already consume `data`
        best, best_size = None, 0
        for i, (s, e) in enumerate(zip(shape, entries)):
            if e is None and s % n == 0 and s // n > 0 and s > best_size:
                best, best_size = i, s
        if best is None:
            return spec
        entries[best] = axis
        return P(*entries)

    return tree_map(add_axis, params, param_specs)


def kv_cache_specs(cache, mesh) -> Any:
    """Decode KV cache: batch over data axes when divisible, sequence over
    ``model`` (layouts (L, B, S, kv, dh) or (L, B, S, r))."""
    return tree_map(lambda leaf: kv_cache_spec(leaf.shape, mesh), cache)


def kv_cache_spec(shape, mesh) -> P:
    """``kv_cache_specs``' spec of one field of ``shape`` (L, B, S, ...),
    from the shape alone."""
    sizes = mesh_shape(mesh)
    dp = data_axes(mesh)
    dp_size = 1
    for a in dp:
        dp_size *= sizes[a]
    b = shape[1]
    batch_axes = dp if b % dp_size == 0 and b >= dp_size else ()
    rest = [None] * (len(shape) - 3)
    return P(None, batch_axes if batch_axes else None, "model", *rest)


def gnn_param_specs(params, model_size: int | None = None) -> Any:
    def rule(path: str, leaf) -> P:
        if path.endswith(("w_self", "w_neigh")):
            # hidden sharded — but the classifier layer's tiny class dim
            # (e.g. 7/41/47) stays replicated
            if model_size and leaf.shape[1] % model_size == 0:
                return P(None, "model")
        return P()
    return spec_tree(params, rule)


def recsys_param_specs(params, model_size: int | None = None) -> Any:
    def rule(path: str, leaf) -> P:
        if path.endswith(("embed", "item_embed", "wide", "first_order")):
            # big tables row-shard; tiny ones (pos_embed) replicate
            if (leaf.dim() == 2
                    and (model_size is None or leaf.shape[0] % model_size == 0)
                    and leaf.shape[0] >= 4096):
                return P("model", None)
        return P()                              # dense towers replicated (small)
    return spec_tree(params, rule)
