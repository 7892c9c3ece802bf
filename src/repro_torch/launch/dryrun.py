"""Multi-pod dry run (the reference's ``launch/dryrun.py``): every
(arch × shape) cell laid out on the production meshes and called on
``meta`` tensors, one rank's program under a fake process group, with
its memory, cost and collectives recorded per device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all                # 16×16
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod    # 2×16×16
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --reduced      # 2×4
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch grok-1-314b --shape train_4k

The reference lowers and compiles each cell with XLA and reads its
memory and cost analyses and its partitioned HLO.  Nothing compiles
here: the cell's ``fn`` runs eagerly on meta tensors (shapes and
dtypes, no data), its arguments placed by ``in_shardings`` as
``jax.jit`` places them, on one rank of a ``fake`` process group whose
collectives return at once.  That rank's call is the counterpart of
the per-device program XLA partitions; ``--rank`` picks the rank
(ranks may run different programs).  Nothing is allocated, so Grok-1's
314 B parameters cost no memory.

Per cell the JSON record holds the reference's keys, with these
meanings:

- ``t_run_s``: the meta call's wall time (for ``t_lower_s`` and
  ``t_compile_s``); ``n_ops``: the aten and collective ops it dispatched
  (for ``hlo_chars``);
- ``memory``, per device: ``argument_bytes``, the local shards of the
  placed arguments; ``output_bytes``, the local outputs;
  ``alias_bytes``, the outputs that share storage with donated
  arguments (a train step writes its parameters and moments in place);
  ``temp_bytes``, the peak of the storages created during the call that
  are not outputs (a live-storage tally); ``peak_bytes_est``, the
  reference's sum argument + output + temp − alias;
- ``cost``: ``flops_per_device``, ``FlopCounterMode``'s (matmuls,
  convolutions, attention) plus the operations the hand-written kernels
  report (``kernels/cost.py``); ``bytes_accessed_per_device``, the bytes
  of every aten op's tensor inputs and outputs, unfused (views and
  empty allocations move none), a kernel's reported bytes in place of
  its arguments': larger than XLA's fused count; ``transcendentals``,
  the elements that exp, log, tanh, rsqrt, sigmoid, erf and their kin
  produce, as XLA counts them;
- ``collectives``: ``collective_bytes``, result-shape bytes and counts
  per device under the reference's five names;
- ``kernels``: each hand-written kernel's calls and summed reported
  cost (``worst_case`` where a data-dependent cost took its largest
  value, as on meta it must); ``notes``: what the meta call could not
  run as the card would (a data-dependent loop counted once, as XLA's
  cost analysis counts a while body once);
- ``ok``, ``error`` and ``traceback`` as the reference records them; a
  failing cell is recorded and the run goes on.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels.cost import add_counter, remove_counter

__all__ = ["COLLECTIVES", "collective_bytes", "Counter", "counting",
           "place_args", "run_cell", "all_cells", "main"]

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# c10d's in-place ops (their first argument holds the result) and the
# functional collectives (their output is the result), by the
# reference's names
_KIND = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "recv_any_source_": "collective-permute",
}
_COMM_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional",
                    "_c10d_functional_autograd")
_NO_WORK = ("wait_tensor", "barrier", "monitored_barrier_")

# Ops that move no bytes: allocations that write nothing, aliases and
# reads of a scalar.
_ALLOC = {"empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided", "detach", "alias", "lift_fresh",
          "_local_scalar_dense", "resize_", "set_"}

# Elementwise ops that XLA counts as transcendentals, one an element.
_TRANSCENDENTAL = {"exp", "exp_", "exp2", "exp2_", "expm1", "log", "log_",
                   "log2", "log1p", "log10", "tanh", "tanh_", "rsqrt",
                   "rsqrt_", "sqrt", "sqrt_", "sigmoid", "sigmoid_", "erf",
                   "erf_", "erfinv", "sin", "cos", "pow", "_softmax",
                   "_log_softmax", "logsumexp", "silu", "silu_", "gelu",
                   "softplus", "logit", "atan2", "tan", "asin", "acos",
                   "atan", "sinh", "cosh", "asinh", "acosh", "atanh",
                   "reciprocal"}


def _tensors(tree):
    """The tensors in a tree of dicts, lists, tuples and dataclasses
    (``StateBins``)."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def collective_bytes(ops) -> dict:
    """Per-device bytes by collective type (result-shape bytes: what the
    op leaves on this rank) and counts, from ``ops``, the (type, bytes)
    pairs a ``Counter`` saw."""
    out = {c: 0 for c in COLLECTIVES}
    counts = {c: 0 for c in COLLECTIVES}
    for kind, nbytes in ops:
        out[kind] += nbytes
        counts[kind] += 1
    return {"bytes": out, "counts": counts}


class Counter(TorchDispatchMode):
    """One call's bytes, transcendentals, collectives and op count, and a
    live-storage tally of what it creates; the hand-written kernels'
    costs arrive through ``kernels/cost.py`` (``enter_kernel``,
    ``kernel``, ``exit_kernel``: the aten ops inside a kernel's scope are
    its own and counted only by its cost)."""

    def __init__(self, arguments=()):
        super().__init__()
        self.bytes = 0
        self.transcendentals = 0
        self.n_ops = 0
        self.collectives = []               # (type, result bytes)
        self.other_collectives = {}
        self.kernels = {}
        self.notes = []
        self._in_kernel = 0
        self._args = {_local(t).untyped_storage()._cdata for t in _tensors(arguments)}
        self._created = {}                  # storage id -> bytes, while alive
        self.live = self.peak = 0

    # the kernels' channel (kernels/cost.py)
    def enter_kernel(self) -> None:
        self._in_kernel += 1

    def exit_kernel(self) -> None:
        self._in_kernel -= 1

    def kernel(self, name: str, cost) -> None:
        k = self.kernels.setdefault(name, {"launches": 0, "flops": 0.0,
                                           "bytes": 0.0, "worst_case": False})
        k["launches"] += 1
        k["flops"] += float(cost.flops)
        k["bytes"] += float(cost.bytes)
        k["worst_case"] = k["worst_case"] or bool(cost.worst_case)

    def note(self, text: str) -> None:
        if text not in self.notes:
            self.notes.append(text)

    # the live-storage tally
    def _free(self, key: int) -> None:
        self.live -= self._created.pop(key, 0)

    def _track(self, out) -> None:
        for t in _tensors(out):
            if type(t) is not torch.Tensor:
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._args or key in self._created:
                continue
            n = st.nbytes()
            self._created[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def created_bytes(self, tensors) -> int:
        """The bytes of those of ``tensors``' storages that the call
        created and that are still alive."""
        seen = {}
        for t in tensors:
            key = _local(t).untyped_storage()._cdata
            if key in self._created:
                seen[key] = self._created[key]
        return sum(seen.values())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # DTensor desugars into local ops
        out = func(*args, **kwargs)
        self._track(out)
        if self._in_kernel:
            return out
        name = func._opname if hasattr(func, "_opname") else str(func)
        self.n_ops += 1
        if getattr(func, "namespace", "") in _COMM_NAMESPACES:
            kind = _KIND.get(name)
            if kind is None:
                if name not in _NO_WORK:
                    self.other_collectives[name] = (
                        self.other_collectives.get(name, 0) + 1)
                return out
            result = args[0] if func.namespace == "c10d" else out
            self.collectives.append((kind, sum(_nbytes(t) for t in _tensors(result))))
            return out
        if name in _ALLOC or getattr(func, "is_view", False):
            return out
        self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
        self.bytes += sum(_nbytes(t) for t in _tensors(out))
        if name in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in _tensors(out))
        return out


@contextlib.contextmanager
def counting(arguments=()):
    """Count a call: yields a ``Counter`` (the innermost mode, so that it
    sees each aten op before ``FlopCounterMode`` decomposes it), which
    holds ``flops`` (``FlopCounterMode``'s total plus the kernels'
    reported operations) and ``comm_counts`` (``CommDebugMode``'s, by
    op) when the block ends.  ``arguments`` are the call's inputs, whose
    storages are not the call's creations."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils.flop_counter import FlopCounterMode

    comm = CommDebugMode()
    flops = FlopCounterMode(display=False)
    counter = Counter(arguments)
    with comm, flops:
        with counter:
            add_counter(counter)
            try:
                yield counter
            finally:
                remove_counter(counter)
    counter.aten_flops = float(flops.get_total_flops())
    counter.flops = counter.aten_flops + sum(k["flops"]
                                             for k in counter.kernels.values())
    counter.comm_counts = {str(k): v for k, v in comm.get_comm_counts().items()}


def place_args(args, in_shardings):
    """Each argument placed by its sharding, as ``jax.jit(in_shardings=)``
    places it: a ``NamedSharding`` applies to every leaf under it (the
    reference's prefix trees); None leaves an argument as it is."""
    from repro_torch.distributed.elastic import reshard_tree
    from repro_torch.distributed.sharding_rules import NamedSharding
    from repro_torch.train.tree import tree_map

    def place(sub, sh):
        if sh is None:
            return sub
        if isinstance(sh, NamedSharding):
            if dataclasses.is_dataclass(sub):        # StateBins
                return dataclasses.replace(sub, **{
                    f.name: place(getattr(sub, f.name), sh)
                    for f in dataclasses.fields(sub)})
            return reshard_tree(sub, tree_map(lambda _: sh.spec, sub), sh.mesh)
        if isinstance(sh, dict):
            return {k: place(sub[k], sh[k]) for k in sub}
        return type(sub)(place(x, s) for x, s in zip(sub, sh))

    if in_shardings is None:
        return tuple(args)
    return tuple(place(a, s) for a, s in zip(args, in_shardings))


def run_cell(arch_id: str, shape_name: str, mesh, mesh_name: str,
             reduced: bool = False, cfg_override=None,
             shape_params=None) -> dict:
    """The cell's record (see the module's note).  ``cfg_override`` and
    ``shape_params`` replace the arch's config and update its shape's
    parameters (a cut call, such as ``chip_smoke.py``'s)."""
    from repro_torch.launch.steps import build_cell

    rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
           "devices": int(mesh.size()) if mesh is not None else 1}
    try:
        cell = build_cell(arch_id, shape_name, mesh=mesh, reduced=reduced,
                          cfg_override=cfg_override, shape_params=shape_params)
        args = place_args(cell.args, cell.in_shardings)
        donated = [t for i in cell.donate_argnums for t in _tensors(args[i])]
        gc.collect()
        t0 = time.perf_counter()
        with counting(args) as c:
            out = cell.fn(*args)
        rec["t_run_s"] = round(time.perf_counter() - t0, 2)
        outs = [_local(t) for t in _tensors(out)]
        donated_keys = {_local(t).untyped_storage()._cdata for t in donated}
        arg_b = sum(_nbytes(_local(t)) for t in _tensors(args))
        out_b = sum(_nbytes(t) for t in outs)
        alias_b = sum(_nbytes(t) for t in outs
                      if t.untyped_storage()._cdata in donated_keys)
        temp_b = max(c.peak - c.created_bytes(outs), 0)
        rec["memory"] = {
            "argument_bytes": int(arg_b), "output_bytes": int(out_b),
            "temp_bytes": int(temp_b), "alias_bytes": int(alias_b),
            "peak_bytes_est": int(arg_b + out_b + temp_b - alias_b)}
        rec["cost"] = {"flops_per_device": c.flops,
                       "bytes_accessed_per_device": float(
                           c.bytes + sum(k["bytes"] for k in c.kernels.values())),
                       "transcendentals": float(c.transcendentals),
                       "aten_flops_per_device": c.aten_flops,
                       "aten_bytes_per_device": float(c.bytes)}
        rec["collectives"] = collective_bytes(c.collectives)
        rec["comm_debug_counts"] = c.comm_counts
        if c.other_collectives:
            rec["other_collectives"] = c.other_collectives
        rec["kernels"] = c.kernels
        rec["notes"] = c.notes
        rec["n_ops"] = c.n_ops
        rec["ok"] = True
        del out, outs, args, donated, cell, c
        gc.collect()
    except Exception as e:  # noqa: BLE001 — record and continue
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    return rec


def all_cells():
    from repro_torch.configs import list_archs

    return [(a.arch_id, s) for a in list_archs().values() for s in a.shapes]


def _value(text: str):
    low = text.lower()
    if low in ("true", "false"):
        return low == "true"
    for kind in (int, float):
        try:
            return kind(text)
        except ValueError:
            pass
    return text


def _pairs(items):
    out = {}
    for item in items or ():
        key, _, val = item.partition("=")
        out[key] = _value(val)
    return out


@contextlib.contextmanager
def fake_world(world: int, rank: int = 0):
    """A ``fake`` default process group of ``world`` ranks, this process
    rank ``rank``: its collectives return at once."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced configs and shapes, on a 2 x 4 mesh unless "
                         "--mesh, --multi-pod or --both-meshes is given")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank whose program runs (ranks may differ)")
    ap.add_argument("--mesh", help="a (data, model) mesh DxM in place of the "
                                   "production meshes, e.g. 2x4 or 1x1")
    ap.add_argument("--set", action="append", metavar="FIELD=VALUE",
                    help="a model-config field for every cell (repeatable)")
    ap.add_argument("--shape-param", action="append", metavar="KEY=VALUE",
                    help="a shape parameter for every cell (repeatable)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh

    if args.mesh:
        d, m = (int(x) for x in args.mesh.lower().split("x"))
        layouts = [(f"local{d}x{m}", d * m,
                    lambda d=d, m=m: make_local_mesh(d, m, device="cpu"))]
    elif args.reduced and not (args.multi_pod or args.both_meshes):
        layouts = [("local2x4", 8, lambda: make_local_mesh(2, 4, device="cpu"))]
    else:
        pod = ("pod16x16", 256,
               lambda: make_production_mesh(multi_pod=False, device="cpu"))
        multi = ("multipod2x16x16", 512,
                 lambda: make_production_mesh(multi_pod=True, device="cpu"))
        layouts = ([pod, multi] if args.both_meshes
                   else [multi] if args.multi_pod else [pod])

    cells = all_cells() if args.all else [(args.arch, args.shape)]
    sets, shape_params = _pairs(args.set), _pairs(args.shape_param)
    outdir = Path(args.out)
    for mesh_name, world, make in layouts:
        with fake_world(world, args.rank):
            mesh = make()
            for arch_id, shape_name in cells:
                path = outdir / mesh_name / f"{arch_id}__{shape_name}.json"
                path.parent.mkdir(parents=True, exist_ok=True)
                over = None
                if sets:
                    over = dataclasses.replace(
                        get_arch(arch_id).model_cfg(args.reduced), **sets)
                t0 = time.time()
                rec = run_cell(arch_id, shape_name, mesh, mesh_name, args.reduced,
                               cfg_override=over, shape_params=shape_params or None)
                path.write_text(json.dumps(rec, indent=1))
                status = "OK " if rec.get("ok") else "FAIL"
                print(f"[{status}] {mesh_name:16s} {arch_id:24s} {shape_name:16s} "
                      f"{time.time() - t0:6.1f}s "
                      + (f"peak={rec['memory']['peak_bytes_est']/2**30:.2f}GiB "
                         f"flops/dev={rec['cost']['flops_per_device']:.3g}"
                         if rec.get("ok") else rec.get("error", "")[:120]),
                      flush=True)


if __name__ == "__main__":
    main()
