"""What a kernel call costs, reported to the counters of a dry run.

A hand-written kernel is a ctypes call that no ``TorchDispatchMode``
sees, and on ``meta`` tensors it computes nothing.  So each wrapper
states its own cost, its operations and the bytes it must move (each
input read once, each output written once), through ``run``: while a
counter is active (``launch/dryrun.py``'s ``counting``) the call's cost
is handed to it, and the aten ops the wrapper makes inside (its output
buffers, on the card its scratch) are left out of its byte count, so
that a kernel counts its reported bytes and not its arguments' bytes.
With no counter active ``run`` is one Python call more than the launch.

The same cost functions give ``chip_smoke.py`` its bounds (the bytes
over the memory rate, the operations over the rate for their type).
A cost that depends on the data (the chunk scan's active planes, the
decode's key lengths, the bag's distinct rows, the gather's edges in a
segment) is counted from the data on the card and at its worst case on
``meta``, where no value can be read; such a cost says so
(``worst_case``).

``note`` records what a dry run should know about a path it could not
run as the card would (a data-dependent loop counted once); the
counters keep each note once.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple

__all__ = ["KernelCost", "run", "note", "add_counter", "remove_counter",
           "H100_SMS"]

# The SMs of the card a dry run lays a route out for (an H100 SXM), where
# a route depends on the card (the bag's ``bag_route``) and the tensors
# lie on ``meta``.
H100_SMS = 132


class KernelCost(NamedTuple):
    """One call's operations (multiply-adds count 2; the block scans'
    32-bit integer operations count 1 each) and the bytes it must move;
    ``worst_case`` where a data-dependent part took its largest value."""
    flops: float
    bytes: float
    worst_case: bool = False


_COUNTERS: List = []


def add_counter(counter) -> None:
    _COUNTERS.append(counter)


def remove_counter(counter) -> None:
    _COUNTERS.remove(counter)


def run(name: str, cost: Callable[[], KernelCost], fn: Callable, *args):
    """``fn(*args)``, the launch (or the meta outputs) of kernel ``name``.
    While a counter is active, ``cost()`` is reported to it and the aten
    ops inside ``fn`` are its kernel's, not counted on their own."""
    if not _COUNTERS:
        return fn(*args)
    counters = list(_COUNTERS)
    for k in counters:
        k.enter_kernel()
    try:
        # inside the kernel's scope: reading the data for a cost (on the
        # card) is no op of the step's own
        c = cost()
        for k in counters:
            k.kernel(name, c)
        return fn(*args)
    finally:
        for k in counters:
            k.exit_kernel()


def note(text: str) -> None:
    """Tell the active counters ``text`` (kept once each)."""
    for k in _COUNTERS:
        k.note(text)
