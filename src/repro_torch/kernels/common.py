"""Small helpers shared by the kernel wrappers (copied from the
reference's ``kernels/common.py``)."""
from __future__ import annotations

__all__ = ["NEG_INF", "cdiv"]

NEG_INF = float("-inf")


def cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b
