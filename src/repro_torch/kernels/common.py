"""Small helpers shared by the kernel wrappers (``NEG_INF`` and ``cdiv``
copied from the reference's ``kernels/common.py``)."""
from __future__ import annotations

__all__ = ["NEG_INF", "cdiv", "refuse_grad"]

NEG_INF = float("-inf")


def cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b


def refuse_grad(name: str, *tensors) -> None:
    """Raise if autograd would need a backward through the CUDA kernel
    ``name``: grad mode on and an input that requires grad.  The kernels
    have none, as the reference's Pallas kernels have no VJP; its LMs
    train through the plain attention (``use_flash=False``)."""
    import torch

    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward on CUDA: train through the plain "
            f"attention (use_flash=False), or call it under torch.no_grad()")
