"""Device resolution: CUDA unless the caller asks for the CPU."""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "entry_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``.  Raises if CUDA is asked for (or
    defaulted to) and absent: there is no quiet CPU fallback.

    On CUDA, float32 matmuls and convolutions run in full float32: TF32
    is switched off (``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32``), as the JAX reference computes
    the L1 MLP in float32."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def entry_device(param: torch.Tensor, mesh=None, device=None) -> torch.device:
    """The device of a model entry point (``resolve_device(device)``),
    checked against a parameter's: raises if they differ, and for a
    ``mesh`` (the port runs on one device)."""
    if mesh is not None:
        raise NotImplementedError("the port runs on one device: mesh must be None")
    dev = resolve_device(device)
    if param.device.type != dev.type:
        raise ValueError(f"parameters lie on {param.device}, not on {dev}")
    return dev
