"""Device resolution: CUDA unless the caller asks for the CPU."""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "entry_device", "seeded_generator", "mesh_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``.  Raises if CUDA is asked for (or
    defaulted to) and absent: there is no quiet CPU fallback.  ``meta``
    makes shape-only tensors (nothing is computed; the torch form of the
    reference's ``jax.eval_shape``).

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
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class _MetaGenerator(torch.Generator):
    """A CPU generator that reports the ``meta`` device, so that the
    initialisers, which make their tensors on ``gen.device``, make
    shape-only ones (a random fill of a meta tensor draws nothing)."""

    @property
    def device(self):
        return torch.device("meta")


def seeded_generator(seed: int, device=None) -> torch.Generator:
    """A ``torch.Generator`` on ``resolve_device(device)`` seeded with
    ``seed``; on ``meta``, one whose initialisers make meta tensors."""
    dev = resolve_device(device)
    gen = _MetaGenerator() if dev.type == "meta" else torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def mesh_device(mesh) -> torch.device:
    """This rank's device of a ``DeviceMesh``: its card on ``cuda``
    (``launch/mesh.py`` sets rank r on card r), else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def entry_device(param: torch.Tensor, mesh=None, device=None) -> torch.device:
    """The device of a model entry point, checked against a parameter's
    (a tensor or a DTensor's local block): raises if they differ.  With
    no ``mesh``, ``resolve_device(device)``; with a ``DeviceMesh``, the
    mesh's device type on this rank's card (``device``, if given, must
    name the same type).  Anything else as ``mesh`` raises.  Parameters
    on ``meta`` (a dry run: shapes only) give ``meta`` with or without a
    mesh, whatever device the mesh names."""
    if mesh is not None:
        from torch.distributed.device_mesh import DeviceMesh

        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a torch.distributed DeviceMesh, "
                            f"not {type(mesh).__name__}")
    if param.device.type == "meta" and (
            device is None or torch.device(device).type == "meta"):
        return torch.device("meta")
    if mesh is None:
        dev = resolve_device(device)
    else:
        dev = mesh_device(mesh)
        if device is not None and resolve_device(device).type != dev.type:
            raise ValueError(f"device {device} is not the mesh's {dev.type}")
    if param.device.type != dev.type:
        raise ValueError(f"parameters lie on {param.device}, not on {dev}")
    return dev
