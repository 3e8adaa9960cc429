"""Production mesh construction (twin of ``repro.launch.mesh``).

Functions, never module-level constants: importing this module touches
no process group.  Both build a ``DeviceMesh`` with ``init_device_mesh``
over the default process group, which the caller initialises first with
a world size equal to the mesh's device count (NCCL on the cards, gloo
on the CPU, the ``fake`` backend for the dry-run).
"""

from __future__ import annotations

from typing import Sequence

__all__ = ["make_production_mesh", "make_smoke_mesh"]


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """(16, 16) = 256 devices a pod, axes ("data", "model"); multi-pod
    adds a leading 2-way "pod" axis (the slow one) = 512 devices."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device, shape, mesh_dim_names=axes)


def make_smoke_mesh(shape: Sequence[int] = (1, 1),
                    axes: Sequence[str] = ("data", "model"), *,
                    device: str = "cuda"):
    """A small mesh (one device by default) that runs the sharding code
    paths on whatever process group is up."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device, tuple(shape),
                            mesh_dim_names=tuple(axes))
