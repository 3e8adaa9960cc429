"""The port's device catalog (twin of ``repro.arch.registry``): one
:class:`DeviceSpec` per device the port runs on.

It registers only ``h100``, from NVIDIA's published figures; its MFMA
cycle table is empty (the H100 has no MFMA instructions, and the
reference's timing model has not been fitted to its tensor cores), so
nothing in it is ``validated``.  Every roofline bound that
``chip_smoke.py`` prints reads the HBM rate and the bf16 peak from here.
The reference's five devices (mi200, mi300, mi300x, tpu_v5e, tpu_v5p)
come with the perf front-end (ROADMAP queue 1).
"""

from __future__ import annotations

from typing import Dict, Iterable

from repro_torch.arch.spec import (DeviceSpec, Interconnect, MemoryHierarchy,
                                   UnknownDeviceError)

__all__ = [
    "H100",
    "register_device",
    "get_device",
    "list_devices",
    "UnknownDeviceError",
]


# NVIDIA H100 SXM5 80GB (NVIDIA H100 Tensor Core GPU data sheet and the
# Hopper architecture white paper).  Memory latencies keep the schema's
# defaults (the paper's MI200 Table I): nothing in the port reads them.
H100 = DeviceSpec(
    name="h100",
    family="nvidia-hopper",
    # the boost clock at which the data sheet quotes its tensor-core
    # rates: 989e12 = 132 SMs x 4 tensor cores x 1024 flop/clock x 1.83 GHz
    clock_mhz=1830.0,
    cu_count=132,            # data sheet: 132 SMs
    simd_per_cu=4,           # white paper: 4 SM sub-partitions ...
    mce_per_simd=1,          # ... each with one tensor core
    max_wf_per_simd=16,      # white paper: 64 resident warps an SM
    wavefront_size=32,       # a warp
    memory=MemoryHierarchy(hbm_bw=3.35e12),  # data sheet: 3.35 TB/s HBM3
    # data sheet: NVLink 900 GB/s over 18 links (both directions)
    interconnect=Interconnect(links=18, link_bw=50e9),
    # white paper: up to 227 KB of shared memory for one block
    vmem_bytes=232448,
    # data sheet: 989 TFLOP/s dense bf16 / fp16 on the tensor cores
    peak_flops=989e12,
)


_REGISTRY: Dict[str, DeviceSpec] = {}


def register_device(spec: DeviceSpec, *, replace: bool = False) -> DeviceSpec:
    """Add ``spec`` to the catalog (idempotent only with ``replace``)."""
    key = spec.name.lower()
    if key in _REGISTRY and not replace:
        raise ValueError(f"device {spec.name!r} is already registered")
    _REGISTRY[key] = spec
    return spec


def get_device(name: str) -> DeviceSpec:
    try:
        return _REGISTRY[name.lower()]
    except KeyError:
        raise UnknownDeviceError(
            f"unknown device {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def list_devices() -> Iterable[str]:
    return sorted(_REGISTRY)


register_device(H100)
