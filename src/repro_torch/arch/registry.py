"""The port's device catalog (twin of ``repro.arch.registry``): one
:class:`DeviceSpec` per device.

It registers the reference's five devices, copied as they are (``mi200``,
``mi300`` and ``tpu_v5e`` spelled out, ``mi300x`` and ``tpu_v5p`` as
deltas through :meth:`DeviceSpec.derive`), and the ``h100`` the port
runs on, from NVIDIA's published figures.  The MI200/MI300 cycle tables
are the paper's Tables II-V in the ``{name: (cycles, validated)}`` form;
:mod:`repro_torch.core.isa` re-exports them as views.

The H100's MFMA cycle table is empty: its keys would have to be
``MFMA_REGISTRY`` instructions, which are AMD's, and a non-empty table
would switch its peak arithmetic to ``CANONICAL_DENSE_INSTR``, which it
lacks.  Its peak comes from ``peak_flops`` (989 TFLOP/s bf16); every
roofline bound that ``chip_smoke.py`` prints reads the HBM rate and that
peak from here.  The tensor-core latencies the Listing-1 probe
(``kernels/listing1.py``) measures on the card are printed and recorded,
not tabled.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

from repro_torch.arch.spec import (CycleEntry, DeviceSpec, Interconnect,
                                   MemoryHierarchy, UnknownDeviceError)

__all__ = [
    "MI200_CYCLES",
    "MI300_CYCLES",
    "H100",
    "MI200",
    "MI300",
    "MI300X",
    "TPU_V5E",
    "TPU_V5P",
    "register_device",
    "get_device",
    "list_devices",
    "UnknownDeviceError",
]


# ---------------------------------------------------------------------------
# MFMA timing tables: {instr: (cycles, validated)}.
# Keys absent from a table mean "not supported on that GPU".
# Paper-validated entries (Tables II-V "Expected" column) are listed first.
# ---------------------------------------------------------------------------

MI200_CYCLES: Dict[str, Tuple[int, bool]] = {
    "fp64_16x16x4fp64": (32, True),
    "fp32_4x4x1fp32": (8, True),
    "fp32_16x16x4fp32": (32, True),
    "fp32_16x16x16fp16": (32, True),
    "i32_16x16x16i8": (32, True),
    "fp64_4x4x4fp64": (16, True),
    "fp32_4x4x4fp16": (8, True),
    # ISA-manual-pattern latency classes (same class as shape-mates):
    "fp32_32x32x2fp32": (64, False),
    "fp32_32x32x4bf16": (64, False),
    "fp32_16x16x8bf16": (32, False),
}

MI300_CYCLES: Dict[str, Tuple[int, bool]] = {
    "fp64_16x16x4fp64": (32, True),
    "fp32_4x4x1fp32": (8, True),
    "fp32_16x16x4fp32": (32, True),
    # MI300 improved this latency vs MI200 (32 -> 16), Table IV:
    "fp32_16x16x16fp16": (16, True),
    "fp64_4x4x4fp64": (16, True),
    "fp32_4x4x4fp16": (8, True),
    # i32_16x16x16i8: REMOVED on MI300 (paper Section III-A).
    # New on MI300: 2-block bf16 variant, same cycles as MI200 1-block:
    "f32_32x32x4_2b_bf16": (64, False),
    "fp32_16x16x16bf16": (16, False),
    "i32_16x16x32i8": (16, False),
    "i32_32x32x16i8": (32, False),
    "fp32_16x16x32fp8": (16, False),
}


def _table(raw: Dict[str, Tuple[int, bool]]) -> Dict[str, CycleEntry]:
    return {k: CycleEntry(cycles, validated)
            for k, (cycles, validated) in raw.items()}


# ---------------------------------------------------------------------------
# Base devices
# ---------------------------------------------------------------------------

MI200 = DeviceSpec(
    name="mi200",
    family="amd-cdna2",
    clock_mhz=1801.0,
    # CU topology + memory latencies are the paper's Table I defaults.
    memory=MemoryHierarchy(hbm_bw=1638e9),          # MI210: 1.6 TB/s HBM2e
    interconnect=Interconnect(links=3, link_bw=50e9),
    cycle_table=_table(MI200_CYCLES),
    vmem_bytes=8 << 20,      # 8 MiB L2 as the tile-staging budget
)

MI300 = DeviceSpec(
    name="mi300",
    family="amd-cdna3",
    clock_mhz=1801.0,
    memory=MemoryHierarchy(hbm_bw=5300e9),          # HBM3: 5.3 TB/s
    interconnect=Interconnect(links=7, link_bw=64e9),
    cycle_table=_table(MI300_CYCLES),
    vmem_bytes=32 << 20,     # per-XCD L2 + Infinity Cache staging slice
)

# TPU v5e: 197 bf16 TFLOP/s/chip = 2 * mxu_count * 128^2 * clock.
# 8 MXUs @ ~750 MHz reproduces the public peak within 0.2%; peak_flops
# pins the advertised figure the roofline uses.
TPU_V5E = DeviceSpec(
    name="tpu_v5e",
    family="google-tpu",
    clock_mhz=750.0,
    cu_count=1, simd_per_cu=1, mce_per_simd=8,
    mxu_count=8, mxu_dim=128,
    memory=MemoryHierarchy(hbm_bw=819e9),
    # a bidirectional-ring collective on one torus dimension drives 2 ICI
    # links (~50 GB/s each) concurrently; a 2D-torus all-reduce can stripe
    # further — we stay conservative.
    interconnect=Interconnect(links=2, link_bw=50e9),
    peak_flops=197e12,
    vmem_bytes=16 << 20,     # ~16 MiB VMEM per core feeds the MXUs
)

# ---------------------------------------------------------------------------
# Derived devices (deltas of the bases)
# ---------------------------------------------------------------------------

# MI300X-class part: full 304-CU CDNA3 at boost clock.  The timing table is
# inherited from mi300 but has NOT been re-measured on this silicon, so
# every entry is demoted to validated=False (provenance stays honest).
MI300X = MI300.derive(
    "mi300x",
    revalidate=False,
    cu_count=304,
    clock_mhz=2100.0,
    # memory + interconnect inherited from the mi300 base
)

# TPU v5p: 459 bf16 TFLOP/s => 8 MXUs @ ~1.75 GHz; 2765 GB/s HBM and
# ~100 GB/s ICI links.
TPU_V5P = TPU_V5E.derive(
    "tpu_v5p",
    clock_mhz=1750.0,
    hbm_bw=2765e9,
    links=2, link_bw=100e9,
    peak_flops=459e12,
)

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


for _spec in (H100, MI200, MI300, MI300X, TPU_V5E, TPU_V5P):
    register_device(_spec)
