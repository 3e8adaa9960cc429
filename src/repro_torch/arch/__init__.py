"""The port's device-capability layer (twin of ``repro.arch``).

One declarative :class:`DeviceSpec` per accelerator carries what the
timing model, the roofline bounds and the what-if sweeps need: compute
topology, MFMA cycle tables with validation provenance, memory latencies
and bandwidths, the interconnect, clocks and advertised peaks.

  spec      — the DeviceSpec schema (+ MemoryHierarchy / Interconnect)
  registry  — the catalog (h100, mi200, mi300, mi300x, tpu_v5e, tpu_v5p)
  overlay   — composable what-if scenario transforms + sweep grids
  select    — instruction-selection policy (best MFMA per dtype)

Consumers: :mod:`repro_torch.core.machine` (the execution facade),
:mod:`repro_torch.core.isa` (instruction registry; cycle-table views),
:mod:`repro_torch.core.whatif` (overlay sweeps) and ``chip_smoke.py``'s
roofline bounds (the H100's peak and HBM rate).
"""

from repro_torch.arch.overlay import IDENTITY, Overlay, overlay_grid  # noqa: F401
from repro_torch.arch.registry import (UnknownDeviceError,  # noqa: F401
                                       get_device, list_devices,
                                       register_device)
from repro_torch.arch.select import (HLO_DTYPE_TO_IN, best_mfma,  # noqa: F401
                                     best_mfma_for_hlo, throughput_ranking)
from repro_torch.arch.spec import (CycleEntry, DeviceSpec,  # noqa: F401
                                   Interconnect, MemoryHierarchy)

__all__ = [
    "CycleEntry", "DeviceSpec", "Interconnect", "MemoryHierarchy",
    "Overlay", "IDENTITY", "overlay_grid",
    "UnknownDeviceError", "get_device", "list_devices", "register_device",
    "HLO_DTYPE_TO_IN", "best_mfma", "best_mfma_for_hlo",
    "throughput_ranking",
]
