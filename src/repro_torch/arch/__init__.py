"""The port's device-capability layer (twin of ``repro.arch``): the
:class:`DeviceSpec` schema and a catalog holding the H100.

The reference's what-if overlays and instruction-selection policy come
with the perf front-end (ROADMAP queue 1).
"""

from repro_torch.arch.registry import (UnknownDeviceError,  # noqa: F401
                                       get_device, list_devices,
                                       register_device)
from repro_torch.arch.spec import (CycleEntry, DeviceSpec,  # noqa: F401
                                   Interconnect, MemoryHierarchy)

__all__ = [
    "CycleEntry", "DeviceSpec", "Interconnect", "MemoryHierarchy",
    "UnknownDeviceError", "get_device", "list_devices", "register_device",
]
