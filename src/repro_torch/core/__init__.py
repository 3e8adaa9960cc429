"""The paper's contribution: MCE/MFMA functional + timing models (twin of
``repro.core``).

Device capability data (cycle tables, topology, memory, interconnect,
clocks) lives in the declarative :mod:`repro_torch.arch` registry; this
package holds the execution models that consume it.  The timing modules
are pure Python: they import neither torch nor jax.

Public surface:
  isa            — MFMA instruction registry (+ cycle-table views)
  machine        — MachineModel facade over repro_torch.arch.DeviceSpec
  program        — instruction-stream IR
  scoreboard     — event-driven CU/SIMD/MCE simulator (NRDY_MATRIX_CORE)
  microbench     — Listing-1 streams + Eq. 1 extraction (Tables II-V)
  whatif         — --mfma-scale / overlay-grid analysis (Table VI)
  functional     — D = C + A@B oracle semantics (PyTorch)
  hlo_bridge     — compiled-HLO -> MFMA accounting (a deprecated shim over
                   repro_torch.perf)
  hlo_analysis   — loop-aware HLO statistics (a deprecated shim over
                   repro_torch.perf.hlo_ir)
"""

from repro_torch.core import (isa, machine, program, scoreboard,  # noqa: F401
                              microbench)
from repro_torch.core.machine import (MI200, MI300, TPU_V5E,  # noqa: F401
                                      as_machine, get_machine, list_machines)
