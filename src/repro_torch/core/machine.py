"""Execution-facing machine models — a thin facade over
``repro_torch.arch`` (twin of ``repro.core.machine``).

Device capability data (paper Table I topology, Tables II-V cycle tables,
memory latencies/bandwidths, interconnect, clocks) lives in the declarative
:class:`repro_torch.arch.DeviceSpec` registry; :class:`MachineModel` is the
flat, scoreboard-friendly view of one spec plus the runtime what-if state
(``mfma_scale`` and composed :class:`repro_torch.arch.Overlay` scenarios).
Every field (``cu_count``, ``t_inst``, ``l1d_latency``, ...) is populated
from the spec, and ``get_machine`` accepts any device in the registry.

The H100 is the one registered device with neither a cycle table nor an
MXU: its machine builds (``gpu_table=None``), and ``mfma_cycles``,
``supported_instructions`` and ``matrix_flops_per_cycle`` on it raise
:class:`~repro_torch.core.isa.UnsupportedInstructionError`, as the
reference's machine does for the same spec.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.arch.overlay import Overlay
from repro_torch.arch.registry import get_device, list_devices
from repro_torch.arch.spec import (CANONICAL_DENSE_INSTR, DeviceSpec,
                                   matrix_peak_flops_per_cycle,
                                   scale_cycles)
from repro_torch.core import isa

__all__ = ["MachineModel", "MI200", "MI300", "TPU_V5E", "get_machine",
           "list_machines", "as_machine"]


@dataclasses.dataclass(frozen=True)
class MachineModel:
    name: str
    gpu_table: Optional[str]      # device name with a cycle table; None => analytic only
    clock_mhz: float
    # -- CU topology (paper Section III / Table I) --
    cu_count: int = 60
    simd_per_cu: int = 4
    mce_per_simd: int = 1
    max_wf_per_simd: int = 10
    wavefront_size: int = 64
    # -- issue / probe calibration (paper Section IV-C, from [35]-[37]) --
    t_inst: int = 4               # per-instruction issue overhead, cycles
    t_memtime: int = 40           # s_memtime scalar-counter access, cycles
    # -- memory-system latencies, cycles (paper Table I) --
    l1i_latency: int = 40
    l1d_latency: int = 140
    scalar_latency: int = 41
    lds_latency: int = 65
    l2_latency: int = 269
    mem_latency: int = 483
    valu_latency: int = 1
    # -- the what-if knob (paper Section V-B) --
    mfma_scale: float = 1.0
    # -- TPU-analytic parameters (for the MXU machine) --
    mxu_count: int = 0
    mxu_dim: int = 128
    # -- the backing capability spec (None only for hand-built models) --
    spec: Optional[DeviceSpec] = dataclasses.field(
        default=None, compare=False, repr=False)

    @classmethod
    def from_spec(cls, spec: DeviceSpec, *,
                  mfma_scale: float = 1.0) -> "MachineModel":
        mem = spec.memory
        return cls(
            name=spec.name,
            gpu_table=spec.name if spec.has_cycle_table else None,
            clock_mhz=spec.clock_mhz,
            cu_count=spec.cu_count,
            simd_per_cu=spec.simd_per_cu,
            mce_per_simd=spec.mce_per_simd,
            max_wf_per_simd=spec.max_wf_per_simd,
            wavefront_size=spec.wavefront_size,
            t_inst=spec.t_inst,
            t_memtime=spec.t_memtime,
            l1i_latency=mem.l1i_latency,
            l1d_latency=mem.l1d_latency,
            scalar_latency=mem.scalar_latency,
            lds_latency=mem.lds_latency,
            l2_latency=mem.l2_latency,
            mem_latency=mem.mem_latency,
            valu_latency=mem.valu_latency,
            mfma_scale=mfma_scale,
            mxu_count=spec.mxu_count,
            mxu_dim=spec.mxu_dim,
            spec=spec,
        )

    def with_scale(self, mfma_scale: float) -> "MachineModel":
        return dataclasses.replace(self, mfma_scale=mfma_scale)

    def with_overlay(self, overlay: Overlay) -> "MachineModel":
        """Apply a what-if scenario; returns a new machine.

        ``overlay.mfma_scale`` composes into the machine's ``mfma_scale``
        knob (lookup-time scaling, the paper's semantics); the remaining
        knobs (clock/memory-latency/bandwidth scaling, table patches) are
        baked into a transformed spec.
        """
        spec_part = dataclasses.replace(overlay, mfma_scale=1.0)
        if self.spec is None:
            if not spec_part.is_identity:
                raise ValueError(
                    f"{self.name} has no backing DeviceSpec: only the "
                    "mfma_scale overlay knob can apply to a hand-built "
                    "MachineModel")
            return self.with_scale(self.mfma_scale * overlay.mfma_scale)
        new_spec = self.spec if spec_part.is_identity \
            else spec_part.apply(self.spec)

        # Transform THIS machine's fields (not a rebuild from the spec), so
        # replace()-style tweaks the caller made survive the overlay.
        def _mem(v: int) -> int:
            return scale_cycles(v, overlay.mem_latency_scale)

        return dataclasses.replace(
            self,
            spec=new_spec,
            clock_mhz=self.clock_mhz * overlay.clock_scale,
            l1i_latency=_mem(self.l1i_latency),
            l1d_latency=_mem(self.l1d_latency),
            scalar_latency=_mem(self.scalar_latency),
            lds_latency=_mem(self.lds_latency),
            l2_latency=_mem(self.l2_latency),
            mem_latency=_mem(self.mem_latency),
            mfma_scale=self.mfma_scale * overlay.mfma_scale)

    @property
    def mce_per_cu(self) -> int:
        return self.simd_per_cu * self.mce_per_simd

    @property
    def has_mfma_table(self) -> bool:
        if self.spec is not None:
            return self.spec.has_cycle_table
        return self.gpu_table is not None

    def mfma_cycles(self, instr_name: str) -> int:
        if self.spec is not None and self.spec.has_cycle_table:
            return self.spec.mfma_cycles(instr_name,
                                         mfma_scale=self.mfma_scale)
        if self.gpu_table is None:
            raise isa.UnsupportedInstructionError(
                f"{self.name} has no MFMA cycle table; use the analytic MXU path")
        return isa.mfma_cycles(self.gpu_table, instr_name,
                               mfma_scale=self.mfma_scale)

    def supported_instructions(self, *, validated_only: bool = False
                               ) -> Sequence[str]:
        """Timing-model-supported instruction names on this machine."""
        if self.spec is not None and self.spec.has_cycle_table:
            return self.spec.supported_instructions(
                validated_only=validated_only)
        if self.gpu_table is None:
            raise isa.UnsupportedInstructionError(
                f"{self.name} has no MFMA cycle table; use the analytic MXU path")
        return isa.supported_instructions(self.gpu_table,
                                          validated_only=validated_only)

    def supports(self, instr_name: str) -> bool:
        try:
            self.mfma_cycles(instr_name)
            return True
        except isa.UnsupportedInstructionError:
            return False

    # --- analytic peaks (used by the HLO bridge / roofline) -------------
    @property
    def matrix_flops_per_cycle(self) -> float:
        """Peak matrix-unit FLOPs per cycle for the whole chip.

        One formula home
        (`repro_torch.arch.spec.matrix_peak_flops_per_cycle`),
        fed this machine's own fields so replace()-tweaked topology and
        the active mfma_scale are honoured.
        """
        cyc = None if self.mxu_count else self.mfma_cycles(
            CANONICAL_DENSE_INSTR)
        return matrix_peak_flops_per_cycle(
            mxu_count=self.mxu_count, mxu_dim=self.mxu_dim,
            cu_count=self.cu_count, mce_per_cu=self.mce_per_cu,
            canonical_cycles=cyc)

    @property
    def peak_matrix_tflops(self) -> float:
        return self.matrix_flops_per_cycle * self.clock_mhz * 1e6 / 1e12


MI200 = MachineModel.from_spec(get_device("mi200"))
MI300 = MachineModel.from_spec(get_device("mi300"))
TPU_V5E = MachineModel.from_spec(get_device("tpu_v5e"))


def get_machine(name: str, *, mfma_scale: float = 1.0,
                overlay: Optional[Overlay] = None) -> MachineModel:
    """Machine model for any device in the ``repro_torch.arch`` registry."""
    m = MachineModel.from_spec(get_device(name), mfma_scale=mfma_scale)
    return m.with_overlay(overlay) if overlay is not None else m


def list_machines() -> Sequence[str]:
    return list(list_devices())


def as_machine(obj) -> MachineModel:
    """Coerce a MachineModel, DeviceSpec, or device name to a machine —
    lets the scoreboard and bridge take any of the three."""
    if isinstance(obj, MachineModel):
        return obj
    if isinstance(obj, DeviceSpec):
        return MachineModel.from_spec(obj)
    return get_machine(obj)
