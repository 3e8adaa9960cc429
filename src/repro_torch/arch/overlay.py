"""Composable what-if overlays over :class:`DeviceSpec` (twin of
``repro.arch.overlay``).

The paper's single ``--mfma-scale`` float (Section V-B) generalises to a
declarative scenario transform: scale the MFMA timing table, the clock,
memory latencies or bandwidths, or patch individual table entries — and
compose several of those into one scenario.  Sweeps become overlay *grids*
(the cartesian product of per-knob value lists), so "MFMA 2x faster AND
HBM 1.5x slower" is one grid cell, not a bespoke code path.

Scaled/patched table entries are marked ``validated=False``: a what-if
scenario is by definition not hardware-measured.

The mfma-scale rounding (``max(1, round(cycles * scale))``) matches the
gem5 patch exactly, so overlay results are bit-identical to the legacy
``MachineModel.with_scale`` path.  The rounding is
:func:`repro_torch.arch.spec.scale_cycles`, the one home of the rule.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterable, List, Mapping

from repro_torch.arch.spec import CycleEntry, DeviceSpec, scale_cycles

__all__ = ["Overlay", "IDENTITY", "overlay_grid"]


@dataclasses.dataclass(frozen=True)
class Overlay:
    """One what-if scenario, expressed as multiplicative deltas + patches."""

    mfma_scale: float = 1.0        # the paper's --mfma-scale knob
    clock_scale: float = 1.0
    mem_latency_scale: float = 1.0
    bw_scale: float = 1.0          # HBM + link bandwidths
    table_patches: Mapping[str, int] = dataclasses.field(
        default_factory=dict)    # instr -> absolute cycles (pre-scale)
    label: str = ""

    @property
    def is_identity(self) -> bool:
        return (self.mfma_scale == 1.0 and self.clock_scale == 1.0
                and self.mem_latency_scale == 1.0 and self.bw_scale == 1.0
                and not self.table_patches)

    def describe(self) -> str:
        if self.label:
            return self.label
        parts = []
        if self.mfma_scale != 1.0:
            parts.append(f"mfma x{self.mfma_scale:g}")
        if self.clock_scale != 1.0:
            parts.append(f"clock x{self.clock_scale:g}")
        if self.mem_latency_scale != 1.0:
            parts.append(f"memlat x{self.mem_latency_scale:g}")
        if self.bw_scale != 1.0:
            parts.append(f"bw x{self.bw_scale:g}")
        for k, v in self.table_patches.items():
            parts.append(f"{k}={v}cy")
        return ", ".join(parts) or "baseline"

    def compose(self, other: "Overlay") -> "Overlay":
        """Apply ``other`` on top of this overlay (scales multiply;
        ``other``'s table patches win on conflict)."""
        patches: Dict[str, int] = dict(self.table_patches)
        patches.update(other.table_patches)
        label = ", ".join(x for x in (self.label, other.label) if x)
        return Overlay(
            mfma_scale=self.mfma_scale * other.mfma_scale,
            clock_scale=self.clock_scale * other.clock_scale,
            mem_latency_scale=self.mem_latency_scale * other.mem_latency_scale,
            bw_scale=self.bw_scale * other.bw_scale,
            table_patches=patches,
            label=label,
        )

    def apply(self, spec: DeviceSpec) -> DeviceSpec:
        """The spec this scenario describes.

        Note for MXU (table-less) devices the ``mfma_scale`` knob has no
        table to scale — ``MachineModel.with_overlay`` threads it into the
        analytic pass-cycle path instead.
        """
        if self.is_identity:
            return spec
        table: Dict[str, CycleEntry] = {}
        for name, entry in spec.cycle_table.items():
            base = self.table_patches.get(name, entry.cycles)
            cycles = scale_cycles(base, self.mfma_scale)
            touched = (cycles != entry.cycles or name in self.table_patches)
            table[name] = CycleEntry(
                cycles, validated=entry.validated and not touched)
        # patches for instructions the device lacks ADD support for them
        # (hypothesised-new-instruction what-ifs), mirroring derive()
        for name, base in self.table_patches.items():
            if name not in table:
                table[name] = CycleEntry(
                    scale_cycles(base, self.mfma_scale), validated=False)
        memory = spec.memory.scaled(self.mem_latency_scale)
        if self.bw_scale != 1.0:
            memory = dataclasses.replace(
                memory,
                hbm_bw=memory.hbm_bw * self.bw_scale,
                l2_bw=memory.l2_bw * self.bw_scale,
                lds_bw=memory.lds_bw * self.bw_scale)
        interconnect = spec.interconnect
        if self.bw_scale != 1.0:
            interconnect = dataclasses.replace(
                interconnect, link_bw=interconnect.link_bw * self.bw_scale)
        return dataclasses.replace(
            spec,
            name=f"{spec.name}+{self.describe()}",
            clock_mhz=spec.clock_mhz * self.clock_scale,
            memory=memory,
            interconnect=interconnect,
            cycle_table=table,
            # an advertised peak no longer holds under a scenario
            peak_flops=spec.peak_flops * self.clock_scale / self.mfma_scale,
        )


IDENTITY = Overlay()


def overlay_grid(**axes: Iterable[float]) -> List[Overlay]:
    """Cartesian sweep grid over overlay knobs.

    >>> overlay_grid(mfma_scale=(0.5, 1, 2), clock_scale=(1, 1.2))
    [Overlay(mfma_scale=0.5, clock_scale=1), ...]   # 6 scenarios

    Axis names must be scalar :class:`Overlay` fields
    (``table_patches`` grids are built by hand).
    """
    valid = {f.name for f in dataclasses.fields(Overlay)} - {
        "table_patches", "label"}
    for k in axes:
        if k not in valid:
            raise TypeError(f"unknown overlay axis {k!r}; valid: "
                            f"{sorted(valid)}")
    names = list(axes)
    grid = []
    for values in itertools.product(*(axes[n] for n in names)):
        grid.append(Overlay(**dict(zip(names, map(float, values)))))
    return grid
