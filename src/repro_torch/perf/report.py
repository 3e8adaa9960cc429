"""The one result schema every cost engine emits (twin of
``repro.perf.report``).

A :class:`Report` answers the same questions regardless of which engine
produced it — "how long, bound by what, doing what per op" — so sweeps can
mix engines, devices and overlay scenarios in one table, and a new engine
plugs into every consumer (roofline CLI, what-if grids, benchmarks) by
returning this schema.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence

__all__ = ["OpCost", "Report", "format_reports"]

#: The bottleneck vocabulary shared by all engines.
BOUNDS = ("compute", "memory", "collective", "matrix")


@dataclasses.dataclass(frozen=True)
class OpCost:
    """Cost of one kernel-graph op under the engine's model."""

    label: str                 # e.g. "dot[1x256x256x512]bf16", "all-reduce"
    kind: str                  # "dot" | "collective" | "memory"
    time_s: float              # op time at its own bound, executed count incl.
    count: float = 1.0
    flops: float = 0.0
    bytes: float = 0.0
    detail: str = ""           # engine-specific (instr name, group size, ...)


@dataclasses.dataclass(frozen=True)
class Report:
    """Per-(workload x device x scenario) cost estimate, any engine."""

    engine: str                # "roofline" | "mfma" | "scoreboard" | custom
    device: str
    scenario: str = "baseline"           # Overlay.describe() label
    workload: str = ""                   # caller-supplied name (sweeps)
    total_time_s: float = 0.0            # end-to-end bound-implied time
    compute_time_s: float = 0.0
    memory_time_s: float = 0.0
    collective_time_s: float = 0.0
    bound: str = "compute"               # dominant term, from BOUNDS
    utilization: float = 0.0             # achieved/peak at the bottleneck
    per_op: Sequence[OpCost] = ()
    #: The dominant dot's TilePlan (``TilePlan.as_dict()``): the tiles the
    #: mfma_gemm kernel would execute for this workload on this device —
    #: lets predicted and executed tilings be cross-checked.
    plan: Optional[Dict[str, Any]] = None
    metrics: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def top_ops(self, n: int = 5) -> List[OpCost]:
        return sorted(self.per_op, key=lambda o: -o.time_s)[:n]

    def plan_summary(self) -> str:
        """Compact "bm x bn x bk"-style rendering of the plan column."""
        if not self.plan:
            return "-"
        blocks = [str(v) for k, v in self.plan.items()
                  if k.startswith("block_") or k == "chunk"]
        return "x".join(blocks) if blocks else "-"

    def as_dict(self) -> Dict[str, Any]:
        """JSON-able record (benchmark artifacts, CI trajectories)."""
        d = dataclasses.asdict(self)
        d["per_op"] = [dataclasses.asdict(o) for o in self.top_ops(10)]
        d["metrics"] = {k: v for k, v in self.metrics.items()
                        if isinstance(v, (int, float, str))}
        return d

    def breakdown(self) -> str:
        """Human-readable per-op latency breakdown."""
        hdr = (f"{self.engine} on {self.device} [{self.scenario}]: "
               f"{_us(self.total_time_s)} ({self.bound}-bound, "
               f"util={self.utilization:.2f})")
        lines = [hdr]
        for o in self.top_ops(8):
            lines.append(f"  {o.label:42s} {_us(o.time_s):>12s}  {o.detail}")
        return "\n".join(lines)


def _us(t: float) -> str:
    if math.isinf(t):
        return "inf"
    return f"{t * 1e6:.1f}us"


def format_reports(reports: Sequence[Report]) -> str:
    """One row per report: the sweep-comparison table."""
    hdr = (f"| {'workload':20s} | {'device':10s} | {'engine':10s} "
           f"| {'scenario':24s} | {'total':>10s} | {'bound':10s} | util "
           f"| {'plan':14s} |")
    sep = "|" + "-" * 22 + "|" + "-" * 12 + "|" + "-" * 12 + "|" + "-" * 26 \
        + "|" + "-" * 12 + "|" + "-" * 12 + "|------|" + "-" * 16 + "|"
    out = [hdr, sep]
    for r in reports:
        out.append(
            f"| {r.workload[:20]:20s} | {r.device[:10]:10s} "
            f"| {r.engine[:10]:10s} | {r.scenario[:24]:24s} "
            f"| {_us(r.total_time_s):>10s} | {r.bound:10s} "
            f"| {r.utilization:4.2f} | {r.plan_summary()[:14]:14s} |")
    return "\n".join(out)
