"""The fleet frontier: scenario x device x overlay -> FleetReport rows
(twin of ``repro.fleet.frontier``).

:func:`frontier` runs every requested cell through ONE ``perf.sweep``
call (the deterministic dev -> workload -> engine -> overlay iteration
order lets rows be recovered by positional arithmetic — no re-predicts),
then sizes the fleet per cell with the queueing model:

* ``max_qps`` — largest per-replica request rate meeting the SLO;
* ``replicas`` / ``devices_needed`` — ceil(offered / max_qps), times
  the scenario's tensor-parallel ways;
* ``p99_token_ms`` — latency at the *operating point* (offered load
  spread over the sized fleet), vs the SLO target;
* ``tokens_per_s_device`` — decode tokens per second per device at the
  replica's sustainable rate;
* ``cost_per_mtok`` — the relative-price proxy :data:`DEVICE_COST`
  turned into $/Mtok at sustained rate (prices are *relative* units for
  ranking devices, not a bill).  The table is the reference's: it has
  no ``h100`` entry, so the H100 takes the 1.0 of any unlisted device.

Only the roofline engine prices ``h100``; a frontier with ``h100``
among its devices under the ``mfma`` or ``scoreboard`` engine raises the
perf pipeline's ``ValueError``.

Rows are plain dataclasses; :class:`FleetReport` renders the markdown
table the CLI and ``examples/torch_fleet_planning.py`` print.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

from repro_torch.arch.overlay import IDENTITY, Overlay
from repro_torch.fleet.capacity import (ServeCost, analytic_graphs,
                                        max_sustainable_qps, p99_latency_s,
                                        ttft_s)
from repro_torch.fleet.scenario import TrafficScenario, get_scenario
from repro_torch.perf.pipeline import sweep

__all__ = ["DEVICE_COST", "FleetRow", "FleetReport", "frontier"]

#: Relative hourly price per *device* (dimensionless ranking units —
#: roughly normalised so one mid-range accelerator-hour is 1.0).  Used
#: only to turn tokens/s into a cost-per-token ordering; devices not
#: listed default to 1.0.
DEVICE_COST: Dict[str, float] = {
    "mi200": 1.0,
    "mi300": 1.6,
    "mi300x": 2.0,
    "tpu_v5e": 0.6,
    "tpu_v5p": 2.1,
}


@dataclasses.dataclass(frozen=True)
class FleetRow:
    """One (scenario, device, overlay) cell of the frontier."""

    scenario: str
    device: str
    overlay: str                    # Overlay.describe() label
    engine: str
    feasible: bool                  # can ANY replica count meet the SLO?
    max_qps: float                  # sustainable requests/s per replica
    replicas: int                   # replicas to absorb the offered QPS
    devices_needed: int             # replicas * tp
    p99_token_ms: float             # at the operating point
    slo_p99_ms: float
    ttft_ms: float
    tokens_per_s_device: float      # decode tokens/s per device, sustained
    cost_per_mtok: float            # relative units (DEVICE_COST proxy)
    bound: str                      # decode-graph bottleneck
    decode_tick_ms: float
    prefill_chunk_ms: float

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class FleetReport:
    """All frontier rows of one planning run, renderable as a table."""

    rows: List[FleetRow]

    _COLS = ("scenario", "device", "overlay", "qps/rep", "reps", "devs",
             "p99 ms", "slo", "ttft ms", "tok/s/dev", "$/Mtok", "bound")

    def table(self) -> str:
        """Markdown frontier table, one row per cell."""
        out = ["| " + " | ".join(self._COLS) + " |",
               "|" + "|".join("---" for _ in self._COLS) + "|"]
        for r in self.rows:
            cells = [r.scenario, r.device, r.overlay[:24],
                     f"{r.max_qps:.2f}" if r.feasible else "-",
                     str(r.replicas) if r.feasible else "inf",
                     str(r.devices_needed) if r.feasible else "inf",
                     f"{r.p99_token_ms:.1f}" if r.feasible else "inf",
                     f"{r.slo_p99_ms:g}",
                     f"{r.ttft_ms:.0f}" if r.feasible else "inf",
                     f"{r.tokens_per_s_device:.1f}",
                     f"{r.cost_per_mtok:.2f}" if r.feasible else "inf",
                     r.bound]
            out.append("| " + " | ".join(cells) + " |")
        return "\n".join(out)

    def as_dict(self) -> Dict[str, Any]:
        return {"rows": [r.as_dict() for r in self.rows]}

    def best(self, scenario: str) -> Optional[FleetRow]:
        """Cheapest feasible device for a scenario (None if none is)."""
        cands = [r for r in self.rows
                 if r.scenario == scenario and r.feasible]
        return min(cands, key=lambda r: r.cost_per_mtok) if cands else None


def _row(scn: TrafficScenario, cost: ServeCost, ov: Overlay,
         engine: str) -> FleetRow:
    max_qps = max_sustainable_qps(scn, cost)
    feasible = max_qps > 0 and math.isfinite(max_qps)
    price = DEVICE_COST.get(cost.device, 1.0)
    if feasible:
        replicas = max(1, math.ceil(scn.qps / max_qps))
        op_qps = scn.qps / replicas          # per-replica operating point
        p99_ms = p99_latency_s(op_qps, scn, cost) * 1e3
        ttft_ms = ttft_s(op_qps, scn, cost) * 1e3
        tok_s_dev = max_qps * scn.output_mean / scn.tp
        cost_mtok = price * scn.tp / (max_qps * scn.output_mean * 3600) * 1e6
    else:
        replicas = 0
        p99_ms = ttft_ms = math.inf
        # decode-only ceiling still ranks devices that miss the SLO
        tok_s_dev = cost.peak_tokens_per_s / scn.tp \
            if math.isfinite(cost.peak_tokens_per_s) else 0.0
        cost_mtok = math.inf
    return FleetRow(
        scenario=scn.name, device=cost.device, overlay=ov.describe(),
        engine=engine, feasible=feasible, max_qps=max_qps,
        replicas=replicas, devices_needed=replicas * scn.tp,
        p99_token_ms=p99_ms, slo_p99_ms=scn.slo.p99_token_ms,
        ttft_ms=ttft_ms, tokens_per_s_device=tok_s_dev,
        cost_per_mtok=cost_mtok, bound=cost.decode_bound,
        decode_tick_ms=cost.decode_tick_s * 1e3,
        prefill_chunk_ms=cost.prefill_chunk_s * 1e3)


def frontier(scenarios: Union[str, TrafficScenario,
                              Sequence[Union[str, TrafficScenario]]],
             devices: Sequence[str], *,
             overlays: Iterable[Overlay] = (IDENTITY,),
             engine: str = "roofline") -> FleetReport:
    """Plan every scenario on every device under every overlay.

    All perf predictions run through one ``perf.sweep`` call; its
    iteration order (device -> workload -> engine -> overlay) is
    documented and deterministic, so each cell's decode/prefill Reports
    are recovered by index arithmetic rather than re-prediction.
    """
    if isinstance(scenarios, (str, TrafficScenario)):
        scenarios = [scenarios]
    scns = [get_scenario(s) if isinstance(s, str) else s for s in scenarios]
    devices = list(devices)
    ovs = list(overlays)
    if not scns or not devices or not ovs:
        raise ValueError("frontier needs >= 1 scenario, device and overlay")

    workloads: Dict[str, Any] = {}
    for scn in scns:
        graphs = analytic_graphs(scn)
        workloads[f"{scn.name}/decode"] = graphs["decode"]
        workloads[f"{scn.name}/prefill"] = graphs["prefill"]

    reports = sweep(workloads, devices=devices, engines=[engine],
                    overlays=ovs)
    n_w, n_o = len(workloads), len(ovs)

    def rep(d_i: int, w_i: int, o_i: int):
        return reports[(d_i * n_w + w_i) * n_o + o_i]

    rows: List[FleetRow] = []
    for d_i, dev in enumerate(devices):
        for s_i, scn in enumerate(scns):
            for o_i, ov in enumerate(ovs):
                dec = rep(d_i, 2 * s_i, o_i)
                pre = rep(d_i, 2 * s_i + 1, o_i)
                cost = ServeCost(
                    scenario=scn.name, device=dec.device,
                    decode_tick_s=dec.total_time_s,
                    prefill_chunk_s=pre.total_time_s,
                    decode_bound=dec.bound, prefill_bound=pre.bound,
                    max_batch=scn.max_batch,
                    prefill_chunks_per_request=scn.prefill_chunks_per_request,
                    decode_report=dec, prefill_report=pre)
                rows.append(_row(scn, cost, ov, engine))
    return FleetReport(rows=rows)
