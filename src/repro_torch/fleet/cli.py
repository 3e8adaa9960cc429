"""``python -m repro_torch.fleet`` — the capacity-planner command line
(twin of ``repro.fleet.cli``: the same flags, defaults and output).

Examples::

    python -m repro_torch.fleet --scenario chat --devices mi300x,h100
    python -m repro_torch.fleet --scenario chat --devices mi300 \\
        --slo-p99-ms 100 --qps 50
    python -m repro_torch.fleet --devices mi300x --overlay mfma_scale=2 --json

``--overlay`` takes ``knob=value`` pairs (``mfma_scale``,
``clock_scale``, ``mem_latency_scale``, ``bw_scale``) and always plans
the identity baseline alongside, so the what-if is a visible delta.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import List, Optional

from repro_torch.arch.overlay import IDENTITY, Overlay
from repro_torch.fleet.frontier import frontier
from repro_torch.fleet.scenario import get_scenario, list_scenarios

_OVERLAY_KNOBS = ("mfma_scale", "clock_scale", "mem_latency_scale",
                  "bw_scale")


def parse_overlay(spec: str) -> Overlay:
    """'mfma_scale=2,bw_scale=1.5' -> Overlay(...)."""
    kw = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"overlay knob {part!r} is not knob=value")
        k, v = part.split("=", 1)
        k = k.strip()
        if k not in _OVERLAY_KNOBS:
            raise ValueError(f"unknown overlay knob {k!r}; "
                             f"choose from {_OVERLAY_KNOBS}")
        kw[k] = float(v)
    return Overlay(**kw)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.fleet",
        description="Fleet capacity planning over the perf engines")
    p.add_argument("--scenario", default=None,
                   help="comma-separated scenario names "
                        f"(registered: {','.join(list_scenarios())}; "
                        "default: all)")
    p.add_argument("--devices", default="mi300,mi300x,tpu_v5p",
                   help="comma-separated repro_torch.arch device names")
    p.add_argument("--slo-p99-ms", type=float, default=None,
                   help="override every scenario's p99 token-latency SLO")
    p.add_argument("--qps", type=float, default=None,
                   help="override every scenario's offered fleet QPS")
    p.add_argument("--overlay", default=None,
                   help="what-if overlay, e.g. mfma_scale=2,bw_scale=1.5 "
                        "(planned alongside the identity baseline)")
    p.add_argument("--engine", default="roofline",
                   help="perf cost engine (default: roofline; only the "
                        "roofline prices h100)")
    p.add_argument("--json", action="store_true",
                   help="emit rows as JSON instead of the table")
    p.add_argument("--small", action="store_true",
                   help="CI smoke: chat scenario only, first two devices")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    names = (args.scenario.split(",") if args.scenario
             else list_scenarios())
    devices = [d.strip() for d in args.devices.split(",") if d.strip()]
    if args.small:
        names = names[:1]
        devices = devices[:2]

    scns = []
    for name in names:
        scn = get_scenario(name.strip())
        if args.qps is not None:
            scn = dataclasses.replace(scn, qps=args.qps)
        if args.slo_p99_ms is not None:
            scn = dataclasses.replace(
                scn, slo=scn.slo.with_p99(args.slo_p99_ms))
        scns.append(scn)

    overlays = [IDENTITY]
    if args.overlay:
        overlays.append(parse_overlay(args.overlay))

    report = frontier(scns, devices, overlays=overlays, engine=args.engine)

    if args.json:
        print(json.dumps(report.as_dict(), indent=2, sort_keys=True))
        return 0

    for scn in scns:
        print(f"# {scn.describe()}")
    print()
    print(report.table())
    for scn in scns:
        best = report.best(scn.name)
        if best is None:
            print(f"\n{scn.name}: NO device meets the SLO "
                  f"(p99 <= {scn.slo.p99_token_ms:g} ms) — relax the SLO "
                  "or shrink max_batch")
        else:
            print(f"\n{scn.name}: cheapest feasible device is "
                  f"{best.device} [{best.overlay}] — "
                  f"{best.devices_needed} device(s), "
                  f"{best.cost_per_mtok:.2f} $/Mtok (relative)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
