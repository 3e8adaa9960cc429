"""Fleet capacity planning with the port (twin of
``examples/fleet_planning.py``): the paper's "how do MCE optimizations
impact future systems" question answered at serving-fleet granularity.

Plans every built-in traffic scenario (``chat``, ``long_context``,
``bursty_batch``) on the reference's five catalog devices and the H100,
prints the frontier table (devices needed, p99 vs SLO, tokens/s/device,
relative cost per Mtok), then asks the what-if the overlay machinery
exists for: what does a 2x-faster (and a 2x-slower) matrix-core engine
buy the chat fleet on mi300, and on the H100?

Only the roofline engine prices the H100 (it has no MFMA cycle table):
with ``--engine mfma`` or ``--engine scoreboard`` the H100 is left out,
and the script says so.  Pure host code: no model runs, no card needed.

    PYTHONPATH=src python examples/torch_fleet_planning.py
    PYTHONPATH=src python examples/torch_fleet_planning.py --engine mfma
    PYTHONPATH=src python examples/torch_fleet_planning.py --scenario chat \\
        --slo-p99-ms 100
"""

import argparse
import dataclasses
from typing import List, Optional

from repro_torch.arch.overlay import IDENTITY, overlay_grid
from repro_torch.fleet import frontier, get_scenario, list_scenarios

DEVICES = ("mi200", "mi300", "mi300x", "tpu_v5e", "tpu_v5p", "h100")
WHAT_IF_DEVICES = ("mi300", "h100")
#: the one device the MFMA-table engines cannot price
ROOFLINE_ONLY = ("h100",)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default=None,
                    help=f"one of {list_scenarios()} (default: all)")
    ap.add_argument("--slo-p99-ms", type=float, default=None)
    ap.add_argument("--engine", default="roofline")
    args = ap.parse_args(argv)

    names = [args.scenario] if args.scenario else list_scenarios()
    scns = []
    for n in names:
        scn = get_scenario(n)
        if args.slo_p99_ms is not None:
            scn = dataclasses.replace(scn, slo=scn.slo.with_p99(
                args.slo_p99_ms))
        scns.append(scn)

    devices = DEVICES
    if args.engine != "roofline":
        devices = tuple(d for d in DEVICES if d not in ROOFLINE_ONLY)
        print(f"note: the {args.engine} engine prices a device from its "
              f"MFMA cycle table; {', '.join(ROOFLINE_ONLY)} has none, so "
              "it is left out (only the roofline prices it)\n")

    print("== Fleet frontier: every scenario on every catalog device ==\n")
    for scn in scns:
        print(f"  {scn.describe()}")
    print()
    rep = frontier(scns, devices, engine=args.engine)
    print(rep.table())
    for scn in scns:
        best = rep.best(scn.name)
        if best:
            print(f"\n{scn.name}: serve on {best.devices_needed}x "
                  f"{best.device} — {best.tokens_per_s_device:.0f} "
                  f"tok/s/device at p99 {best.p99_token_ms:.0f}ms "
                  f"(SLO {best.slo_p99_ms:g}ms), "
                  f"{best.cost_per_mtok:.2f} $/Mtok relative")
        else:
            print(f"\n{scn.name}: no catalog device meets the SLO")

    ovs = [IDENTITY] + overlay_grid(mfma_scale=(0.5, 2.0))
    for dev in WHAT_IF_DEVICES:
        if dev not in devices:
            continue
        print(f"\n== What-if: matrix-core engine scaling on the chat fleet "
              f"({dev}) ==\n")
        what_if = frontier("chat", (dev,), overlays=ovs, engine=args.engine)
        print(what_if.table())
        base, faster, slower = what_if.rows
        print(f"\nOn {dev} a 2x-faster MCE (mfma x0.5) moves chat capacity "
              f"{base.max_qps:.2f} -> {faster.max_qps:.2f} qps/device; a "
              f"2x-slower one drops it to {slower.max_qps:.2f}.  Decode "
              f"stays {base.bound}-bound, so the lever is the prefill side.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
