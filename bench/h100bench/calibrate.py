"""Readings of the output check's number on the card, to set its limit.

For each seed, one run of the cell at its own sizes and load (a window
of ``--seconds``), then the program's ``max_logit_gap`` and, for the
seeds given to ``--control``, the control's: the reference computed in
float8 in the program's place (:func:`h100bench.check.control_gaps`).
All seeds run in one process, one after another; each prints a JSON
line and the last line sums them up::

    python3 bench/h100bench/calibrate.py --workload qwen3-moe-8l.chat \\
        --seeds 11,12,13 --control 11,12,13

The limit lies above the largest program reading and below the
smallest control reading (``PERF.md`` gives both and the limit).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path[:0] = [str(Path(__file__).resolve().parent.parent),
                    str(Path(__file__).resolve().parents[2] / "src")]

from h100bench import harness  # noqa: E402
from h100bench.registry import Registry  # noqa: E402

NUMBERS = ("max_logit_gap", "mean_logit_gap", "tokens_compared")


def readings(cell: str, seeds, control, seconds: float, **kw):
    """Yield one record a seed: the program's numbers and, for the seeds
    in ``control``, the control's."""
    import torch
    for seed in seeds:
        t0 = time.perf_counter()
        out = harness.run_cell(cell, seed, seconds, False, t_start=t0,
                               control=seed in control, **kw)
        det = out["_check"]
        rec = {"seed": seed, "correct": out["correct"],
               "program": {k: det[k] for k in NUMBERS},
               "metrics": {k: v["value"] for k, v in out["metrics"].items()}}
        if "_control" in out:
            rec["control"] = {k: out["_control"][k] for k in NUMBERS}
        del out
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        yield rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="")
    ap.add_argument("--seconds", type=float, default=None,
                    help="the window (default: BENCHMARK.json's run_seconds)")
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("calibrate: no CUDA device")
    seconds = a.seconds or Registry().benchmark()["run_seconds"]
    seeds = [int(s) for s in a.seeds.split(",")]
    control = {int(s) for s in a.control.split(",") if s}
    recs = []
    for rec in readings(a.workload, seeds, control, seconds):
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    summary = {"workload": a.workload}
    for k in NUMBERS[:2]:
        prog = [r["program"][k] for r in recs]
        ctl = [r["control"][k] for r in recs if "control" in r]
        summary[k] = {"program_max": max(prog),
                      "control_min": min(ctl) if ctl else None,
                      "program": prog, "control": ctl}
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
