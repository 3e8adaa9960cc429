"""Graceful-degradation demo with the PyTorch port (twin of
``examples/serve_resilience.py``): the paged serve engine under offered
load it cannot carry, and under injected allocator faults.

Three acts:

1. **Overload, naive**: a burst trace with deadlines on an unbounded
   FIFO queue: the queue grows, deadlines blow, most of the late work
   times out after burning decode steps on it.
2. **Overload, degraded gracefully**: same trace, same engine size, but
   with a ``max_queue`` bound and a deadline-aware admission policy:
   doomed work is shed *before* it costs anything and the surviving
   requests finish inside their deadlines.
3. **Fault injection**: a deterministic :class:`FaultPlan` seizes the
   whole block pool mid-run, forces a preemption and stalls; the engine
   preempts, requeues and recomputes, with its invariants checked every
   tick.  A recomputed request runs its prompt and the tokens it had
   emitted through prefill where the fault-free run took decode steps,
   so its stream is held to the fault-free run's by the near-tie rule
   (``repro_torch.serve.parity``): equal, or first different at a step
   where float32 (the plain path in float32, teacher-forced along the
   common prefix) picks the recomputed token or lies within tau of it.
   The report prints each divergence's verdict.

    PYTHONPATH=src python examples/torch_serve_resilience.py
    PYTHONPATH=src python examples/torch_serve_resilience.py --seed 3
    PYTHONPATH=src python examples/torch_serve_resilience.py --device cpu

The device defaults to ``cuda`` and the run raises without one; the
model runs the kernel path (``paged_decode_attention`` for the decode
ticks, ``flash_attention`` for the prefill chunks; on the CPU their
plain versions).
"""

import argparse
from collections import Counter
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.serve import (OK, DeadlineAwareShed, Fault, FaultPlan,
                               PagedServeEngine, Request, get_trace)
from repro_torch.serve.parity import describe, divergences


def show(title, results, stats):
    by_status = Counter(r.status for r in results)
    line = ", ".join(f"{k}={v}" for k, v in sorted(by_status.items()))
    print(f"  {title}: {line}")
    print(f"    ticks={stats.ticks} decode_steps={stats.decode_steps} "
          f"tokens={stats.tokens} preemptions={stats.preemptions} "
          f"stalled_ticks={stats.stalled_ticks}")
    ok = [r for r in results if r.status == OK]
    if ok:
        waits = [r.admitted - r.arrival for r in ok]
        print(f"    served {len(ok)} requests, "
              f"worst admission wait {max(waits)} ticks")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--requests", type=int, default=14)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)

    # --- acts 1 + 2: a burst trace with deadlines, on a 2-slot engine --
    trace = get_trace("overload")(args.requests, cfg.vocab_size,
                                  seed=args.seed, deadline_frac=0.9)
    n_dl = sum(1 for r in trace if r.deadline is not None)
    print(f"overload trace: {args.requests} requests in bursts, "
          f"{n_dl} carry deadlines")

    def engine(**kw):
        return PagedServeEngine(cfg, params, max_len=160, max_batch=2,
                                page=128, prefix_cache=False, device=dev,
                                **kw)

    print("\n[1] unbounded FIFO queue (no shedding):")
    show("naive", *engine().run(trace))

    print("\n[2] max_queue=4 + DeadlineAwareShed(slack=2):")
    results, stats = engine(max_queue=4,
                            admission=DeadlineAwareShed(slack=2)).run(trace)
    show("graceful", results, stats)
    shed = next((r for r in results if r.status == "SHED"), None)
    if shed is not None:
        print(f"    e.g. shed detail: {shed.detail!r}")

    # --- act 3: seize the pool, force a preemption, hold the streams ---
    rng = np.random.default_rng(args.seed)
    small = [Request(prompt=rng.integers(0, cfg.vocab_size, (8,))
                     .astype(np.int32), n_steps=12, arrival=a)
             for a in (0, 0, 1)]
    plan = FaultPlan(seed=args.seed, faults=[
        Fault(kind="exhaust", tick=2, n=8, duration=2),
        Fault(kind="preempt", tick=6, n=1),
        Fault(kind="stall", tick=9, duration=2),
    ])
    print("\n[3] fault injection (pool seizure + forced preemption + "
          "stall), invariants checked every tick:")
    quiet = engine()
    base, _ = quiet.run(small)
    chaos_eng = engine(check_invariants=True)
    chaos, cstats = chaos_eng.run(small, fault_plan=plan, max_ticks=2000)
    show("chaos", chaos, cstats)
    ok = [i for i, r in enumerate(chaos) if r.status == OK]
    divs = divergences(quiet, [small[i] for i in ok], [base[i] for i in ok],
                       [chaos[i] for i in ok], engine=chaos_eng)
    for d in divs:
        d = dict(d, request=ok[d["request"]])
        print("    " + describe(d, "recomputed and fault-free streams"))
    held = all(d["accepted"] for d in divs)
    print(f"    recomputed tokens vs fault-free run: "
          f"{len(ok) - len(divs)}/{len(ok)} streams equal; float32-"
          f"arbitrated near-tie rule: {'held' if held else 'BROKEN'}")
    print(f"    pool fully reclaimed: "
          f"{chaos_eng.cache.free_blocks == chaos_eng.cache.capacity}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
