"""The cell's scheduler replayed in ticks on the CPU, with no model.

The paged engine's scheduler decides in ticks alone: which request is
admitted, prefilled or decoded at a tick depends on the trace and the
engine's sizes, never on the model's tokens or on wall time.  So the
occupancy a mix's tick arrival rate gives can be worked out here, by
running the program's own :class:`PagedServeEngine` scheduler with its
two model steps replaced by stubs.  That is how each mix's
``rate_per_tick`` was chosen (about 90% of the slots ACTIVE over the
window's ticks), and the CPU tests hold it there::

    python3 bench/h100bench/replay.py --workload qwen3-moe-8l.chat --seed 1
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path
from typing import List, Optional

import numpy as np

if __package__ in (None, ""):
    sys.path[:0] = [str(Path(__file__).resolve().parent.parent),
                    str(Path(__file__).resolve().parents[2] / "src")]

from h100bench import traffic  # noqa: E402
from h100bench.registry import Registry  # noqa: E402


def _stub_config(vocab: int):
    """A one-layer config whose pools stay small at any ``n_blocks``."""
    from repro_torch.models.config import ModelConfig
    return ModelConfig(name="replay-stub", family="dense", n_layers=1,
                       d_model=16, n_heads=1, n_kv_heads=1, d_ff=16,
                       vocab_size=vocab, head_dim=16, dtype="float32")


@dataclasses.dataclass
class Replay:
    active: List[int]           # ACTIVE slots at each decode step
    start: Optional[int]        # index of the window's first decode step
    max_batch: int

    def occupancy(self, ticks: int) -> float:
        """Mean ACTIVE share over the window's first ``ticks`` decode
        steps."""
        if self.start is None:
            raise RuntimeError("the slots never filled: no window")
        seg = self.active[self.start:self.start + ticks]
        return float(np.mean(seg)) / self.max_batch


def replay(workload: dict, mix: dict, seed: int, ticks: int) -> Replay:
    """Run ``workload``'s scheduler over ``mix`` from ``seed`` until
    ``ticks`` decode steps past the window's start."""
    import torch
    from repro_torch.serve import PagedServeEngine

    eng_args = dict(workload["engine"])
    vocab = 512
    cfg = _stub_config(vocab)
    params = {"embed": torch.zeros((vocab, 16))}
    horizon = 4 * ticks + 200
    trace = traffic.generate(mix, seed, vocab, horizon)
    reqs = traffic.to_requests(trace, cancel_at=horizon)
    eng = PagedServeEngine(cfg, params, device="cpu", **eng_args)
    B = eng.max_batch
    rec = Replay(active=[], start=None, max_batch=B)
    start_step = workload["start_step"]
    logits_1 = torch.zeros((vocab,))
    logits_b = torch.zeros((B, vocab))

    def prefill(tokens, table, pos, nv):
        return logits_1

    def decode(pend, tables, lens):
        n = int(np.count_nonzero(lens))
        rec.active.append(n)
        if rec.start is None and len(rec.active) > start_step:
            rec.start = start_step
        if rec.start is not None and \
                len(rec.active) - rec.start >= ticks:
            for r in reqs:
                r.cancel_at = 0
        return logits_b

    eng.prefill, eng.decode = prefill, decode
    eng.run(reqs)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--ticks", type=int, default=None,
                    help="window length in ticks (default: the mix's "
                         "replay_ticks)")
    ap.add_argument("--rate", type=float, default=None,
                    help="try this rate_per_tick instead of the mix's")
    a = ap.parse_args(argv)
    reg = Registry()
    wl = reg.workload(a.workload)
    mix = reg.traffic(wl["traffic"])
    if a.rate is not None:
        mix["rate_per_tick"] = a.rate
    ticks = a.ticks or mix["replay_ticks"]
    rec = replay(wl, mix, a.seed, ticks)
    print(f"{a.workload} seed {a.seed} rate {mix['rate_per_tick']}: "
          f"window starts at decode step {rec.start}, ACTIVE share over "
          f"{ticks} ticks {rec.occupancy(ticks):.4f}")


if __name__ == "__main__":
    main()
