"""The roofline of the window's synchronised decode steps over their
wall time: each step's bound is the larger of its useful operations
(ACTIVE rows) at the bf16 peak and its bytes (every weight once, MoE
experts that took a row, each live cached row read and new row
written) at the HBM rate."""

import numpy as np


def read(run):
    counts = run.registry.counts("model")
    steps = [s for s in run.decodes if s.in_window and s.wall is not None]
    if not steps:
        return None
    bound = 0.0
    for s in steps:
        lens = [int(n) for n in s.lens if n > 0]
        hits = None
        if run.d["moe"]:
            hits = [int(np.count_nonzero(run.router_rows[i]))
                    for i in s.routers]
        bound += run.peaks.bound_s(counts.decode_flops(run.d, lens),
                                   counts.decode_bytes(run.d, lens, hits))
    return 100.0 * bound / sum(s.wall for s in steps)
