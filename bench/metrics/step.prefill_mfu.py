"""The useful operations of the window's synchronised prefill calls
(each chunk's valid rows, not its padding, attending their true
context) over the calls' wall time at the chip's bf16 peak."""


def read(run):
    counts = run.registry.counts("model")
    steps = [s for s in run.prefills if s.in_window and s.wall is not None]
    if not steps:
        return None
    flops = sum(counts.prefill_flops(run.d, s.pos, s.nv) for s in steps)
    wall = sum(s.wall for s in steps)
    return 100.0 * flops / (wall * run.peaks.BF16_FLOPS)
