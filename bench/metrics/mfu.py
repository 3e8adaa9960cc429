"""The whole serving step's share of the chip's bf16 peak in the traced
slice: the useful operations of every engine step the slice ran
(prefill chunks' valid rows, decode steps' ACTIVE rows, attention at
their true context) over the slice's length at 989 TFLOP/s."""


def read(run):
    t = run.device_trace
    if t is None or t.window_s <= 0:
        return None
    counts = run.registry.counts("model")
    flops = sum(counts.prefill_flops(run.d, s.pos, s.nv)
                for s in run.prefills if s.profiled)
    flops += sum(counts.decode_flops(run.d, [int(n) for n in s.lens if n > 0])
                 for s in run.decodes if s.profiled)
    return 100.0 * flops / (t.window_s * run.peaks.BF16_FLOPS)
