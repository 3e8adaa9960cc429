"""``paged_decode_attention``'s bound over its device time in the
traced slice: per call (one a layer a decode step) the larger of its
operations at the bf16 peak and its bytes (each slot's cached rows, K
and V, its query and output rows, the block table) at the HBM rate."""


def read(run):
    counts = run.registry.counts("paged_decode_attention")
    steps = [s for s in run.decodes if s.profiled]
    if not steps or run.device_trace is None:
        return None
    d, eng = run.d, run.workload["engine"]
    table = eng["max_batch"] * -(-eng["max_len"] // eng["page"])
    bound = 0.0
    for s in steps:
        kv = [int(n) + 1 for n in s.lens]
        bound += d["L"] * run.peaks.bound_s(
            counts.flops(d["H"], d["hd"], kv),
            counts.nbytes(d["H"], d["KV"], d["hd"], kv, table))
    t = run.device_trace.kernel_s(counts.KERNELS)
    return 100.0 * bound / t if t > 0 else None
