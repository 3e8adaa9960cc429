"""``moe_gmm``'s bound over its device time in the traced slice: each
call's bound is the larger of its assigned rows' operations at the
bf16 peak and its bytes (the weights of each expert that took a row,
the assigned rows in and out) at the HBM rate."""


def read(run):
    counts = run.registry.counts("moe_gmm")
    calls = [g for g in run.gmm if g[5]]
    if not calls or run.device_trace is None:
        return None
    bound = 0.0
    for E, R, K, N, ri, _ in calls:
        rows = run.router_rows[ri]
        bound += run.peaks.bound_s(counts.flops(K, N, rows),
                                   counts.nbytes(K, N, rows))
    t = run.device_trace.kernel_s(counts.KERNELS)
    return 100.0 * bound / t if t > 0 else None
