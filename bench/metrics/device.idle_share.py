"""The share of the traced slice in which no kernel, copy or set ran on
the device."""


def read(run):
    t = run.device_trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (t.window_s - t.busy_s) / t.window_s
