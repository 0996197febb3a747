"""device_idle_pct: the share of the traced window (whole estimator calls,
host clock of the profiler) in which no kernel, copy or memset ran on the
card, from the device events' union."""


def read(trace):
    if trace.window_s <= 0 or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
