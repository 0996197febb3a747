"""launches_per_pair: device events (kernels, copies, memsets) of the traced
calls over the pairs they returned. A count, not a time."""


def read(trace):
    if trace.pairs <= 0 or not trace.device:
        return None
    return len(trace.device) / trace.pairs
