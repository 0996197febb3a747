"""kernel_roofline_pct: over the port's own kernels that have a count
(posebench/roofline.py), the sum of their bounds -- max(bytes / HBM
bandwidth, operations / peak) of the traced calls' work -- over the sum of
their device time. None where no counted kernel ran."""

import roofline


def read(trace):
    own = trace.own_time()
    bound = device = 0.0
    for unit, (nbytes, ops, rate) in trace.counts.items():
        t = sum(own.get(k, 0.0) for k in roofline.UNITS[unit])
        if t > 0:
            bound += roofline.bound_s(nbytes, ops, rate)
            device += t
    if device <= 0:
        return None
    return 100.0 * bound / device
