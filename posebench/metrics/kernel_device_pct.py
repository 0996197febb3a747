"""kernel_device_pct: the device time of the port's own kernels (every
`__global__` function of rpe_tpu_torch/csrc, by name) as a share of the
device's busy time in the traced window."""


def read(trace):
    busy = trace.busy_s
    own = sum(trace.own_time().values())
    if busy <= 0 or own <= 0:
        return None
    return 100.0 * own / busy
