"""match_device_ms_per_pair: summed durations of the device events the stage
launched, clipped to the traced window, over the traced pairs: the time the
card was busy on the stage. The stage is the program's span rpe.match,
`match_features` and the gathers of matched points (posebench/stages.py).
None without the program's spans."""

import stages


def read(trace):
    return stages.per_pair(trace, "match", "device_s", 1e3)
