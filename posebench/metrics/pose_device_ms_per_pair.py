"""pose_device_ms_per_pair: summed durations of the device events the stage
launched, clipped to the traced window, over the traced pairs: the time the
card was busy on the stage. The stage is the program's span rpe.pose,
`recover_pose`, the audits, the zero-motion gate and the final selection
(posebench/stages.py). None without the program's spans."""

import stages


def read(trace):
    return stages.per_pair(trace, "pose", "device_s", 1e3)
