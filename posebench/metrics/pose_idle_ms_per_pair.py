"""pose_idle_ms_per_pair: the idle gaps of the traced window's device timeline
(the union `device_idle_pct` reads) that an event the stage launched ended,
over the traced pairs: the time the card waited on the stage's host path.
The stage is the program's span rpe.pose, `recover_pose`, the audits, the
zero-motion gate and the final selection (posebench/stages.py). None without
the program's spans."""

import stages


def read(trace):
    return stages.per_pair(trace, "pose", "idle_s", 1e3)
