"""detect_launches_per_pair: device events (kernels, copies, memsets) that the
stage's host path launched in the traced calls, over their pairs: the
stage's work as a count. The stage is the program's span rpe.detect,
`detect_features` (posebench/stages.py). None without the program's spans."""

import stages


def read(trace):
    return stages.per_pair(trace, "detect", "launches")
