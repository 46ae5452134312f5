"""keyframe_p95_ms: the 95th percentile (nearest rank) over every keyframe
of the window of the host time from handing its scan to ``process_scan``
until the call returns True with the pose on the host."""

import math


def read(run):
    ms = sorted(run.keyframe_ms)
    if not ms:
        return None
    return ms[max(0, math.ceil(0.95 * len(ms)) - 1)]
