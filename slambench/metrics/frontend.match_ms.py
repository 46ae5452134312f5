"""frontend.match_ms: median host milliseconds of the ``frontend.match``
range (``match_async`` to the end of ``resolve_async``, which ends in the
packed host read) per keyframe of the traced window."""

import statistics


def read(run):
    ms = run.spans.durations_ms("frontend.match")
    return statistics.median(ms) if ms else None
