"""backend.detect_ms: median over the window's detection passes of the
host milliseconds of the program's ``backend.detect`` span (the loop
detector's call, which ends in the host read of its packed result)."""

import statistics


def read(run):
    rows = run.counters.get("Spans")
    if not rows:
        return None
    ms = [(r[3] - r[2]) / 1e6 for r in rows if r[0] == "backend.detect"]
    return statistics.median(ms) if ms else None
