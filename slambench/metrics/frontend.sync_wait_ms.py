"""frontend.sync_wait_ms: median over the window's keyframes of the host
milliseconds spent in the program's ``sync`` spans (``utils/device.py``:
uploads, host reads, event waits) under its ``frontend.match`` and
``frontend.resolve`` spans: the frontend's waits on the device."""

import statistics

LAYER = ("frontend.match", "frontend.resolve")


def read(run):
    rows = run.counters.get("Spans")
    if not rows:
        return None
    per_kf = {r[5]: 0 for r in rows if r[0] in LAYER}
    for r in rows:
        if r[0] != "sync":
            continue
        p = r[4]
        while p >= 0 and rows[p][0] not in LAYER:
            p = rows[p][4]
        if p >= 0:
            per_kf[r[5]] += r[3] - r[2]
    return statistics.median(per_kf.values()) / 1e6 if per_kf else None
