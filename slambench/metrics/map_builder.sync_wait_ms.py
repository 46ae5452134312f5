"""map_builder.sync_wait_ms: median over the window's keyframes of the
host milliseconds spent in the program's ``sync`` spans (uploads of the
scans, poses and map origins) under its ``map_builder.update`` span."""

import statistics


def read(run):
    rows = run.counters.get("Spans")
    if not rows:
        return None
    per_kf = {r[5]: 0 for r in rows if r[0] == "map_builder.update"}
    for r in rows:
        if r[0] != "sync":
            continue
        p = r[4]
        while p >= 0 and rows[p][0] != "map_builder.update":
            p = rows[p][4]
        if p >= 0:
            per_kf[r[5]] += r[3] - r[2]
    return statistics.median(per_kf.values()) / 1e6 if per_kf else None
