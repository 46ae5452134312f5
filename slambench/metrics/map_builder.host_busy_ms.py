"""map_builder.host_busy_ms: median over the window's keyframes of the
host milliseconds of the program's ``map_builder.update`` span less its
``sync`` spans: the host's own work in the map update (the ray-casts'
enqueues), during which the card can run dry."""

import statistics


def read(run):
    rows = run.counters.get("Spans")
    if not rows:
        return None
    per_kf = {}
    for r in rows:
        if r[0] == "map_builder.update":
            per_kf[r[5]] = per_kf.get(r[5], 0) + r[3] - r[2]
    for r in rows:
        if r[0] != "sync":
            continue
        p = r[4]
        while p >= 0 and rows[p][0] != "map_builder.update":
            p = rows[p][4]
        if p >= 0:
            per_kf[r[5]] -= r[3] - r[2]
    return statistics.median(per_kf.values()) / 1e6 if per_kf else None
