"""frontend.host_busy_ms: median over the window's keyframes of the host
milliseconds of the program's ``frontend.match`` and ``frontend.resolve``
spans less their ``sync`` spans: the host's own work in the match (its
enqueues and arithmetic), during which the card can run dry."""

import statistics

LAYER = ("frontend.match", "frontend.resolve")


def read(run):
    rows = run.counters.get("Spans")
    if not rows:
        return None
    per_kf = {}
    for r in rows:
        if r[0] in LAYER:
            per_kf[r[5]] = per_kf.get(r[5], 0) + r[3] - r[2]
    for r in rows:
        if r[0] != "sync":
            continue
        p = r[4]
        while p >= 0 and rows[p][0] not in LAYER:
            p = rows[p][4]
        if p >= 0:
            per_kf[r[5]] -= r[3] - r[2]
    return statistics.median(per_kf.values()) / 1e6 if per_kf else None
