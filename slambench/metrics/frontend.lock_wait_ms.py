"""frontend.lock_wait_ms: the host milliseconds of the program's
``lock_wait`` spans (asking for the SLAM's lock to holding it) inside its
``keyframe`` spans and outside a ``backend.pass``, summed over the window
and divided by its keyframes: a mean, since most keyframes wait 0."""


def read(run):
    rows = run.counters.get("Spans")
    if not rows:
        return None
    keyframes = sum(1 for r in rows if r[0] == "keyframe")
    if not keyframes:
        return None
    total = 0
    for r in rows:
        if r[0] != "lock_wait":
            continue
        p = r[4]
        while p >= 0 and rows[p][0] not in ("keyframe", "backend.pass"):
            p = rows[p][4]
        if p >= 0 and rows[p][0] == "keyframe":
            total += r[3] - r[2]
    return total / 1e6 / keyframes
