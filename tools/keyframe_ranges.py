"""One run of a benchmark cell, as ``slambench/run.py`` makes it, that also
says where in the log its slow keyframes fall and what the backend was
doing meanwhile.

    python3 tools/keyframe_ranges.py --workload aces-bbfront.online \
        --seed <n> --seconds 51 [--first 4400,5500] [--out rows.json]

from the root of a checkout, on a machine with an NVIDIA card. Standard
output ends with the benchmark's result line; standard error ends with a
``keyframes:`` JSON line: the p95 of the keyframe times (the quantity of
``keyframe_p95_ms``, nearest rank) over the whole window, over the
keyframes whose scan lies among the log's first N scans for each N of
``--first`` (to read two runs over the same stretch of the log), per lap
of the route, and split by what the backend's thread was doing on the
host clock while the keyframe ran (a loop detection, a pose-graph solve,
the map rebuild after a closure, or none of them). ``--out`` writes one
row per keyframe: scan index, ms, and the backend work it overlapped.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from slambench import harness, probes, traffic  # noqa: E402

BACKEND_WORK = ("detect", "solve", "rebuild")


def p95(values):
    ms = sorted(values)
    return ms[max(0, math.ceil(0.95 * len(ms)) - 1)] if ms else None


class Book:
    """What the run records beside the harness: the scan index and host
    interval of each keyframe, and the backend's intervals by kind."""

    def __init__(self):
        self.handed = 0
        self.last = None
        self.keyframes = []            # [scan index, ms, t0 ns, t1 ns]
        self.backend = {k: [] for k in BACKEND_WORK}
        self.log_scans = None


BOOK = Book()


class KeyframeTimes(list):
    """``Run.keyframe_ms``: each append also books the keyframe's scan."""

    def append(self, ms):
        super().append(ms)
        BOOK.keyframes.append([BOOK.handed - 1, ms, *BOOK.last])


class Run(harness.Run):
    def __init__(self):
        super().__init__()
        self.keyframe_ms = KeyframeTimes()


def timed(orig, kind=None):
    def call(*args, **kwargs):
        t0 = time.perf_counter_ns()
        try:
            return orig(*args, **kwargs)
        finally:
            t1 = time.perf_counter_ns()
            if kind is None:
                BOOK.handed += 1
                BOOK.last = (t0, t1)
            else:
                BOOK.backend[kind].append((t0, t1))
    return call


def install(slam, spans, capture):
    probes_install(slam, spans, capture)
    slam.process_scan = timed(slam.process_scan)
    slam.backend.detector.detect = timed(slam.backend.detector.detect,
                                         "detect")
    slam.backend._optimize = timed(slam.backend._optimize, "solve")
    slam.after_loop_closure = timed(slam.after_loop_closure, "rebuild")


def make_log(*args):
    text, gt, extra = traffic_make_log(*args)
    BOOK.log_scans = len(gt)
    return text, gt, extra


probes_install, traffic_make_log = probes.install, traffic.make_log


def summary(laps, first):
    rows = []
    for scan, ms, t0, t1 in BOOK.keyframes:
        rows.append({"scan": scan, "ms": ms, "backend": [
            k for k in BACKEND_WORK
            if any(a < t1 and b > t0 for a, b in BOOK.backend[k])]})
    out = {"keyframes": len(rows), "p95_ms": p95([r["ms"] for r in rows]),
           "log_scans": BOOK.log_scans}
    for n in first:
        sel = [r["ms"] for r in rows if r["scan"] < n]
        out[f"first_{n}"] = {"keyframes": len(sel), "p95_ms": p95(sel)}
    lap = BOOK.log_scans / laps
    out["laps"] = [{"keyframes": len(sel), "p95_ms": p95(sel)} for sel in (
        [r["ms"] for r in rows if i * lap <= r["scan"] < (i + 1) * lap]
        for i in range(laps))]
    for kind in BACKEND_WORK + ("none",):
        sel = [r["ms"] for r in rows
               if (kind in r["backend"] if kind != "none"
                   else not r["backend"])]
        out[f"during_{kind}"] = {"keyframes": len(sel), "p95_ms": p95(sel)}
    cut = out["p95_ms"]
    slow = [r for r in rows if cut is not None and r["ms"] >= cut]
    out["slowest_5pct"] = {"keyframes": len(slow), **{
        f"with_{k}": sum(k in r["backend"] for r in slow)
        for k in BACKEND_WORK}}
    return out, rows


def main(argv):
    parser = argparse.ArgumentParser(prog="tools/keyframe_ranges.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--first", default="")
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    first = [int(x) for x in args.first.split(",") if x]
    laps = harness.Cell(args.workload).workload["laps"]
    harness.Run, probes.install, traffic.make_log = Run, install, make_log
    out = harness.run_cell(args.workload, args.seed, args.seconds, False, T0)
    found, rows = summary(laps, first)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f)
    print("keyframes: " + json.dumps(found), file=sys.stderr)
    harness.print_result(out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
