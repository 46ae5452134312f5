"""Reading the traced window: the profiler's device trace against the
benchmark's own host ranges.

``torch.profiler`` records, with CUDA activity alone, every kernel,
copy and fill on the card and every CUDA runtime call of every thread,
each launch tied to its kernel by a correlation id. The window is opened
and closed on the host by ``torch.cuda.synchronize()``; the first and
last ``cudaDeviceSynchronize`` calls of the window's thread in the trace
are those two, which ties the profiler's clock to
``time.perf_counter_ns`` (a linear map through both). A kernel belongs
to the range that was open on its launching thread when the launch was
made, so work that a later change moves into another kernel is still
counted for the same range.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _tid(ev) -> Optional[int]:
    try:
        return int(ev.get("tid"))
    except (TypeError, ValueError):
        return None


class TraceSummary:
    """What the per-layer readers read from one traced window."""

    def __init__(self, busy_s: float, window_s: float,
                 device_s: Dict[str, float], kernel_s: Dict[str, float],
                 idle_gaps: List[Tuple[str, float]]):
        self.busy_s = busy_s
        self.window_s = window_s
        self.device_s = device_s        # device seconds per host range
        self.kernel_s = kernel_s        # device seconds per kernel name
        self.idle_gaps = idle_gaps      # (host range, idle seconds)

    def kernel_seconds(self, name: str) -> float:
        """Device seconds of the kernels whose name holds ``name``."""
        return sum(v for k, v in self.kernel_s.items() if name in k)


def _union(intervals):
    total = 0.0
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    for s, e in merged:
        total += e - s
    return total, merged


def summarize(path: str, spans, main_ident: int, marks_ns) -> TraceSummary:
    """Reduce the chrome trace at ``path`` (see module doc).
    ``main_ident``: ``threading.get_ident()`` of the thread that ran the
    window; ``marks_ns``: perf_counter_ns right after the window's first
    and last ``torch.cuda.synchronize()``. The trace names threads its own
    way, so the window's thread is the one whose device synchronisation
    came last, and every other launching thread counts as one: the
    backend's."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    sync_tids = defaultdict(list)
    for ev in events:
        if ev.get("cat") == "cuda_runtime" and \
                ev.get("name") == "cudaDeviceSynchronize":
            sync_tids[_tid(ev)].append(ev["ts"] + ev.get("dur", 0.0))
    if not sync_tids:
        raise RuntimeError("the trace holds no window markers "
                           "(cudaDeviceSynchronize)")
    main_tid = max(sync_tids, key=lambda t: max(sync_tids[t]))
    syncs = sorted(sync_tids[main_tid])
    if len(syncs) < 2:
        raise RuntimeError("the trace holds one window marker only")
    t_start, t_end = syncs[0], syncs[-1]
    # perf_counter ns -> trace us, through the two markers.
    scale = (t_end - t_start) / max(marks_ns[1] - marks_ns[0], 1)

    def to_trace(ns):
        return t_start + (ns - marks_ns[0]) * scale

    def thread(trace_tid) -> str:
        return "main" if trace_tid == main_tid else "backend"

    # One thread's ranges follow one another without overlap.
    by_tid = defaultdict(list)
    for name, ident, t0, t1 in spans.records:
        key = "main" if ident == main_ident else "backend"
        by_tid[key].append((to_trace(t0), to_trace(t1), name))
    starts = {}
    for tid, v in by_tid.items():
        v.sort()
        starts[tid] = [s for s, _, _ in v]

    def open_range(tid, ts) -> Optional[str]:
        i = bisect.bisect_right(starts.get(tid, ()), ts) - 1
        if i >= 0 and ts <= by_tid[tid][i][1]:
            return by_tid[tid][i][2]
        return None

    launches = {}
    for ev in events:
        if ev.get("cat") == "cuda_runtime":
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (thread(_tid(ev)), ev["ts"])

    device_s = defaultdict(float)
    kernel_s = defaultdict(float)
    busy = []
    for ev in events:
        if ev.get("cat") not in DEVICE_CATS:
            continue
        s = ev["ts"]
        e = s + ev.get("dur", 0.0)
        launch = launches.get(ev.get("args", {}).get("correlation"))
        if launch is not None:
            if not (t_start <= launch[1] <= t_end):
                continue
            name = open_range(launch[0], launch[1]) or "other"
        else:
            if not (t_start <= s <= t_end):
                continue
            name = "other"
        dur_s = (e - s) / 1e6
        device_s[name] += dur_s
        if ev.get("cat") == "kernel":
            kernel_s[ev.get("name", "?")] += dur_s
        busy.append((max(s, t_start), min(e, t_end)))
    busy_s, merged = _union([b for b in busy if b[1] > b[0]])
    busy_s /= 1e6

    # Idle gaps, each labelled by the range open on the main thread at
    # its start, else on the backend's, else "other".
    gaps = defaultdict(float)
    edges = [t_start] + [x for iv in merged for x in iv] + [t_end]
    for gs, ge in zip(edges[0::2], edges[1::2]):
        if ge <= gs:
            continue
        label = open_range("main", gs) or open_range("backend", gs)
        gaps[label or "other"] += (ge - gs) / 1e6
    return TraceSummary(busy_s, (t_end - t_start) / 1e6, dict(device_s),
                        dict(kernel_s),
                        sorted(gaps.items(), key=lambda kv: -kv[1]))


def breakdown(summary: TraceSummary) -> dict:
    """The result line's ``breakdown``: the 10 device operations that took
    most time and the idle time by host range, in seconds."""
    ops = sorted(summary.kernel_s.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k[:120], v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in summary.idle_gaps[:10]]}
