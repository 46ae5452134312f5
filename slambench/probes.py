"""The benchmark's own ranges around the calls into each layer of the
program, and the capture of the window's answers for the check.

:func:`install` wraps, on one SLAM object, the calls that enter a layer:

* ``frontend.match``: the frontend matcher's ``match_async`` up to the
  end of its ``resolve_async`` (which ends in the packed host read);
* ``map_update``: ``LidarGraphSlam.update_grid_map`` and
  ``LidarGraphSlam.after_loop_closure``;
* ``backend.detect``: the loop detector's ``detect``;
* ``backend.solve``: ``Backend._optimize``;

records, inside the map builder's own calls (``append_scan`` and
``after_loop_closure``, both under the SLAM's lock), the pose graph's pose
of each node whose scan the builder integrates and the poses each latest
map is built from, for the check; and, for the traced run,
stands in for the two hand-written kernels' wrappers
(``ops/cuda/correlate.window_scores``, K1, and
``ops/cuda/greedy_cost.greedy_cost_core``, K2) to keep the arguments of
each call, as ``chip_smoke.py``'s ``Recorder`` (commit 8e18ecb) does.
Ranges are host intervals on the calling thread's id, kept in memory;
the trace reader attributes device work to them.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Tuple

class Spans:
    """Host intervals ``(name, thread id, start ns, end ns)`` on
    ``time.perf_counter_ns``, recorded while ``active``; the thread id is
    ``threading.get_ident()``, the thread's pthread id."""

    def __init__(self):
        self.active = False
        self.records: List[Tuple[str, int, int, int]] = []
        self._lock = threading.Lock()

    def begin(self, name: str):
        if not self.active:
            return None
        return (name, threading.get_ident(), time.perf_counter_ns())

    def end(self, token):
        if token is None:
            return
        t1 = time.perf_counter_ns()
        with self._lock:
            self.records.append((token[0], token[1], token[2], t1))

    def durations_ms(self, name: str) -> List[float]:
        return [(t1 - t0) / 1e6 for n, _, t0, t1 in self.records
                if n == name]


class MapShape:
    """What the roofline arithmetic needs of a call's map: its shape and
    device (keeping the map itself would hold every keyframe's map)."""

    def __init__(self, tensor):
        self.shape = tuple(tensor.shape)
        self.device = tensor.device


class KernelCalls:
    """Stands in for a kernel wrapper: keeps each call's arguments, the map
    by its shape, while ``spans.active``."""

    def __init__(self, module, name: str, spans: Spans):
        self.module, self.name, self.spans = module, name, spans
        self.fn = getattr(module, name)
        self.calls: List[tuple] = []
        setattr(module, name, self)

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, value):
        self.fn.launches = value

    def __call__(self, *args, **kwargs):
        if self.spans.active:
            self.calls.append(((MapShape(args[0]),) + tuple(args[1:]),
                               kwargs))
        return self.fn(*args, **kwargs)

    def restore(self):
        setattr(self.module, self.name, self.fn)


def _around(obj, attr: str, wrapper):
    """Replace the bound method ``obj.attr`` by ``wrapper(original, ...)``
    on this object only."""
    original = getattr(obj, attr)

    def call(*args, **kwargs):
        return wrapper(original, *args, **kwargs)

    setattr(obj, attr, call)


def install(slam, spans: Spans, capture) -> None:
    """Wrap the layer entries of ``slam`` (see module doc)."""
    matcher = slam.frontend.matcher
    pending = {}

    def match_async(orig, grid, store, scan_id, initial_pose):
        pending["token"] = spans.begin("frontend.match")
        capture.match_started(grid, initial_pose)
        return orig(grid, store, scan_id, initial_pose)

    def resolve_async(orig, pend, initial_pose):
        summary = orig(pend, initial_pose)
        spans.end(pending.pop("token", None))
        capture.match_resolved(summary)
        return summary

    def ranged(name):
        def wrapper(orig, *args, **kwargs):
            token = spans.begin(name)
            try:
                return orig(*args, **kwargs)
            finally:
                spans.end(token)
        return wrapper

    def detect(orig, graph, builder, candidates):
        token = spans.begin("backend.detect")
        try:
            results = orig(graph, builder, candidates)
        finally:
            spans.end(token)
        capture.detect_called(graph, builder, candidates, results)
        return results

    def optimize(orig, snapshot):
        token = spans.begin("backend.solve")
        try:
            res = orig(snapshot)
        finally:
            spans.end(token)
        capture.solve_called(snapshot, res.poses)
        return res

    def append_scan(orig, graph):
        created = orig(graph)
        node = graph.num_nodes - 1
        capture.integrated[node] = graph.poses[node].copy()
        capture.latest_built(slam.builder, graph)
        return created

    def rebuilt(orig, graph):
        before = {id(lm): lm.grid for lm in slam.builder.local_maps}
        orig(graph)
        for lm in slam.builder.local_maps:
            if lm.grid is not before.get(id(lm)):
                for n in range(lm.node_idx_min, lm.node_idx_max + 1):
                    capture.integrated[n] = graph.poses[n].copy()
        capture.latest_built(slam.builder, graph)

    _around(slam.builder, "append_scan", append_scan)
    _around(slam.builder, "after_loop_closure", rebuilt)
    _around(matcher, "match_async", match_async)
    _around(matcher, "resolve_async", resolve_async)
    _around(slam, "update_grid_map", ranged("map_update"))
    _around(slam, "after_loop_closure", ranged("map_update"))
    _around(slam.backend.detector, "detect", detect)
    _around(slam.backend, "_optimize", optimize)


def record_kernels(spans: Spans) -> Dict[str, KernelCalls]:
    """Stand in for K1's and K2's wrappers; ``restore`` each after."""
    from my_lidar_graph_slam_tpu_torch.ops.cuda import correlate, greedy_cost
    return {"window_scores": KernelCalls(correlate, "window_scores", spans),
            "greedy_cost": KernelCalls(greedy_cost, "greedy_cost_core",
                                       spans)}
