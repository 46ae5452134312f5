"""The check against its control and against faults planted in the timed
path, on the CPU at a tiny size: each must come out not correct.

The control is the reference put in the program's place one precision
lower (bfloat16 maps, scores and costs; a float32 solve). The faults are
those a SLAM cell can have: a step that returns its state unchanged (the
local map left as it was by a map update), half of the batch left out
(every other beam of every integrated scan dropped), and an answer
altered where it is produced (each frontend match moved by one cell; each
scan integrated one cell off the pose the pose graph gives it, and that
pose recorded). The exchange between chips does not exist on one chip.
"""

import time

import numpy as np
import pytest

from slambench import check, harness
from slambench.tests.test_slambench_harness import TINY

CELL = "aces-bbfront.online"


def _run(**kw):
    return harness.run_cell(CELL, 4242, 2.0, False, time.time(),
                            rehearsal=TINY, **kw)


def test_control_comes_out_not_correct():
    out = _run(control=True)
    assert out["correct"] is True
    limits = harness.Cell(CELL).workload["limits"]
    ok, lines = check.verdict(out["control"], limits)
    assert not ok, lines


def _stale_local_map(monkeypatch):
    from my_lidar_graph_slam_tpu_torch.models import map_builder as mb
    orig = mb.GridMapBuilder._frontend_update

    def stale(self, graph):
        lm = self.local_maps[-1]
        grid = lm.grid
        orig(self, graph)
        lm.grid = grid

    monkeypatch.setattr(mb.GridMapBuilder, "_frontend_update", stale)


def _half_the_beams(monkeypatch):
    from my_lidar_graph_slam_tpu_torch.ops import raycast
    orig = raycast.integrate_scans_stacked

    def half(log_odds, observed, origins, resolution, node_poses,
             scan_ranges, scan_angles, scan_valid, *args, **kwargs):
        valid = scan_valid.clone()
        valid[..., 1::2] = False
        return orig(log_odds, observed, origins, resolution, node_poses,
                    scan_ranges, scan_angles, valid, *args, **kwargs)

    monkeypatch.setattr(raycast, "integrate_scans_stacked", half)


def _moved_match(monkeypatch):
    from my_lidar_graph_slam_tpu_torch.models import scan_matchers
    orig = scan_matchers.AsyncMatcher.resolve_async

    def moved(self, pending, initial_pose):
        s = orig(self, pending, initial_pose)
        pose = np.array(s.estimated_pose, copy=True)
        pose[0] += 0.05
        return s._replace(estimated_pose=pose)

    monkeypatch.setattr(scan_matchers.AsyncMatcher, "resolve_async", moved)


def _integrated_off_its_pose(monkeypatch):
    from my_lidar_graph_slam_tpu_torch.models import map_builder as mb
    orig = mb.GridMapBuilder._frontend_update

    def off(self, graph):
        node = graph.num_nodes - 1
        true = graph.poses[node].copy()
        graph.poses[node, 0] += 0.05
        orig(self, graph)
        lm = self.local_maps[-1]
        lm.built_poses = lm.built_poses.copy()
        graph.poses[node] = true

    monkeypatch.setattr(mb.GridMapBuilder, "_frontend_update", off)


@pytest.mark.parametrize("fault", [_stale_local_map, _half_the_beams,
                                   _moved_match, _integrated_off_its_pose],
                         ids=["state_unchanged", "half_the_batch",
                              "answer_altered", "map_off_its_pose"])
def test_fault_comes_out_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out = _run()
    assert out["correct"] is False, out["checks"]
