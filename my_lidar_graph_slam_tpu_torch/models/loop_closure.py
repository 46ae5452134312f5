"""Loop-closure candidate search and detection.

Counterpart of ``my_lidar_graph_slam_tpu/models/loop_closure.py:33-129,
209-214,228-283,475-533``.

Search: nearest-node candidate search over the host pose graph
(LoopSearcherNearest, loop_searcher_nearest.cpp:13-108) as one masked
argmin per finished local map.

Detection: :class:`LoopDetectorBranchBound` matches the candidate nodes'
scans against the old finished local map with the exhaustive window sweep
(``ops/matchers_sweep.py``, pixel-accurate score gate), as the JAX package
does on an accelerator (``_detect_mxu_single``), and emits loop edges
``InverseCompound(anchorPose, matchedPose)``
(loop_detector_branch_bound.cpp:76-88). The sweep honors the configured
window exactly. Several candidates per pass (the folded multi-map path),
the branch-and-bound pyramid path and the mesh fan-out are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from my_lidar_graph_slam_tpu_torch.models import map_builder as mb
from my_lidar_graph_slam_tpu_torch.models.pose_graph import PoseGraph
from my_lidar_graph_slam_tpu_torch.ops import matchers, matchers_sweep
from my_lidar_graph_slam_tpu_torch.utils import se2


@dataclasses.dataclass
class LoopCandidate:
    """One candidate (loop_searcher.hpp:61-82): recent node window vs an old
    local map anchored at its nearest node."""

    node_indices: List[int]
    local_map_idx: int
    local_map_node_idx: int


@dataclasses.dataclass
class LoopDetectionResult:
    """Mirror of LoopDetectionResult (loop_detector.hpp:66-100)."""

    relative_pose: np.ndarray    # [3]
    start_node_pose: np.ndarray  # [3] anchor (old map) node pose
    start_node_idx: int
    end_node_idx: int
    covariance: np.ndarray       # [3, 3] world frame


@dataclasses.dataclass
class LoopSearcherNearest:
    """Nearest-node candidate search (loop_searcher_nearest.cpp:13-108).

    ``num_candidate_maps`` = 1 emits the single nearest eligible node, as
    the reference does; K > 1 emits the nearest eligible node of up to K
    distinct finished local maps, ordered by distance (the detector here
    takes one candidate per pass).
    """

    travel_dist_threshold: float = 10.0
    node_dist_max: float = 5.0
    num_candidate_nodes: int = 2
    num_candidate_maps: int = 1

    def search(self, graph: PoseGraph,
               builder: mb.GridMapBuilder) -> List[LoopCandidate]:
        maps = builder.local_maps
        n_nodes = graph.num_nodes
        if not maps or n_nodes == 0 or len(maps) < 2:
            return []

        latest_idx = n_nodes - 1
        robot_pose = graph.poses[latest_idx]
        poses = graph.node_poses()

        # Prefix travel distance per node (loop_searcher_nearest.cpp:53-65).
        seg = np.hypot(*(np.diff(poses[:, :2], axis=0).T))
        travel = np.concatenate([[0.0], np.cumsum(seg)])
        accum = builder.accum_travel_dist

        # Eligible: inside a FINISHED local map, with enough remaining
        # travel distance (recency guard).
        last_finished_max = maps[-2].node_idx_max
        node_ids = np.arange(n_nodes)
        eligible = (node_ids <= last_finished_max) & \
            (accum - travel >= self.travel_dist_threshold)
        if not eligible.any():
            return []

        d2 = ((poses[:, :2] - robot_pose[:2]) ** 2).sum(axis=1)
        d2 = np.where(eligible, d2, np.inf)

        per_map = []
        for m in maps[:-1]:
            lo_n, hi_n = m.node_idx_min, m.node_idx_max
            if hi_n < lo_n:
                continue
            seg_d2 = d2[lo_n:hi_n + 1]
            b = int(np.argmin(seg_d2))
            if seg_d2[b] < self.node_dist_max ** 2:
                per_map.append((float(seg_d2[b]), m.idx, lo_n + b))
        if not per_map:
            return []
        per_map.sort()
        per_map = per_map[:max(1, self.num_candidate_maps)]

        # Candidate window around the latest node, clamped to the latest
        # local map's span (loop_searcher_nearest.cpp:90-102).
        latest_map = maps[-1]
        lo = max(latest_map.node_idx_min,
                 latest_idx - self.num_candidate_nodes)
        hi = min(latest_map.node_idx_max,
                 latest_idx + self.num_candidate_nodes)
        return [LoopCandidate(node_indices=list(range(lo, hi + 1)),
                              local_map_idx=map_idx,
                              local_map_node_idx=best)
                for _, map_idx, best in per_map]


def bucket_batch(n: int) -> int:
    """Power-of-two query count (padding rows are all-invalid scans), so
    the detection shape stays the JAX package's."""
    k = 1
    while k < n:
        k *= 2
    return k


@dataclasses.dataclass
class LoopDetectorBranchBound:
    """BranchBound detection (loop_detector_branch_bound.cpp:26-118) served
    by the exhaustive window sweep.

    The sweep scores EVERY pose of the configured +-range/2 window with the
    pixel-accurate beam gate the BB matcher scores with; BB's coarse
    lattice can round the window up to 2^height blocks, so the two differ
    only when the true optimum lies in that rounding margin.
    ``node_height_max`` and ``frontier_cap`` are kept for config parity.
    """

    score_threshold: float = 0.6
    node_height_max: int = 6
    range_x: float = 2.0
    range_y: float = 2.0
    range_theta: float = 1.0
    scan_range_max: float = 20.0
    usable_range_min: float = 0.01
    usable_range_max: float = 20.0
    frontier_cap: int = 4096
    greedy_params: tuple = ()

    def _window_params(self, res: float):
        win_x = int(np.ceil(0.5 * self.range_x / res))
        win_y = int(np.ceil(0.5 * self.range_y / res))
        win_t = matchers.static_max_theta_window(
            res, self.scan_range_max, self.range_theta)
        return win_x, win_y, win_t

    def detect(self, graph: PoseGraph, builder: mb.GridMapBuilder,
               candidates: List[LoopCandidate]) -> List[LoopDetectionResult]:
        if not candidates:
            return []
        if len(candidates) > 1:
            raise NotImplementedError(
                "detection of several candidates per pass is not ported "
                "yet; use NumOfCandidateMaps = 1")
        return self._detect_single(graph, builder, candidates[0])

    def _detect_single(self, graph: PoseGraph, builder: mb.GridMapBuilder,
                       cand: LoopCandidate) -> List[LoopDetectionResult]:
        """One candidate map, K nodes (padded to a power of two with
        all-invalid rows, which score 0 and are never found)."""
        st = builder.scans
        lm = builder.local_maps[cand.local_map_idx]
        if not lm.finished:
            raise ValueError("loop candidates must lie in finished maps")
        win_x, win_y, win_t = self._window_params(builder.config.resolution)
        anchor_pose = graph.poses[cand.local_map_node_idx]

        nodes = list(cand.node_indices)
        k = bucket_batch(len(nodes))
        nb = st.beam_bucket()
        ids = np.asarray([int(graph.scan_ids[n]) for n in nodes])
        idsp = np.concatenate([ids, np.zeros(k - len(nodes), ids.dtype)])
        poses = np.zeros((k, 3), np.float32)
        poses[:len(nodes)] = graph.poses[nodes]
        valid = st.valid[idsp, :nb].copy()
        valid[len(nodes):] = False

        dev = builder.device

        def up(arr):
            return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)

        summary = matchers_sweep.correlative_match_sweep(
            builder.values_for(lm), lm.grid, up(poses),
            up(st.ranges[idsp, :nb]), up(st.angles[idsp, :nb]), up(valid),
            up(st.min_range[idsp]), up(st.max_range[idsp]),
            up(st.rel_sensor_pose[idsp]),
            self.scan_range_max, self.range_theta, self.usable_range_min,
            self.usable_range_max, self.score_threshold,
            up(np.maximum(st.raw_beams[idsp], 1).astype(np.float32)),
            win_x=win_x, win_y=win_y, win_theta_max=win_t,
            greedy_params=self.greedy_params, score_gate="pixel_accurate")
        packed = matchers_sweep.pack_summary(summary).cpu().numpy()

        results: List[LoopDetectionResult] = []
        for row, node_idx in enumerate(nodes):
            if packed[row, 14] <= 0.5:
                continue  # silent skip (loop_detector_branch_bound.cpp:74)
            matched = packed[row, 0:3].astype(np.float64)
            results.append(LoopDetectionResult(
                relative_pose=se2.inverse_compound_np(anchor_pose, matched),
                start_node_pose=anchor_pose.copy(),
                start_node_idx=cand.local_map_node_idx,
                end_node_idx=node_idx,
                covariance=packed[row, 3:12].reshape(3, 3).astype(
                    np.float64)))
        return results


@dataclasses.dataclass
class LoopDetectorEmpty:
    """No-op detector (loop_detector_empty.cpp:10-19)."""

    def detect(self, graph, builder, candidates):
        return []
