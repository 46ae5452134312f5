"""Loop-closure candidate search and detection.

Counterpart of ``my_lidar_graph_slam_tpu/models/loop_closure.py:33-214,
228-283,362-533,608-766``.

Search: nearest-node candidate search over the host pose graph
(LoopSearcherNearest, loop_searcher_nearest.cpp:13-108) as one masked
argmin per finished local map; ``search_window`` lets any node of a replay
chunk trigger a candidate.

Detection: :class:`LoopDetectorBranchBound` matches the candidate nodes'
scans against the old finished local map with the exhaustive window sweep
(``ops/matchers_sweep.py``, pixel-accurate score gate), as the JAX package
does on an accelerator (``_detect_mxu_single``), and emits loop edges
``InverseCompound(anchorPose, matchedPose)``
(loop_detector_branch_bound.cpp:76-88). The sweep honors the configured
window exactly. Several candidates per pass run as ONE folded sweep over
their stacked maps (``_detect_mxu`` of the JAX package).
:class:`LoopDetectorGridSearch` runs the exhaustive lattice search of
``ops/matchers.py`` for all nodes of a candidate at once.
:class:`LoopDetectorCorrelative` runs the two-stage coarse-to-fine search
of ``ops/correlative_coarse.py``, one batch per candidate map. With a
mesh, the BranchBound detector runs branch-and-bound instead, its
candidate rows fanned out over the mesh's shards
(``parallel/distributed.py``), as the JAX package does.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from my_lidar_graph_slam_tpu_torch.models import map_builder as mb
from my_lidar_graph_slam_tpu_torch.models.pose_graph import PoseGraph
from my_lidar_graph_slam_tpu_torch.ops import correlative_coarse
from my_lidar_graph_slam_tpu_torch.ops import matchers, matchers_sweep
from my_lidar_graph_slam_tpu_torch.utils import device as device_mod
from my_lidar_graph_slam_tpu_torch.utils import se2
from my_lidar_graph_slam_tpu_torch.utils.metrics import MetricManager


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
    distinct finished local maps, ordered by distance (the detector
    matches them all in one folded sweep).
    """

    travel_dist_threshold: float = 10.0
    node_dist_max: float = 5.0
    num_candidate_nodes: int = 2
    num_candidate_maps: int = 1

    def _eligible(self, graph: PoseGraph, builder: mb.GridMapBuilder):
        """bool[N] of the nodes a candidate may anchor on: inside a
        FINISHED local map, with enough travel since (the recency guard;
        prefix travel per node as loop_searcher_nearest.cpp:53-65). None
        when no node is eligible or fewer than two local maps exist."""
        maps = builder.local_maps
        n_nodes = graph.num_nodes
        if n_nodes == 0 or len(maps) < 2:
            return None
        poses = graph.node_poses()
        seg = np.hypot(*(np.diff(poses[:, :2], axis=0).T))
        travel = np.concatenate([[0.0], np.cumsum(seg)])
        eligible = (np.arange(n_nodes) <= maps[-2].node_idx_max) & \
            (builder.accum_travel_dist - travel >= self.travel_dist_threshold)
        return eligible if eligible.any() else None

    def search(self, graph: PoseGraph,
               builder: mb.GridMapBuilder) -> List[LoopCandidate]:
        eligible = self._eligible(graph, builder)
        if eligible is None:
            return []
        maps = builder.local_maps
        latest_idx = graph.num_nodes - 1
        robot_pose = graph.poses[latest_idx]
        poses = graph.node_poses()

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

    def search_window(self, graph: PoseGraph, builder: mb.GridMapBuilder,
                      window_nodes) -> List[LoopCandidate]:
        """Replay-mode candidate search: any of ``window_nodes`` (the
        nodes appended since the last backend pass) may trigger a
        candidate, not just the latest node.

        Replay coalesces several online passes into one chunk boundary, so
        the robot can pass within ``node_dist_max`` of an old map
        mid-chunk and be gone again by the boundary. Per finished map this
        takes the closest (window node, map node) pair and anchors the
        candidate window around the TRIGGERING node, clamped to that
        node's own local map: what the online searcher would have emitted
        at that node's pass. The recency guard uses the boundary-time
        accumulated travel.
        """
        n_nodes = graph.num_nodes
        window_nodes = np.asarray(
            [n for n in window_nodes if n < n_nodes], np.int64)
        eligible = self._eligible(graph, builder)
        if window_nodes.size == 0 or eligible is None:
            return []
        maps = builder.local_maps
        poses = graph.node_poses()
        w_xy = poses[window_nodes][:, :2]              # [W, 2]

        per_map = []
        for m in maps[:-1]:
            lo_n, hi_n = m.node_idx_min, m.node_idx_max
            if hi_n < lo_n:
                continue
            seg_el = eligible[lo_n:hi_n + 1]
            if not seg_el.any():
                continue
            seg_xy = poses[lo_n:hi_n + 1, :2]          # [S, 2]
            d2 = ((w_xy[:, None, :] - seg_xy[None, :, :]) ** 2).sum(-1)
            d2 = np.where(seg_el[None, :], d2, np.inf)
            flat = int(np.argmin(d2))
            wi, b = flat // d2.shape[1], flat % d2.shape[1]
            if d2[wi, b] < self.node_dist_max ** 2:
                per_map.append((float(d2[wi, b]), m.idx, lo_n + b,
                                int(window_nodes[wi])))
        if not per_map:
            return []
        per_map.sort()
        per_map = per_map[:max(1, self.num_candidate_maps)]

        out = []
        for _, map_idx, best, trigger in per_map:
            span = next(m for m in maps
                        if m.node_idx_min <= trigger <= m.node_idx_max)
            lo = max(span.node_idx_min, trigger - self.num_candidate_nodes)
            hi = min(span.node_idx_max, trigger + self.num_candidate_nodes,
                     n_nodes - 1)
            out.append(LoopCandidate(node_indices=list(range(lo, hi + 1)),
                                     local_map_idx=map_idx,
                                     local_map_node_idx=best))
        return out


@dataclasses.dataclass
class LoopDetectorBranchBound:
    """BranchBound detection (loop_detector_branch_bound.cpp:26-118).

    Without a mesh it is served by the exhaustive window sweep, which
    scores EVERY pose of the configured +-range/2 window with the
    pixel-accurate beam gate the BB matcher scores with. With ``mesh``
    set (``Backend(mesh=...)`` sets it) it runs branch-and-bound over each
    candidate map's pyramid, the candidate rows fanned out over the mesh
    (:meth:`_detect_fanout`), as the JAX package does: BB's coarse lattice
    rounds the window up to 2^``node_height_max`` blocks and does not
    clip children, so the two paths differ where the best match lies in
    that rounding margin.
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
    mesh: object = None  # Optional[parallel.mesh.Mesh]

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
        for cand in candidates:
            if not builder.local_maps[cand.local_map_idx].finished:
                raise ValueError("loop candidates must lie in finished maps")
        if self.mesh is not None:
            return self._detect_fanout(graph, builder, candidates)
        if len(candidates) == 1:
            return self._detect_single(graph, builder, candidates[0])
        return self._detect_multi(graph, builder, candidates)

    def _sweep_args(self):
        return dict(scan_range_max=self.scan_range_max,
                    range_theta=self.range_theta,
                    usable_range_min=self.usable_range_min,
                    usable_range_max=self.usable_range_max,
                    normalized_score_threshold=self.score_threshold)

    def _detect_single(self, graph: PoseGraph, builder: mb.GridMapBuilder,
                       cand: LoopCandidate) -> List[LoopDetectionResult]:
        """One candidate map, one query per node (see :func:`_count_queries`
        for why nothing is padded)."""
        st = builder.scans
        lm = builder.local_maps[cand.local_map_idx]
        win_x, win_y, win_t = self._window_params(builder.config.resolution)

        nodes = list(cand.node_indices)
        nb = st.beam_bucket()
        ids = np.asarray([int(graph.scan_ids[n]) for n in nodes])
        _count_queries(len(nodes), len(nodes))

        up = _uploader(builder.device)
        summary = matchers_sweep.correlative_match_sweep(
            builder.values_for(lm), lm.grid,
            up(graph.poses[nodes].astype(np.float32)),
            up(st.ranges[ids, :nb]), up(st.angles[ids, :nb]),
            up(st.valid[ids, :nb]), up(st.min_range[ids]),
            up(st.max_range[ids]), up(st.rel_sensor_pose[ids]),
            num_total_beams=up(
                np.maximum(st.raw_beams[ids], 1).astype(np.float32)),
            win_x=win_x, win_y=win_y, win_theta_max=win_t,
            greedy_params=self.greedy_params, score_gate="pixel_accurate",
            **self._sweep_args())
        packed = device_mod.sync(matchers_sweep.pack_summary(summary),
                                 site="detect").numpy()
        results: List[LoopDetectionResult] = []
        _emit(results, graph, cand, packed)
        return results

    def _detect_multi(self, graph: PoseGraph, builder: mb.GridMapBuilder,
                      candidates: List[LoopCandidate]
                      ) -> List[LoopDetectionResult]:
        """ALL candidates in one folded sweep (``_detect_mxu`` of the JAX
        package, loop_closure.py:397-473): the candidate maps' values
        stack into f32[M, H, W] and each (map, node) row reads its own map
        through ``map_idx``. M is the number of candidates and K the
        largest node count; a candidate with fewer nodes gets all-invalid
        rows, which score 0 and are never found. The stack is built anew
        every pass."""
        win_x, win_y, win_t = self._window_params(builder.config.resolution)
        m = len(candidates)
        k = max(len(c.node_indices) for c in candidates)
        poses, ranges, angles, valid, rmin, rmax, rel, beams = \
            _candidate_rows(graph, builder.scans, candidates, k)
        maps = [builder.local_maps[c.local_map_idx] for c in candidates]

        up = _uploader(builder.device)
        summary = matchers_sweep.correlative_match_sweep_multi(
            torch.stack([builder.values_for(lm) for lm in maps]),
            torch.stack([lm.grid.origin for lm in maps]),
            builder.config.resolution, up(poses), up(ranges), up(angles),
            up(valid), up(rmin), up(rmax), up(rel),
            num_total_beams=up(beams), win_x=win_x, win_y=win_y,
            win_theta_max=win_t, greedy_params=self.greedy_params,
            score_gate="pixel_accurate", **self._sweep_args())
        packed = device_mod.sync(matchers_sweep.pack_summary(
            matchers.MatchSummary(*(x.reshape((m * k,) + tuple(x.shape[2:]))
                                    for x in summary))),
            site="detect").numpy().reshape(m, k, -1)
        results: List[LoopDetectionResult] = []
        for ci, cand in enumerate(candidates):
            _emit(results, graph, cand, packed[ci])
        return results

    def _detect_fanout(self, graph: PoseGraph, builder: mb.GridMapBuilder,
                       candidates: List[LoopCandidate]
                       ) -> List[LoopDetectionResult]:
        """ALL candidates' branch-and-bound fan-outs over the mesh
        (``_detect_fanout`` of the JAX package, loop_closure.py:535-610):
        each candidate's nodes are padded with all-invalid rows to a
        multiple of the mesh's shard count K, which score 0 and are never
        found; M is the number of candidates, not bucketed (ROADMAP Queue
        3). The pyramids come from ``GridMapBuilder.pyramid_for``. Padded
        rows count as ``LoopDetectMxuPaddedQueries`` and the matches'
        ``frontier_overflow`` as ``LoopDetectFrontierOverflow``."""
        from my_lidar_graph_slam_tpu_torch.parallel import (distributed,
                                                            multihost)
        from my_lidar_graph_slam_tpu_torch.parallel.mesh import ShardedArray

        win_x, win_y, win_t = self._window_params(builder.config.resolution)
        n_dev = self.mesh.num_shards
        m = len(candidates)
        kmax = max(len(c.node_indices) for c in candidates)
        k = -(-kmax // n_dev) * n_dev
        rows = _candidate_rows(graph, builder.scans, candidates, k)
        maps = [builder.local_maps[c.local_map_idx] for c in candidates]

        up = _uploader(builder.device)
        out = distributed.branch_bound_fanout_multi(
            [builder.pyramid_for(lm, self.node_height_max) for lm in maps],
            [lm.grid for lm in maps], *(up(x) for x in rows),
            self.scan_range_max, self.range_theta, self.usable_range_min,
            self.usable_range_max, self.score_threshold, mesh=self.mesh,
            node_height_max=self.node_height_max, win_x=win_x, win_y=win_y,
            win_theta_max=win_t, frontier_cap=self.frontier_cap)
        # One packed [M, K, 16] read (a gather over processes).
        packed = multihost.fetch_global(ShardedArray(
            self.mesh, [matchers_sweep.pack_summary(matchers.MatchSummary(*(
                x.reshape((-1,) + tuple(x.shape[2:])) for x in shard))
            ).reshape(m, -1, 16) for shard in zip(*(f.shards for f in out))],
            1))
        results: List[LoopDetectionResult] = []
        overflow = 0
        for ci, cand in enumerate(candidates):
            n = len(cand.node_indices)
            overflow += int(packed[ci, :n, 15].sum())
            _emit(results, graph, cand, packed[ci])
        MetricManager.instance().counters(
            "LoopDetectFrontierOverflow").increment(overflow)
        return results


def _candidate_rows(graph: PoseGraph, st: mb.ScanStore,
                    candidates: List[LoopCandidate], k: int):
    """The candidates' nodes as [M, K, ...] host rows, sliced to the
    store's beam bucket: robot poses, ranges, angles, valid, scan range
    limits, sensor offsets and beam counts. Rows past a candidate's nodes
    are all-invalid (beam count 1): they score 0 and are never found.
    Counts the real and padded rows (:func:`_count_queries`)."""
    m, nb = len(candidates), st.beam_bucket()
    poses = np.zeros((m, k, 3), np.float32)
    ranges = np.zeros((m, k, nb), np.float32)
    angles = np.zeros((m, k, nb), np.float32)
    valid = np.zeros((m, k, nb), bool)
    rmin = np.zeros((m, k), np.float32)
    rmax = np.zeros((m, k), np.float32)
    rel = np.zeros((m, k, 3), np.float32)
    beams = np.ones((m, k), np.float32)
    for ci, cand in enumerate(candidates):
        nodes = list(cand.node_indices)
        n = len(nodes)
        ids = np.asarray([int(graph.scan_ids[i]) for i in nodes])
        poses[ci, :n] = graph.poses[nodes]
        ranges[ci, :n] = st.ranges[ids][:, :nb]
        angles[ci, :n] = st.angles[ids][:, :nb]
        valid[ci, :n] = st.valid[ids][:, :nb]
        rmin[ci, :n] = st.min_range[ids]
        rmax[ci, :n] = st.max_range[ids]
        rel[ci, :n] = st.rel_sensor_pose[ids]
        beams[ci, :n] = np.maximum(st.raw_beams[ids], 1)
    _count_queries(sum(len(c.node_indices) for c in candidates), m * k)
    return poses, ranges, angles, valid, rmin, rmax, rel, beams


def _uploader(dev):
    def up(arr):
        return device_mod.upload(arr, dev, site="detect")
    return up


def _emit(results, graph: PoseGraph, cand: LoopCandidate, packed):
    """Loop edges of the found rows of one candidate's packed [K, 16]
    result, in node order."""
    anchor_pose = graph.poses[cand.local_map_node_idx]
    for row, node_idx in enumerate(cand.node_indices):
        if packed[row, 14] <= 0.5:
            continue  # silent skip (loop_detector_branch_bound.cpp:74)
        matched = packed[row, 0:3].astype(np.float64)
        results.append(LoopDetectionResult(
            relative_pose=se2.inverse_compound_np(anchor_pose, matched),
            start_node_pose=anchor_pose.copy(),
            start_node_idx=cand.local_map_node_idx,
            end_node_idx=node_idx,
            covariance=packed[row, 3:12].reshape(3, 3).astype(np.float64)))


def _count_queries(real: int, total: int):
    """Real and padded (map, node) rows of a detection pass, under the JAX
    package's names. The JAX package rounds M and K up to powers of two to
    bound XLA recompiles; the port runs eagerly and its kernels take any
    Q, so it pads only the rows that make a ragged [M, K] fold
    rectangular, and its padded count is lower than the JAX package's on
    the same passes."""
    metrics = MetricManager.instance()
    metrics.counters("LoopDetectMxuQueries").increment(real)
    metrics.counters("LoopDetectMxuPaddedQueries").increment(total - real)


def _bucket_batch(n: int) -> int:
    """The JAX package's power-of-two batch bucket (``_bucket_batch``,
    loop_closure.py:209-214)."""
    k = 1
    while k < n:
        k *= 2
    return k


@dataclasses.dataclass
class LoopDetectorCorrelative:
    """Correlative detection (loop_detector_real_time_correlative.cpp:
    26-128; ``LoopDetectorCorrelative`` of the JAX package): the two-stage
    search of ``ops/correlative_coarse.py`` prunes on the candidate map's
    windowed-max coarse map and refines the best blocks on the fine map.

    One batch per candidate map. As in the JAX package the nodes are
    padded to a power of two with scan 0 at a zero pose; the padded rows
    take part in the escalation test and are never emitted (counted as
    ``LoopDetectMxuPaddedQueries``). ``last_exact`` is the certificate of
    the last candidate's real rows. Counters:
    ``LoopDetectCorrelativeEscalations``, the refinements after the first;
    ``LoopDetectCorrelativeInexact``, the candidates whose real rows are
    still uncertified after the last escalation.
    """

    score_threshold: float = 0.6
    low_resolution: int = 5
    range_x: float = 5.0
    range_y: float = 5.0
    range_theta: float = 1.0
    scan_range_max: float = 20.0
    usable_range_min: float = 0.01
    usable_range_max: float = 20.0
    refine_blocks: int = 512
    greedy_params: tuple = ()
    last_exact: bool = True

    def detect(self, graph: PoseGraph, builder: mb.GridMapBuilder,
               candidates: List[LoopCandidate]) -> List[LoopDetectionResult]:
        metrics = MetricManager.instance()
        results: List[LoopDetectionResult] = []
        for cand in candidates:
            lm = builder.local_maps[cand.local_map_idx]
            coarse = correlative_coarse.coarse_map_for(builder, lm,
                                                       self.low_resolution)
            nodes = list(cand.node_indices)
            k = _bucket_batch(len(nodes))
            ids = np.asarray([int(graph.scan_ids[n]) for n in nodes])
            idsp = np.concatenate([ids, np.zeros(k - len(nodes), ids.dtype)])
            poses = np.zeros((k, 3), np.float32)
            poses[:len(nodes)] = graph.poses[nodes]
            _count_queries(len(nodes), k)
            out = correlative_coarse.two_stage_match_batch(
                coarse, builder.values_for(lm), lm.grid, poses,
                low_resolution=self.low_resolution, range_x=self.range_x,
                range_y=self.range_y, range_theta=self.range_theta,
                scan_range_max=self.scan_range_max,
                usable_range_min=self.usable_range_min,
                usable_range_max=self.usable_range_max,
                score_threshold=self.score_threshold,
                refine_blocks=self.refine_blocks,
                greedy_params=self.greedy_params, scan_store=builder.scans,
                scan_ids=idsp)
            self.last_exact = bool(out.exact[:len(nodes)].all())
            metrics.counters("LoopDetectCorrelativeEscalations").increment(
                out.escalations)
            if not self.last_exact:
                metrics.counters("LoopDetectCorrelativeInexact").increment()
            _emit(results, graph, cand, out.packed)
        return results


@dataclasses.dataclass
class LoopDetectorGridSearch:
    """Exhaustive detection (loop_detector_grid_search.cpp:26-109): the
    nodes of each candidate are matched against its local map as one
    batch of lattice searches (one query per node, nothing padded)."""

    score_threshold: float = 0.5
    range_x: float = 2.0
    range_y: float = 2.0
    range_theta: float = 0.5
    step_x: float = 0.05
    step_y: float = 0.05
    step_theta: float = 0.005
    usable_range_min: float = 0.01
    usable_range_max: float = 20.0
    greedy_params: tuple = ()

    def detect(self, graph: PoseGraph, builder: mb.GridMapBuilder,
               candidates: List[LoopCandidate]) -> List[LoopDetectionResult]:
        nx = 2 * int(np.floor(0.5 * self.range_x / self.step_x)) + 1
        ny = 2 * int(np.floor(0.5 * self.range_y / self.step_y)) + 1
        nt = 2 * int(np.floor(0.5 * self.range_theta / self.step_theta)) + 1
        st = builder.scans
        nb = st.beam_bucket()
        up = _uploader(builder.device)
        results: List[LoopDetectionResult] = []
        for cand in candidates:
            lm = builder.local_maps[cand.local_map_idx]
            nodes = list(cand.node_indices)
            ids = np.asarray([int(graph.scan_ids[n]) for n in nodes])
            summary = matchers.grid_search_match(
                builder.values_for(lm), lm.grid,
                up(graph.poses[nodes].astype(np.float32)),
                up(st.ranges[ids, :nb]), up(st.angles[ids, :nb]),
                up(st.valid[ids, :nb]), up(st.min_range[ids]),
                up(st.max_range[ids]), up(st.rel_sensor_pose[ids]),
                usable_range_min=self.usable_range_min,
                usable_range_max=self.usable_range_max,
                normalized_score_threshold=self.score_threshold,
                step_x=self.step_x, step_y=self.step_y,
                step_t=self.step_theta,
                num_total_beams=up(
                    np.maximum(st.raw_beams[ids], 1).astype(np.float32)),
                nx=nx, ny=ny, nt=nt, greedy_params=self.greedy_params)
            packed = device_mod.sync(matchers_sweep.pack_summary(summary),
                                     site="detect").numpy()
            _emit(results, graph, cand, packed)
        return results


@dataclasses.dataclass
class LoopDetectorEmpty:
    """No-op detector (loop_detector_empty.cpp:10-19)."""

    def detect(self, graph, builder, candidates):
        return []
