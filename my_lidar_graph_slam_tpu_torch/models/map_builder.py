"""Submap management: local maps, latest map, rebuilds.

Counterpart of ``my_lidar_graph_slam_tpu/models/map_builder.py`` (after
GridMapBuilder, grid_map_builder.{hpp,cpp}): local maps are fixed-size
dense log-odds tensors on the device, centered at the robot pose at
creation; the latest map is rebuilt from the last N scans at every
keyframe; after a loop closure every local map whose nodes moved is
rebuilt, all of them in stacked batches (grid_map_builder.cpp:62-80,
227-332).

Scan arrays for all pose-graph nodes live on the host in a
:class:`ScanStore`; each device step uploads the rows it needs. Replay
mode integrates a chunk of nodes at once (:meth:`GridMapBuilder.
append_scans_chunk`). Each local map caches its occupancy values, the
correlative loop detector's windowed-max coarse map and the
branch-and-bound pyramid of the mesh detector
(:meth:`GridMapBuilder.pyramid_for`); the TPU tile caches have no
counterpart here.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import List, Optional

import numpy as np
import torch

from my_lidar_graph_slam_tpu_torch.models.pose_graph import PoseGraph
from my_lidar_graph_slam_tpu_torch.ops import grid as gridops
from my_lidar_graph_slam_tpu_torch.ops import pyramid as pyrops
from my_lidar_graph_slam_tpu_torch.ops import raycast
from my_lidar_graph_slam_tpu_torch.sensor.data import RawScan
from my_lidar_graph_slam_tpu_torch.utils import device as device_mod
from my_lidar_graph_slam_tpu_torch.utils import metrics as metrics_mod
from my_lidar_graph_slam_tpu_torch.utils import se2
from my_lidar_graph_slam_tpu_torch.utils.metrics import MetricManager

# Local maps rebuilt together in one stacked integration.
REBUILD_BATCH = 8
# Bytes a ray-cast must move per visited cell (log-odds read and written,
# the observed flag written) and per cell of a map created or cleared.
CAST_BYTES_PER_CELL = 4 + 4 + 1
MAP_BYTES_PER_CELL = 4 + 1


def _bucket(n: int, minimum: int = 8) -> int:
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


class ScanStore:
    """Fixed-width host arrays of every pose-graph node's scan."""

    def __init__(self, beam_capacity: int = 1024):
        self.beam_capacity = beam_capacity
        cap = 64
        self.ranges = np.zeros((cap, beam_capacity), np.float32)
        self.angles = np.zeros((cap, beam_capacity), np.float32)
        self.valid = np.zeros((cap, beam_capacity), bool)
        self.min_range = np.zeros((cap,), np.float32)
        self.max_range = np.zeros((cap,), np.float32)
        self.rel_sensor_pose = np.zeros((cap, 3), np.float32)
        self.raw_beams = np.zeros((cap,), np.int32)
        self.timestamps = np.zeros((cap,), np.float64)
        self.count = 0
        self.truncated_beams = 0

    def _grow(self, need: int):
        cap = self.ranges.shape[0]
        if need <= cap:
            return
        new_cap = _bucket(need, 64)
        for name in ("ranges", "angles", "valid", "min_range", "max_range",
                     "rel_sensor_pose", "raw_beams", "timestamps"):
            arr = getattr(self, name)
            new = np.zeros((new_cap,) + arr.shape[1:], arr.dtype)
            new[:cap] = arr
            setattr(self, name, new)

    def append(self, scan: RawScan) -> int:
        idx = self.count
        self._grow(idx + 1)
        n = min(scan.num_beams, self.beam_capacity)
        if scan.num_beams > self.beam_capacity:
            # Never truncate silently.
            self.truncated_beams += scan.num_beams - self.beam_capacity
            MetricManager.instance().counters(
                "ScanStoreTruncatedBeams").increment(
                scan.num_beams - self.beam_capacity)
            print(f"WARNING: scan {idx} truncated from {scan.num_beams} to "
                  f"{self.beam_capacity} beams (raise beam_capacity)",
                  file=sys.stderr)
        self.ranges[idx, :n] = scan.ranges[:n]
        self.ranges[idx, n:] = 0.0
        self.angles[idx, :n] = scan.angles[:n]
        self.angles[idx, n:] = 0.0
        self.valid[idx, :n] = True
        self.valid[idx, n:] = False
        self.min_range[idx] = scan.min_range
        self.max_range[idx] = scan.max_range
        self.rel_sensor_pose[idx] = scan.rel_sensor_pose
        self.raw_beams[idx] = scan.num_beams
        self.timestamps[idx] = scan.timestamp
        self.count += 1
        return idx

    def beam_bucket(self) -> int:
        """Store-wide 64-aligned beam-width bucket: device steps slice scan
        arrays to this width."""
        n = max(int(self.raw_beams[:self.count].max()), 1) \
            if self.count else 1
        return min(int(-(-n // 64) * 64), self.beam_capacity)


@dataclasses.dataclass
class LocalMap:
    """Mirror of LocalMapInfo (grid_map_builder.hpp:31-109)."""

    idx: int
    grid: gridops.GridMap
    node_idx_min: int
    node_idx_max: int
    finished: bool = False
    values: Optional[torch.Tensor] = None   # cached occupancy values
    # Bumped whenever ``grid`` changes; the coarse map records the
    # version it was built from.
    grid_version: int = 0
    # The correlative detector's coarse map: (low_resolution, f32[H, W],
    # grid_version at build time), see ops/correlative_coarse.py.
    coarse: Optional[tuple] = None
    # The branch-and-bound pyramid f32[H + 1, size, size], see
    # pyramid_for.
    pyramid: Optional[torch.Tensor] = None
    # Node poses the current grid contents were integrated at; lets
    # after_loop_closure skip maps whose optimized poses barely moved.
    built_poses: Optional[np.ndarray] = None
    # Host copy of grid.origin (f32[2]), so host-side checks need no
    # device read.
    origin: Optional[np.ndarray] = None


@dataclasses.dataclass
class MapBuilderConfig:
    resolution: float = 0.05
    local_map_size: int = 1536        # cells per side (dense submap tensor)
    latest_map_size: int = 1024
    num_scans_for_latest_map: int = 10
    travel_dist_threshold: float = 20.0   # new local map spacing (m)
    usable_range_min: float = 0.01
    usable_range_max: float = 20.0
    prob_hit: float = 0.6
    prob_miss: float = 0.45
    max_ray_steps: int = 448


class GridMapBuilder:
    """Owns the local maps and the latest map (grid_map_builder.cpp:20-95).

    Maps live on ``device`` (``None`` means ``cuda``, and raises without a
    card); the scan store and the pose graph stay on the host.

    ``refresh_coarse_maps``: the JAX package keeps a local map's coarse
    map (``coarse_map_for``) when the map is rebuilt, so after a loop
    closure the correlative detector prunes with the old map's bounds
    (ROADMAP Queue 3). False, the default, keeps that behavior; True drops
    the coarse map whenever the grid changes.
    """

    def __init__(self, config: MapBuilderConfig, scan_store: ScanStore,
                 device=None, refresh_coarse_maps: bool = False):
        self.config = config
        self.scans = scan_store
        self.device = device_mod.resolve(device)
        self.refresh_coarse_maps = refresh_coarse_maps
        self.local_maps: List[LocalMap] = []
        self.latest_map: Optional[gridops.GridMap] = None
        self.latest_scan_idx_min = 0
        self.latest_scan_idx_max = 0
        self.accum_travel_dist = 0.0
        self.travel_dist_last_local_map = 0.0
        self.last_robot_pose = np.zeros(3)

    def _dev(self, arr) -> torch.Tensor:
        return device_mod.upload(arr, self.device, site="map_builder")

    def _grid_changed(self, lm: LocalMap):
        """Drop what was derived from ``lm.grid``: the occupancy values, the
        pyramid, and with ``refresh_coarse_maps`` the coarse map."""
        lm.values = None
        lm.pyramid = None
        lm.grid_version += 1
        if self.refresh_coarse_maps:
            lm.coarse = None

    def _steps(self, ids) -> int:
        """Ray-step bucket covering the reach of scans ``ids``."""
        cfg = self.config
        reach = min(cfg.usable_range_max,
                    float(self.scans.max_range[ids].max()))
        steps = int(-(-(reach / cfg.resolution + 2) // 64) * 64)
        return min(steps, cfg.max_ray_steps)

    def _scan_rows(self, graph: PoseGraph, nodes):
        """Device tensors of the scans of ``nodes`` (in order), sliced to
        the store's beam bucket: poses, ranges, angles, valid, rel, rmin,
        rmax."""
        cfg = self.config
        st = self.scans
        ids = graph.scan_ids[nodes].astype(np.int64)
        nb = st.beam_bucket()
        return (
            self._dev(graph.poses[nodes].astype(np.float32)),
            self._dev(st.ranges[ids][:, :nb]),
            self._dev(st.angles[ids][:, :nb]),
            self._dev(st.valid[ids][:, :nb]),
            self._dev(st.rel_sensor_pose[ids]),
            self._dev(np.maximum(cfg.usable_range_min, st.min_range[ids])),
            self._dev(np.minimum(cfg.usable_range_max, st.max_range[ids])),
        )

    # -- the work a cast must do (MapBuilderRaycastBytes) ---------------------

    def _count_cast(self, origin, poses, ids, steps: int):
        """While tracing, add to ``MapBuilderRaycastBytes`` the bytes that
        casting the stored scans ``ids`` at robot poses ``poses`` into a
        map with host origin ``origin`` must move by its definition: each
        valid in-range beam visits max(|dix|, |diy|) miss cells (at most
        ``steps``) and its hit cell, :data:`CAST_BYTES_PER_CELL` each.
        Worked out on the host from the store, whatever the cast's
        implementation pads; cells off the map count too (the builder
        keeps its scans inside their maps)."""
        if not metrics_mod.tracing():
            return
        cfg = self.config
        st = self.scans
        ids = np.asarray(ids, np.int64)
        nb = st.beam_bucket()
        poses = np.asarray(poses, np.float64).reshape(-1, 3)
        rel = st.rel_sensor_pose[ids].astype(np.float64)
        c, s = np.cos(poses[:, 2:3]), np.sin(poses[:, 2:3])
        sx = poses[:, 0:1] + c * rel[:, 0:1] - s * rel[:, 1:2]
        sy = poses[:, 1:2] + s * rel[:, 0:1] + c * rel[:, 1:2]
        angle = poses[:, 2:3] + rel[:, 2:3] + st.angles[ids, :nb]
        r = st.ranges[ids, :nb].astype(np.float64)
        rmin = np.maximum(cfg.usable_range_min, st.min_range[ids])
        rmax = np.minimum(cfg.usable_range_max, st.max_range[ids])
        use = st.valid[ids, :nb] & (r > rmin[:, None]) & (r < rmax[:, None])

        def cells(p, hit, o):
            return np.abs(np.floor((hit - o) / cfg.resolution) -
                          np.floor((p - o) / cfg.resolution))

        n = np.maximum(cells(sx, sx + r * np.cos(angle), origin[0]),
                       cells(sy, sy + r * np.sin(angle), origin[1]))
        visited = int((np.minimum(n, steps) + 1)[use].sum())
        MetricManager.instance().counters("MapBuilderRaycastBytes").increment(
            CAST_BYTES_PER_CELL * visited)

    def _count_maps(self, count: int, size: int):
        """While tracing, add ``count`` maps of ``size``^2 cells created or
        cleared to ``MapBuilderRaycastBytes``."""
        if metrics_mod.tracing():
            MetricManager.instance().counters(
                "MapBuilderRaycastBytes").increment(
                MAP_BYTES_PER_CELL * count * size * size)

    # -- scan integration ----------------------------------------------------

    def append_scan(self, graph: PoseGraph) -> bool:
        """Integrate the latest node's scan (grid_map_builder.cpp:48-59),
        the ``map_builder.update`` span.

        Returns True when a new local map was created.
        """
        with MetricManager.span("map_builder.update"):
            created = self._update_local_maps(graph)
            self._frontend_update(graph)
        return created

    def _frontend_update(self, graph: PoseGraph):
        """Integrate the newest scan into the current local map and rebuild
        the latest map from the last N scans (grid_map_builder.cpp:48-59,
        196-207; ``_fused_frontend_update`` of the JAX package)."""
        cfg = self.config
        st = self.scans
        node_idx = graph.num_nodes - 1
        robot_pose = graph.poses[node_idx]
        scan_id = int(graph.scan_ids[node_idx])
        lm = self.local_maps[-1]

        lo = max(0, node_idx - cfg.num_scans_for_latest_map + 1)
        hi = node_idx
        nodes = np.arange(lo, hi + 1)
        steps = self._steps(graph.scan_ids[nodes].astype(np.int64))
        nb = st.beam_bucket()

        sensor_pose = se2.compound_np(robot_pose, st.rel_sensor_pose[scan_id])
        self._count_cast(lm.origin, robot_pose, [scan_id], steps)
        lm.grid = raycast.integrate_scan(
            lm.grid, self._dev(sensor_pose.astype(np.float32)),
            self._dev(st.ranges[scan_id, :nb]),
            self._dev(st.angles[scan_id, :nb]),
            self._dev(st.valid[scan_id, :nb]),
            max(cfg.usable_range_min, float(st.min_range[scan_id])),
            min(cfg.usable_range_max, float(st.max_range[scan_id])),
            prob_hit=cfg.prob_hit, prob_miss=cfg.prob_miss, max_steps=steps)
        lm.node_idx_max = node_idx
        self._grid_changed(lm)
        # A copy: a view of graph.poses would move with a closure that the
        # grid has not seen, and after_loop_closure would skip the map.
        row = np.array(robot_pose, np.float64)[None, :]
        lm.built_poses = row if lm.built_poses is None else \
            np.concatenate([lm.built_poses, row])

        size = cfg.latest_map_size
        latest = gridops.empty(size, size, cfg.resolution,
                               center=robot_pose[:2], device=self.device)
        self._count_maps(1, size)
        self._count_cast(
            gridops.origin_for(robot_pose[:2], size, size, cfg.resolution),
            graph.poses[nodes], graph.scan_ids[nodes], steps)
        poses, r, a, v, rel, rmin, rmax = self._scan_rows(graph, nodes)
        self.latest_map = raycast.integrate_scans(
            latest, poses, r, a, v, rel, rmin, rmax,
            prob_hit=cfg.prob_hit, prob_miss=cfg.prob_miss, max_steps=steps)
        self.latest_scan_idx_min = lo
        self.latest_scan_idx_max = hi

    def _scan_fits(self, lm: LocalMap, robot_pose, scan_id: int,
                   margin: float = 1.0) -> bool:
        """Does this scan's hit-point bounding box fit the submap extent?

        Dense fixed-size maps cannot grow like the reference's patch-paged
        map (GridMap::Expand, grid_map.hpp:652-736), so the current local
        map is finished early and a fresh one started whenever a scan would
        write outside it — no beam is ever silently dropped.
        """
        cfg = self.config
        st = self.scans
        sensor_pose = se2.compound_np(robot_pose,
                                      st.rel_sensor_pose[scan_id])
        n = int(st.raw_beams[scan_id])
        r = st.ranges[scan_id, :n]
        keep = st.valid[scan_id, :n] & \
            (r > cfg.usable_range_min) & (r < cfg.usable_range_max)
        if not keep.any():
            return True
        a = sensor_pose[2] + st.angles[scan_id, :n][keep]
        hx = sensor_pose[0] + r[keep] * np.cos(a)
        hy = sensor_pose[1] + r[keep] * np.sin(a)
        h, w = lm.grid.shape
        lo = lm.origin + margin
        hi = lm.origin + lm.grid.resolution * np.array([w, h]) - margin
        return bool(hx.min() >= lo[0] and hx.max() <= hi[0] and
                    hy.min() >= lo[1] and hy.max() <= hi[1] and
                    lo[0] <= sensor_pose[0] <= hi[0] and
                    lo[1] <= sensor_pose[1] <= hi[1])

    def _new_local_map(self, node_idx: int, center) -> LocalMap:
        cfg = self.config
        size = cfg.local_map_size
        g = gridops.empty(size, size, cfg.resolution, center=center,
                          device=self.device)
        self._count_maps(1, size)
        return LocalMap(idx=len(self.local_maps), grid=g,
                        node_idx_min=node_idx, node_idx_max=node_idx,
                        origin=gridops.origin_for(center, size, size,
                                                  cfg.resolution))

    def _update_local_maps(self, graph: PoseGraph,
                           node_idx: Optional[int] = None) -> bool:
        """Local-map bookkeeping for node ``node_idx`` (default: the
        latest): travel accumulation, the travel-threshold and early-split
        decisions. Returns True when a new local map was created."""
        cfg = self.config
        if node_idx is None:
            node_idx = graph.num_nodes - 1
        robot_pose = graph.poses[node_idx]
        scan_id = int(graph.scan_ids[node_idx])

        if self.local_maps:
            rel = se2.inverse_compound_np(self.last_robot_pose, robot_pose)
            d = float(np.hypot(rel[0], rel[1]))
            self.accum_travel_dist += d
            self.travel_dist_last_local_map += d
        self.last_robot_pose = robot_pose.copy()

        create_new = (not self.local_maps) or \
            (self.travel_dist_last_local_map >= cfg.travel_dist_threshold)
        if not create_new and not self._scan_fits(
                self.local_maps[-1], robot_pose, scan_id):
            MetricManager.instance().counters(
                "LocalMapEarlySplits").increment()
            create_new = True   # Expand-equivalent early split
        if create_new:
            if self.local_maps:
                self.local_maps[-1].finished = True
            self.local_maps.append(
                self._new_local_map(node_idx, robot_pose[:2]))
            self.travel_dist_last_local_map = 0.0
        return create_new

    def append_scans_chunk(self, graph: PoseGraph, first_node: int,
                           count: int):
        """Batched :meth:`append_scan` for ``count`` new nodes (replay
        mode; ``map_builder.py:442-509`` of the JAX package).

        Walks the new nodes in order with the exact per-scan local-map
        bookkeeping (:meth:`_update_local_maps`), groups consecutive nodes
        that land in the same local map and integrates each group with one
        ``integrate_scans`` call in node order, then rebuilds the latest
        map once at the last node.
        """
        groups = []  # [(local map, [consecutive node indices])]
        for node_idx in range(first_node, first_node + count):
            self._update_local_maps(graph, node_idx)
            lm = self.local_maps[-1]
            if groups and groups[-1][0] is lm:
                groups[-1][1].append(node_idx)
            else:
                groups.append((lm, [node_idx]))
            lm.node_idx_max = node_idx
            row = np.array(graph.poses[node_idx], np.float64)[None, :]
            lm.built_poses = row if lm.built_poses is None else \
                np.concatenate([lm.built_poses, row])
            self._grid_changed(lm)
        for lm, nodes in groups:
            lm.grid = self._construct_from_nodes(lm.grid, lm.origin, graph,
                                                 nodes[0], nodes[-1])
        self._update_latest_map(graph)

    def _update_latest_map(self, graph: PoseGraph):
        """Rebuild the last-N-scans map (grid_map_builder.cpp:196-207)."""
        cfg = self.config
        last = graph.num_nodes - 1
        self.latest_scan_idx_min = max(
            0, last - cfg.num_scans_for_latest_map + 1)
        self.latest_scan_idx_max = last
        size = cfg.latest_map_size
        center = graph.poses[last][:2]
        g = gridops.empty(size, size, cfg.resolution, center=center,
                          device=self.device)
        self._count_maps(1, size)
        self.latest_map = self._construct_from_nodes(
            g, gridops.origin_for(center, size, size, cfg.resolution), graph,
            self.latest_scan_idx_min, self.latest_scan_idx_max)

    def _construct_from_nodes(self, grid, origin, graph: PoseGraph,
                              idx_min: int, idx_max: int) -> gridops.GridMap:
        """ConstructMapFromScans (grid_map_builder.cpp:227-332): integrate
        nodes [idx_min, idx_max] in order; ``origin`` is the grid's on the
        host."""
        cfg = self.config
        nodes = np.arange(idx_min, idx_max + 1)
        steps = self._steps(graph.scan_ids[nodes].astype(np.int64))
        self._count_cast(origin, graph.poses[nodes], graph.scan_ids[nodes],
                         steps)
        poses, r, a, v, rel, rmin, rmax = self._scan_rows(graph, nodes)
        return raycast.integrate_scans(
            grid, poses, r, a, v, rel, rmin, rmax,
            prob_hit=cfg.prob_hit, prob_miss=cfg.prob_miss, max_steps=steps)

    # -- loop closure --------------------------------------------------------

    def after_loop_closure(self, graph: PoseGraph):
        """Rebuild local maps + the latest map from optimized poses
        (grid_map_builder.cpp:62-80), the ``map_builder.rebuild`` span.

        A local map whose node poses moved less than half a cell (and whose
        rotation moves hit points by less than half a cell at max range) is
        unchanged by a rebuild and is skipped, as in the JAX package. The
        others are rebuilt in stacked batches of :data:`REBUILD_BATCH`.
        """
        with MetricManager.span("map_builder.rebuild"):
            self._after_loop_closure(graph)

    def _after_loop_closure(self, graph: PoseGraph):
        cfg = self.config
        eps_t = 0.5 * cfg.resolution
        eps_a = 0.5 * cfg.resolution / max(cfg.usable_range_max, 1e-6)
        metrics = MetricManager.instance()
        rebuild: List[LocalMap] = []
        for lm in self.local_maps:
            new_poses = graph.poses[lm.node_idx_min:lm.node_idx_max + 1]
            if lm.built_poses is not None and \
                    lm.built_poses.shape == new_poses.shape:
                dt = np.abs(new_poses[:, :2] - lm.built_poses[:, :2]).max()
                da = np.abs(se2.normalize_angle_np(
                    new_poses[:, 2] - lm.built_poses[:, 2])).max()
                if dt < eps_t and da < eps_a:
                    metrics.counters("LocalMapRebuildsSkipped").increment()
                    continue
            rebuild.append(lm)
        if rebuild:
            all_nodes = np.concatenate([
                np.arange(lm.node_idx_min, lm.node_idx_max + 1)
                for lm in rebuild])
            steps = self._steps(graph.scan_ids[all_nodes].astype(np.int64))
            for b0 in range(0, len(rebuild), REBUILD_BATCH):
                self._rebuild(graph, rebuild[b0:b0 + REBUILD_BATCH], steps)
            metrics.counters("LocalMapRebuilds").increment(len(rebuild))
        self._update_latest_map(graph)
        self._update_accum_travel_dist(graph)

    def _rebuild(self, graph: PoseGraph, batch: List[LocalMap],
                 steps: int):
        """Rebuild ``batch`` from scratch in one stacked integration
        (``_rebuild_maps_batched`` of the JAX package)."""
        cfg = self.config
        st = self.scans
        size = cfg.local_map_size
        m = len(batch)
        k = max(lm.node_idx_max - lm.node_idx_min + 1 for lm in batch)
        nb = st.beam_bucket()
        origins = np.zeros((m, 2), np.float32)
        poses = np.zeros((m, k, 3), np.float32)
        ranges = np.zeros((m, k, nb), np.float32)
        angles = np.zeros((m, k, nb), np.float32)
        valid = np.zeros((m, k, nb), bool)
        rel = np.zeros((m, k, 3), np.float32)
        rmin = np.full((m, k), cfg.usable_range_min, np.float32)
        rmax = np.full((m, k), cfg.usable_range_max, np.float32)
        active = np.zeros((m, k), bool)
        for i, lm in enumerate(batch):
            lo_n, hi_n = lm.node_idx_min, lm.node_idx_max
            n = hi_n - lo_n + 1
            ids = graph.scan_ids[lo_n:hi_n + 1].astype(np.int64)
            # float64 center, as map_builder.py:582-584 of the JAX package.
            origins[i] = graph.poses[lo_n][:2] - \
                0.5 * cfg.resolution * size
            poses[i, :n] = graph.poses[lo_n:hi_n + 1]
            ranges[i, :n] = st.ranges[ids][:, :nb]
            angles[i, :n] = st.angles[ids][:, :nb]
            valid[i, :n] = st.valid[ids][:, :nb]
            rel[i, :n] = st.rel_sensor_pose[ids]
            rmin[i, :n] = np.maximum(cfg.usable_range_min, st.min_range[ids])
            rmax[i, :n] = np.minimum(cfg.usable_range_max, st.max_range[ids])
            active[i, :n] = True

        zeros = torch.zeros((m, size, size), dtype=torch.float32,
                            device=self.device)
        self._count_maps(m, size)
        for i, lm in enumerate(batch):
            self._count_cast(origins[i],
                             graph.poses[lm.node_idx_min:lm.node_idx_max + 1],
                             graph.scan_ids[lm.node_idx_min:
                                            lm.node_idx_max + 1], steps)
        log_odds, observed = raycast.integrate_scans_stacked(
            zeros, torch.zeros_like(zeros, dtype=torch.bool),
            self._dev(origins), cfg.resolution, self._dev(poses),
            self._dev(ranges), self._dev(angles), self._dev(valid),
            self._dev(rel), self._dev(rmin), self._dev(rmax),
            self._dev(active), prob_hit=cfg.prob_hit,
            prob_miss=cfg.prob_miss, max_steps=steps)
        for i, lm in enumerate(batch):
            lm.grid = gridops.GridMap(log_odds[i], observed[i],
                                      self._dev(origins[i]), cfg.resolution)
            lm.origin = origins[i].copy()
            self._grid_changed(lm)
            lm.built_poses = np.asarray(
                graph.poses[lm.node_idx_min:lm.node_idx_max + 1],
                np.float64).copy()

    def _update_accum_travel_dist(self, graph: PoseGraph):
        """Recompute total travel from node poses
        (grid_map_builder.cpp:210-224)."""
        poses = graph.node_poses()
        if len(poses) < 2:
            self.accum_travel_dist = 0.0
            return
        d = np.diff(poses[:, :2], axis=0)
        self.accum_travel_dist = float(np.hypot(d[:, 0], d[:, 1]).sum())

    # -- global map ----------------------------------------------------------

    def construct_global_map(self, graph: PoseGraph) -> gridops.GridMap:
        """Re-integrate every scan into one map sized to the trajectory
        bounding box (grid_map_builder.cpp:83-95)."""
        cfg = self.config
        poses = graph.node_poses()
        margin = cfg.usable_range_max + 1.0
        lo = poses[:, :2].min(axis=0) - margin
        hi = poses[:, :2].max(axis=0) + margin
        center = 0.5 * (lo + hi)
        cells = int(np.ceil(float((hi - lo).max()) / cfg.resolution))
        cells = min(_bucket(cells, 256), 4096)
        g = gridops.empty(cells, cells, cfg.resolution, center=center,
                          device=self.device)
        self._count_maps(1, cells)
        return self._construct_from_nodes(
            g, gridops.origin_for(center, cells, cells, cfg.resolution),
            graph, 0, graph.num_nodes - 1)

    def values_for(self, lm: LocalMap) -> torch.Tensor:
        """Lazily compute + cache a local map's occupancy values."""
        if lm.values is None:
            lm.values = gridops.values(lm.grid)
        return lm.values

    def pyramid_for(self, lm: LocalMap, height_max: int) -> torch.Tensor:
        """Lazily build + cache a local map's branch-and-bound pyramid
        (the mPrecomputedMaps cache, loop_detector_branch_bound.cpp:52-60;
        ``pyramid_for`` of the JAX package). 7 levels of a 1536^2 map hold
        66 MB per finished map."""
        if lm.pyramid is None or lm.pyramid.shape[0] != height_max + 1:
            lm.pyramid = pyrops.build_pyramid(self.values_for(lm),
                                              height_max)
        return lm.pyramid
