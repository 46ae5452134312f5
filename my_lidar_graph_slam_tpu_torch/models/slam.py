"""SLAM runtime orchestration: frontend, backend, facade.

Counterpart of ``my_lidar_graph_slam_tpu/models/slam.py`` (the reference's
lidar_graph_slam{,_frontend,_backend}.cpp). The pose graph and scan store
are host arrays, the maps are device tensors; the post-optimization merge
re-chains trailing odometry nodes (lidar_graph_slam.cpp:318-371).

The backend runs either synchronously interleaved with the frontend
(deterministic, used by tests and ``chip_smoke.py``) or on a worker thread
like the reference's ``StartBackend`` (lidar_graph_slam.cpp:399-456). Both
threads use the default CUDA stream and share ``LidarGraphSlam._lock``;
every host read of a device result goes through ``.cpu()``.

Not ported yet: the pipelined (asynchronous) frontend, replay windows, the
device pose-graph solver (above ``host_solver_max_nodes`` the backend
raises) and the metrics registry.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional

import numpy as np

from my_lidar_graph_slam_tpu_torch.models import loop_closure as lc
from my_lidar_graph_slam_tpu_torch.models import map_builder as mb
from my_lidar_graph_slam_tpu_torch.models import optimizer_host
from my_lidar_graph_slam_tpu_torch.models.pose_graph import PoseGraph
from my_lidar_graph_slam_tpu_torch.models.preprocess import (
    ScanAccumulator, ScanInterpolator)
from my_lidar_graph_slam_tpu_torch.sensor.data import RawScan
from my_lidar_graph_slam_tpu_torch.utils import se2


@dataclasses.dataclass
class FrontendConfig:
    """Frontend gating thresholds (launcher_settings_default.json:187-204)."""

    initial_pose: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    update_threshold_travel_dist: float = 0.5
    update_threshold_angle: float = 0.5
    update_threshold_time: float = 5.0
    loop_detection_interval: int = 5


class Frontend:
    """Online local SLAM (lidar_graph_slam_frontend.cpp:37-145), blocking
    mode: each keyframe's match is read back before the node is
    appended."""

    def __init__(self, config: FrontendConfig, scan_matcher,
                 interpolator: Optional[ScanInterpolator] = None,
                 accumulator: Optional[ScanAccumulator] = None):
        self.config = config
        self.matcher = scan_matcher
        self.interpolator = interpolator
        self.accumulator = accumulator
        self.process_count = 0
        self.last_odom_pose = np.zeros(3)
        self.accumulated_travel_dist = 0.0
        self.accumulated_angle = 0.0
        self.last_map_update_odom = np.zeros(3)
        self.last_map_update_time = 0.0

    def process_scan(self, slam: "LidarGraphSlam", raw_scan: RawScan,
                     odom_pose: np.ndarray) -> bool:
        cfg = self.config

        rel_odom = (np.zeros(3) if self.process_count == 0 else
                    se2.inverse_compound_np(self.last_odom_pose, odom_pose))
        self.last_odom_pose = odom_pose.copy()
        self.accumulated_travel_dist += float(np.hypot(rel_odom[0],
                                                       rel_odom[1]))
        self.accumulated_angle += abs(float(rel_odom[2]))

        if self.accumulator is not None:
            self.accumulator.append(raw_scan)

        elapsed = (0.0 if self.process_count == 0 else
                   raw_scan.timestamp - self.last_map_update_time)
        update_needed = (
            self.accumulated_travel_dist >= cfg.update_threshold_travel_dist
            or self.accumulated_angle >= cfg.update_threshold_angle
            or elapsed >= cfg.update_threshold_time
            or self.process_count == 0)
        if not update_needed:
            return False

        scan = (self.accumulator.concatenated()
                if self.accumulator is not None else raw_scan)
        if self.interpolator is not None:
            scan = self.interpolator(scan)

        if self.process_count == 0:
            slam.append_first_node(cfg.initial_pose, scan)
        else:
            # Under the lock like GetLatestPoseAndMap
            # (lidar_graph_slam.cpp:90-100): the backend writes poses
            # during after_loop_closure.
            with slam._lock:
                latest_pose = slam.graph.latest_pose()
                latest_map = slam.builder.latest_map
            rel_from_update = se2.inverse_compound_np(
                self.last_map_update_odom, odom_pose)
            initial_pose = se2.compound_np(latest_pose, rel_from_update)

            scan_id = slam.scans.append(scan)
            summary = self.matcher.match(
                latest_map, slam.scans, scan_id, initial_pose)
            if not bool(summary.pose_found):
                raise RuntimeError("scan matching failed")
            estimated = np.asarray(summary.estimated_pose, np.float64)

            # Relative pose against the pre-matching latest pose; the node
            # pose is recomputed from the CURRENT latest node, which keeps
            # the frontend correct under concurrent loop closure
            # (lidar_graph_slam.cpp:210-229).
            edge_rel = se2.inverse_compound_np(latest_pose, estimated)
            slam.append_odometry_node_and_edge(
                scan_id, edge_rel, np.asarray(summary.covariance, np.float64))

        slam.update_grid_map()

        if (self.process_count > cfg.loop_detection_interval and
                self.process_count % cfg.loop_detection_interval == 0):
            slam.notify_backend()

        self.process_count += 1
        self.accumulated_travel_dist = 0.0
        self.accumulated_angle = 0.0
        self.last_map_update_odom = odom_pose.copy()
        self.last_map_update_time = scan.timestamp
        return True


class Backend:
    """Loop closure + optimization worker
    (lidar_graph_slam_backend.cpp:21-60), with the host sparse LM solver.
    Graphs of ``host_solver_max_nodes`` nodes or more need the device
    solver, which is not ported yet: the backend raises there."""

    def __init__(self, searcher: lc.LoopSearcherNearest, detector,
                 lm_config: optimizer_host.LMConfig,
                 host_solver_max_nodes: int = 2048):
        self.searcher = searcher
        self.detector = detector
        self.lm_config = lm_config
        self.host_solver_max_nodes = host_solver_max_nodes
        self.num_loop_closures = 0
        self.num_loop_edges = 0

    def _optimize(self, snapshot):
        if snapshot.num_nodes >= self.host_solver_max_nodes:
            raise NotImplementedError(
                f"{snapshot.num_nodes} nodes: the device pose-graph solver "
                f"(used from {self.host_solver_max_nodes} nodes) is not "
                f"ported yet")
        return optimizer_host.optimize_host(snapshot, self.lm_config)

    def run_once(self, slam: "LidarGraphSlam") -> int:
        """One backend pass; returns the number of accepted loop edges."""
        # Candidate search reads the live graph/builder arrays; under the
        # lock like GetLoopSearchHint (lidar_graph_slam.cpp:103-152).
        with slam._lock:
            candidates = self.searcher.search(slam.graph, slam.builder)
        if not candidates:
            return 0
        results = self.detector.detect(slam.graph, slam.builder, candidates)
        if not results:
            return 0
        slam.append_loop_closing_edges(results)

        # Snapshot + node count are taken ATOMICALLY (the reference
        # snapshots under its mutex, lidar_graph_slam.cpp:52-65).
        with slam._lock:
            snapshot = slam.graph.snapshot(
                edge_cap=_round_capacity(slam.graph.num_edges))
            optimized_count = slam.graph.num_nodes
        res = self._optimize(snapshot)
        slam.after_loop_closure(np.asarray(res.poses, np.float64),
                                optimized_count)
        self.num_loop_closures += 1
        self.num_loop_edges += len(results)
        return len(results)


def _round_capacity(n: int, minimum: int = 64) -> int:
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


class LidarGraphSlam:
    """Facade + shared-state owner (lidar_graph_slam.hpp:41-160)."""

    def __init__(self, frontend: Frontend, backend: Optional[Backend],
                 builder: mb.GridMapBuilder, graph: PoseGraph,
                 threaded_backend: bool = False):
        self.frontend = frontend
        self.backend = backend
        self.builder = builder
        self.graph = graph
        self.scans = builder.scans
        self._lock = threading.Lock()
        self._threaded = threaded_backend
        self._backend_thread: Optional[threading.Thread] = None
        self._backend_error: Optional[BaseException] = None
        self._notify = threading.Event()
        self._stop = False
        self._busy = False
        self._idle_cond = threading.Condition()

    @property
    def device(self):
        return self.builder.device

    # -- frontend-facing API -------------------------------------------------

    def process_scan(self, raw_scan: RawScan, odom_pose: np.ndarray) -> bool:
        return self.frontend.process_scan(self, raw_scan, odom_pose)

    @property
    def process_count(self) -> int:
        return self.frontend.process_count

    def append_first_node(self, pose: np.ndarray, scan: RawScan):
        with self._lock:
            scan_id = self.scans.append(scan)
            self.graph.append_node(np.asarray(pose, np.float64), scan_id)

    def append_odometry_node_and_edge(self, scan_id: int,
                                      edge_rel: np.ndarray,
                                      covariance: np.ndarray):
        """AppendOdometryNodeAndEdge (lidar_graph_slam.cpp:203-249)."""
        with self._lock:
            start_idx = self.graph.num_nodes - 1
            start_pose = self.graph.poses[start_idx]
            new_pose = se2.compound_np(start_pose, edge_rel)
            end_idx = self.graph.append_node(new_pose, scan_id)

            rel = edge_rel.copy()
            rel[2] = se2.normalize_angle_np(rel[2])
            robot_cov = se2.covariance_world_to_robot_np(
                start_pose, covariance)
            info = np.linalg.inv(robot_cov)
            self.graph.append_edge(start_idx, end_idx, rel, info)

    def update_grid_map(self) -> bool:
        with self._lock:
            return self.builder.append_scan(self.graph)

    # -- backend-facing API --------------------------------------------------

    def append_loop_closing_edges(self,
                                  results: List[lc.LoopDetectionResult]):
        """AppendLoopClosingEdges (lidar_graph_slam.cpp:252-282)."""
        with self._lock:
            for r in results:
                rel = r.relative_pose.copy()
                rel[2] = se2.normalize_angle_np(rel[2])
                robot_cov = se2.covariance_world_to_robot_np(
                    r.start_node_pose, r.covariance)
                info = np.linalg.inv(robot_cov)
                self.graph.append_edge(r.start_node_idx, r.end_node_idx,
                                       rel, info)

    def after_loop_closure(self, optimized_poses: np.ndarray,
                           optimized_count: int):
        """Write back optimized poses and re-chain trailing odometry nodes
        (lidar_graph_slam.cpp:318-371), then rebuild the maps."""
        with self._lock:
            g = self.graph
            g.write_back_poses(optimized_poses, optimized_count)
            for e in range(g.num_edges):
                j = g.edge_j[e]
                if g.edge_i[e] >= optimized_count - 1 and \
                        j >= optimized_count and g.edge_is_odom[e]:
                    g.poses[j] = se2.compound_np(
                        g.poses[g.edge_i[e]], g.edge_rel[e])
            self.builder.after_loop_closure(g)

    # -- backend thread control (lidar_graph_slam.cpp:399-456) ---------------

    def start_backend(self):
        if not self._threaded or self.backend is None:
            return
        if self._backend_thread is not None:
            raise RuntimeError("backend already running")
        self._stop = False

        def run():
            try:
                while not self._stop:
                    self._notify.wait()
                    # Busy is raised BEFORE the notification is cleared so
                    # wait_for_backend never sees (not notified, not busy)
                    # between wake-up and work start.
                    with self._idle_cond:
                        self._busy = True
                    self._notify.clear()
                    if self._stop:
                        break
                    self.backend.run_once(self)
                    with self._idle_cond:
                        self._busy = False
                        self._idle_cond.notify_all()
                # Drain pass over the complete graph, so closures signaled
                # near the end of a run are not lost.
                self.backend.run_once(self)
            except Exception as exc:  # re-raised by stop_backend
                self._backend_error = exc
            finally:
                with self._idle_cond:
                    self._busy = False
                    self._idle_cond.notify_all()

        self._backend_thread = threading.Thread(target=run, daemon=True)
        self._backend_thread.start()

    def stop_backend(self):
        """Stop the worker after a final pass; re-raise its error."""
        if self._backend_thread is None:
            return
        self._stop = True
        self._notify.set()
        self._backend_thread.join()
        self._backend_thread = None
        if self._backend_error is not None:
            err, self._backend_error = self._backend_error, None
            raise RuntimeError("backend thread failed") from err

    def notify_backend(self):
        if self.backend is None:
            return
        if self._threaded:
            self._notify.set()
        else:
            self.backend.run_once(self)

    def wait_for_backend(self, poll_s: float = 0.02):
        """Block until the worker has consumed every pending notification
        and finished the resulting pass (a determinism hook for tests)."""
        if self._backend_thread is None:
            return
        with self._idle_cond:
            while (self._notify.is_set() or self._busy) and \
                    self._backend_error is None:
                self._idle_cond.wait(poll_s)
