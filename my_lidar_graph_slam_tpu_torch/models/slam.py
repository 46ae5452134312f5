"""SLAM runtime orchestration: frontend, backend, facade.

Counterpart of ``my_lidar_graph_slam_tpu/models/slam.py`` (the reference's
lidar_graph_slam{,_frontend,_backend}.cpp). The pose graph and scan store
are host arrays, the maps are device tensors; the post-optimization merge
re-chains trailing odometry nodes (lidar_graph_slam.cpp:318-371).

The backend runs either synchronously interleaved with the frontend
(deterministic, used by tests and ``chip_smoke.py``) or on a worker thread
like the reference's ``StartBackend`` (lidar_graph_slam.cpp:399-456). Both
threads use the default CUDA stream and share ``LidarGraphSlam._lock``;
every host read of a device result goes through ``utils/device.py::sync``
(a ``.cpu()`` or, for a frontend match, a CUDA event on a page-locked
copy), which counts it.

Spans (``MetricManager.span``, recorded while a ``torch.profiler`` session
is active): ``keyframe`` (a keyframe past the gate, its scan id as the
keyframe), ``lock_wait`` (every acquisition of the lock, from asking to
holding), ``backend.pass`` (its pass number as the keyframe),
``backend.detect`` and ``backend.solve``; the matchers and the map
builder add theirs.

Replay mode (``models/replay.py``) drives the same objects and calls
``Backend.run_once`` with a window of nodes. The backend solves graphs
below ``host_solver_max_nodes`` on the host and larger ones with the
device solver (``models/optimizer_lm.py``) on the SLAM's device; with a
mesh, every graph with the node-sharded solver of ``parallel/``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import List, Optional

import numpy as np

from my_lidar_graph_slam_tpu_torch.models import loop_closure as lc
from my_lidar_graph_slam_tpu_torch.models import map_builder as mb
from my_lidar_graph_slam_tpu_torch.models import optimizer_host, optimizer_lm
from my_lidar_graph_slam_tpu_torch.models.pose_graph import PoseGraph
from my_lidar_graph_slam_tpu_torch.models.preprocess import (
    ScanAccumulator, ScanInterpolator)
from my_lidar_graph_slam_tpu_torch.sensor.data import RawScan
from my_lidar_graph_slam_tpu_torch.utils import device as device_mod
from my_lidar_graph_slam_tpu_torch.utils import se2
from my_lidar_graph_slam_tpu_torch.utils.metrics import MetricManager


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
    """Online local SLAM (lidar_graph_slam_frontend.cpp:37-145).

    Every keyframe's match is started without waiting and resolved by
    :meth:`flush`: node append and map update run at resolution, with the
    compose-from-current-latest-node rule (lidar_graph_slam.cpp:210-229).
    Blocking mode flushes at once. ``async_pipeline`` (``slam.py:45-181``
    of the JAX package; set the attribute to turn it on) defers the flush
    to the next keyframe or to ``stop_backend``, so backend notifies see
    the graph one keyframe behind. The map update queued at resolution
    precedes the next match on the same stream, so that match reads the
    updated map with no host synchronization.
    """

    def __init__(self, config: FrontendConfig, scan_matcher,
                 interpolator: Optional[ScanInterpolator] = None,
                 accumulator: Optional[ScanAccumulator] = None):
        self.config = config
        self.matcher = scan_matcher
        self.interpolator = interpolator
        self.accumulator = accumulator
        self.async_pipeline = False
        self._pending = None
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
        with MetricManager.span("keyframe", keyframe=slam.scans.count):
            self._keyframe(slam, raw_scan, odom_pose)
        return True

    def _keyframe(self, slam: "LidarGraphSlam", raw_scan: RawScan,
                  odom_pose: np.ndarray):
        cfg = self.config
        scan = (self.accumulator.concatenated()
                if self.accumulator is not None else raw_scan)
        if self.interpolator is not None:
            scan = self.interpolator(scan)

        if self.process_count == 0:
            slam.append_first_node(cfg.initial_pose, scan)
            slam.update_grid_map()
        else:
            # Resolve the previous keyframe, if one is pending, then read
            # the latest pose and map under the lock like
            # GetLatestPoseAndMap (lidar_graph_slam.cpp:90-100): the
            # backend writes poses during after_loop_closure.
            self.flush(slam)
            with slam._lock:
                latest_pose = slam.graph.latest_pose()
                latest_map = slam.builder.latest_map
            rel_from_update = se2.inverse_compound_np(
                self.last_map_update_odom, odom_pose)
            initial_pose = se2.compound_np(latest_pose, rel_from_update)
            scan_id = slam.scans.append(scan)
            pending = self.matcher.match_async(
                latest_map, slam.scans, scan_id, initial_pose)
            self._pending = (scan_id, pending, initial_pose, latest_pose)
            if not self.async_pipeline:
                self.flush(slam)

        if (self.process_count > cfg.loop_detection_interval and
                self.process_count % cfg.loop_detection_interval == 0):
            slam.notify_backend()

        self.process_count += 1
        self.accumulated_travel_dist = 0.0
        self.accumulated_angle = 0.0
        self.last_map_update_odom = odom_pose.copy()
        self.last_map_update_time = scan.timestamp

    def flush(self, slam: "LidarGraphSlam"):
        """Resolve the pending keyframe (append node/edge + map update).
        No-op when nothing is pending."""
        if self._pending is None:
            return
        scan_id, pending, initial_pose, latest_pose = self._pending
        self._pending = None
        summary = self.matcher.resolve_async(pending, initial_pose)
        if not bool(summary.pose_found):
            raise RuntimeError("scan matching failed")
        estimated = np.asarray(summary.estimated_pose, np.float64)
        # Relative pose against the pre-matching latest pose; the node pose
        # is recomputed from the CURRENT latest node, which keeps the
        # frontend correct under concurrent loop closure
        # (lidar_graph_slam.cpp:210-229).
        edge_rel = se2.inverse_compound_np(latest_pose, estimated)
        slam.append_odometry_node_and_edge(
            scan_id, edge_rel, np.asarray(summary.covariance, np.float64))
        slam.update_grid_map()


class Backend:
    """Loop closure + optimization worker
    (lidar_graph_slam_backend.cpp:21-60).

    Graphs below ``host_solver_max_nodes`` nodes solve on the host (scipy
    sparse LM, the Eigen-equivalent direct path); larger ones with the
    device LM solver (matrix-free PCG) on ``device`` (``None`` means
    ``cuda``), as ``slam.py:214-224`` of the JAX package does without a
    mesh. With ``mesh`` (``parallel/mesh.py``) every graph, at any node
    count, solves with the node-sharded LM
    (``distributed.optimize_sharded_nodes``) and the detector, where it
    has a ``mesh`` field (``LoopDetectorBranchBound``), fans its candidate
    rows out over the mesh. There is no fallback between the paths: a
    device or collective failure raises.
    """

    def __init__(self, searcher: lc.LoopSearcherNearest, detector,
                 lm_config: optimizer_host.LMConfig,
                 host_solver_max_nodes: int = 2048, device=None, mesh=None):
        self.searcher = searcher
        self.detector = detector
        self.lm_config = lm_config
        self.host_solver_max_nodes = host_solver_max_nodes
        self.device = device
        self.mesh = mesh
        self.num_loop_closures = 0
        self.num_loop_edges = 0
        self.num_device_solves = 0
        self.num_sharded_solves = 0
        self.num_passes = 0
        if mesh is not None and hasattr(detector, "mesh"):
            detector.mesh = mesh

    def _optimize(self, snapshot):
        """The solver's result, its poses f32[>= N_cap, 3] on the host."""
        if self.mesh is not None:
            from my_lidar_graph_slam_tpu_torch.parallel import (distributed,
                                                                multihost)
            sharded = distributed.partition_graph_by_nodes(
                snapshot, self.mesh.num_shards)
            res = distributed.optimize_sharded_nodes(sharded, self.lm_config,
                                                     self.mesh)
            self.num_sharded_solves += 1
            return res._replace(poses=multihost.fetch_global(res.poses))
        if snapshot.num_nodes < self.host_solver_max_nodes:
            return optimizer_host.optimize_host(snapshot, self.lm_config)
        res = optimizer_lm.optimize(snapshot, self.lm_config, self.device)
        self.num_device_solves += 1
        return res._replace(
            poses=device_mod.sync(res.poses, site="solve").numpy())

    def run_once(self, slam: "LidarGraphSlam", window_nodes=None) -> int:
        """One backend pass, the ``backend.pass`` span; returns the number
        of accepted loop edges.

        ``window_nodes``: replay mode passes the nodes appended since the
        last pass, so any of them can trigger a candidate
        (``LoopSearcherNearest.search_window``); online mode searches from
        the latest node only, as the reference does. Metrics under the JAX
        package's names (``slam.py:226-324``); ``PostClosureRebuildTime``
        is, on a card, the device's time from the start of the pose write
        back's first queued work to the end of the rebuilds
        (``MetricManager.device_timer``), on the CPU the host's.
        """
        self.num_passes += 1
        with MetricManager.span("backend.pass", keyframe=self.num_passes):
            return self._pass(slam, window_nodes)

    def _pass(self, slam: "LidarGraphSlam", window_nodes) -> int:
        metrics = MetricManager.instance()
        # Candidate search reads the live graph/builder arrays; under the
        # lock like GetLoopSearchHint (lidar_graph_slam.cpp:103-152).
        with slam._lock:
            if window_nodes is not None:
                candidates = self.searcher.search_window(
                    slam.graph, slam.builder, window_nodes)
            else:
                candidates = self.searcher.search(slam.graph, slam.builder)
        if not candidates:
            return 0
        t0 = time.time()
        with MetricManager.span("backend.detect"):
            results = self.detector.detect(slam.graph, slam.builder,
                                           candidates)
        metrics.distributions("LoopDetectionTime").observe(time.time() - t0)
        metrics.counters("LoopDetectionQueries").increment(
            sum(len(c.node_indices) for c in candidates))
        if not results:
            return 0
        t0 = time.time()
        slam.append_loop_closing_edges(results)
        metrics.distributions("AppendLoopEdgesTime").observe(
            time.time() - t0)
        metrics.counters("LoopClosingEdges").increment(len(results))

        # Snapshot + node count are taken ATOMICALLY (the reference
        # snapshots under its mutex, lidar_graph_slam.cpp:52-65).
        n_dev = 1 if self.mesh is None else self.mesh.num_shards
        with slam._lock:
            snapshot = slam.graph.snapshot(
                edge_cap=_round_multiple(slam.graph.num_edges, n_dev))
            optimized_count = slam.graph.num_nodes
        t0 = time.time()
        with MetricManager.span("backend.solve"):
            res = self._optimize(snapshot)
            poses_opt = np.asarray(res.poses, np.float64)
        metrics.distributions("PoseGraphSolveTime").observe(time.time() - t0)
        t0 = time.time()
        _dump_error_histogram(snapshot, poses_opt, metrics)
        metrics.distributions("ErrorHistogramTime").observe(
            time.time() - t0)
        with metrics.device_timer("PostClosureRebuildTime", slam.device):
            slam.after_loop_closure(poses_opt, optimized_count)
        self.num_loop_closures += 1
        self.num_loop_edges += len(results)
        return len(results)


def _dump_error_histogram(snapshot, poses_opt, metrics):
    """Per-edge chi-square errors after optimization into the
    ``PoseGraphEdgeError`` histogram, the reference's one wired metric
    (pose_graph_optimizer_lm.cpp:341-381)."""
    ei = np.asarray(snapshot.edge_i)
    ej = np.asarray(snapshot.edge_j)
    rel = np.asarray(snapshot.edge_rel, np.float64)
    pi = poses_opt[ei]
    pj = poses_opt[ej]
    s, c = np.sin(pi[:, 2]), np.cos(pi[:, 2])
    dx, dy = pj[:, 0] - pi[:, 0], pj[:, 1] - pi[:, 1]
    h = np.stack([c * dx + s * dy, -s * dx + c * dy,
                  pj[:, 2] - pi[:, 2]], axis=-1)
    err = h - rel
    err[:, 2] = se2.normalize_angle_np(err[:, 2])
    sq = np.einsum("ei,eij,ej->e", err,
                   np.asarray(snapshot.edge_info, np.float64), err)
    hist = metrics.histograms("PoseGraphEdgeError",
                              boundaries=np.logspace(-4, 2, 13).tolist())
    for v in sq[np.asarray(snapshot.edge_mask)]:
        hist.observe(float(v))


def _round_multiple(n: int, k: int, minimum: int = 64) -> int:
    """Power-of-two edge capacity, rounded up to a multiple of ``k``
    (the mesh's shard count; ``_round_multiple`` of the JAX package)."""
    cap = minimum
    while cap < n:
        cap *= 2
    if cap % k:
        cap += k - cap % k
    return cap


class _WaitedLock:
    """The SLAM's lock; while tracing, every acquisition is a
    ``lock_wait`` span from asking for the lock to holding it."""

    def __init__(self):
        self._lock = threading.Lock()

    def __enter__(self):
        with MetricManager.span("lock_wait"):
            self._lock.acquire()
        return self

    def __exit__(self, *exc):
        self._lock.release()
        return False


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
        self._lock = _WaitedLock()
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
        """Land the pipelined frontend's last keyframe, then stop the
        worker after a final pass; re-raise its error."""
        self.frontend.flush(self)
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
