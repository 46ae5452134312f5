"""Chunked replay frontend.

Counterpart of ``my_lidar_graph_slam_tpu/models/replay.py``. Replay runs
a whole log through the same SLAM objects as the online frontend, K
keyframes at a time:

* The keyframe gate depends only on odometry and timestamps
  (lidar_graph_slam_frontend.cpp:60-75), so the whole keyframe schedule is
  computed on the host before any device work
  (:func:`precompute_keyframes`).

* Matching depends only on the latest map (the last-N-keyframes window
  rebuilt each keyframe, grid_map_builder.cpp:196-207) and the previous
  matched pose, not on the local maps. So the chain ``pose[t-1] -> latest
  map -> match -> pose[t]`` of K keyframes runs on the device with no host
  in the loop (:func:`replay_chunk`, the JAX package's ``_replay_chunk``,
  ``replay.py:132-214``): its ``lax.scan`` becomes a Python loop over the K
  steps that keeps the poses in a device tensor. Nothing inside a chunk
  reads a device value on the host; the chunk's K results come back in
  one packed transfer.

* Local-map integration (grid_map_builder.cpp:48-59) commutes with
  matching, so it runs after the chunk
  (``GridMapBuilder.append_scans_chunk``).

* Backend notifies inside a chunk (every ``LoopDetectionInterval``
  keyframes) collapse to one synchronous pass at the chunk boundary, over
  a window of every node appended since the last pass
  (``Backend.run_once(window_nodes=...)``).

* ``FrontendChunkTime`` is, on a card, the device's time from the start
  of a chunk's first queued work (its uploads) to the end of its last
  (the local-map integration), ``BackendPassTime`` the same for a
  backend pass (its rebuilds last): CUDA event pairs read once
  completed, without a sync (``MetricManager.device_timer``). On the CPU
  both are the host's time for the same calls.

As in the JAX package, there is no final backend pass after the last
chunk (ROADMAP, faults in the reference), so closures signalled in the
last chunk without a notify are not searched.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List

import numpy as np
import torch

from my_lidar_graph_slam_tpu_torch.models import slam as slam_mod
from my_lidar_graph_slam_tpu_torch.models.scan_matchers import \
    CorrelativeMatcher
from my_lidar_graph_slam_tpu_torch.ops import grid as gridops
from my_lidar_graph_slam_tpu_torch.ops import matchers_sweep, raycast
from my_lidar_graph_slam_tpu_torch.sensor.data import RawScan
from my_lidar_graph_slam_tpu_torch.utils import device as device_mod
from my_lidar_graph_slam_tpu_torch.utils import se2
from my_lidar_graph_slam_tpu_torch.utils.metrics import MetricManager


@dataclasses.dataclass
class Keyframe:
    """One precomputed keyframe: the processed scan + odometry context."""

    scan: RawScan                  # accumulated/interpolated scan
    odom_pose: np.ndarray          # raw odometry pose at this keyframe
    rel_from_update: np.ndarray    # odom delta since the previous keyframe
    notify: bool                   # backend notify fires at this keyframe


def precompute_keyframes(scan_records: List[RawScan], fe_config,
                         interpolator=None, accumulator=None
                         ) -> List[Keyframe]:
    """The frontend's keyframe gate over the whole log: exactly the gating
    state machine of ``slam.Frontend.process_scan``
    (lidar_graph_slam_frontend.cpp:43-75). Preprocessing
    (accumulator/interpolator) depends only on raw scans, so the processed
    keyframe scans are made here too."""
    cfg = fe_config
    keyframes: List[Keyframe] = []
    last_odom = np.zeros(3)
    acc_dist = 0.0
    acc_angle = 0.0
    last_update_odom = np.zeros(3)
    last_update_time = 0.0
    count = 0
    for i, scan in enumerate(scan_records):
        odom = np.asarray(scan.odom_pose, np.float64)
        rel = (np.zeros(3) if i == 0 else
               se2.inverse_compound_np(last_odom, odom))
        last_odom = odom.copy()
        acc_dist += float(np.hypot(rel[0], rel[1]))
        acc_angle += abs(float(rel[2]))
        if accumulator is not None:
            accumulator.append(scan)
        elapsed = 0.0 if count == 0 else scan.timestamp - last_update_time
        update = (acc_dist >= cfg.update_threshold_travel_dist
                  or acc_angle >= cfg.update_threshold_angle
                  or elapsed >= cfg.update_threshold_time
                  or count == 0)
        if not update:
            continue
        s = (accumulator.concatenated()
             if accumulator is not None else scan)
        if interpolator is not None:
            s = interpolator(s)
        rel_from_update = (np.zeros(3) if count == 0 else
                           se2.inverse_compound_np(last_update_odom, odom))
        notify = (count > cfg.loop_detection_interval and
                  count % cfg.loop_detection_interval == 0)
        keyframes.append(Keyframe(
            scan=s, odom_pose=odom, rel_from_update=rel_from_update,
            notify=notify))
        count += 1
        acc_dist = 0.0
        acc_angle = 0.0
        last_update_odom = odom.copy()
        last_update_time = s.timestamp
    return keyframes


def replay_chunk(w_poses, w_active, w_ranges, w_angles, w_valid, w_rel,
                 w_rmin, w_rmax, rel_from_update, kf_min_range, kf_max_range,
                 kf_beams, matcher: CorrelativeMatcher, resolution: float,
                 prob_hit: float, prob_miss: float, window: int,
                 latest_size: int, max_steps: int) -> torch.Tensor:
    """K keyframes' match chain on the device; returns packed f32[K, 16]
    results (pose 0:3, covariance 3:12, score 12, cost 13, found 14) on
    the device.

    Row layout (W = ``window`` = NumOfScansForLatestMap, K =
    ``rel_from_update.shape[0]``): the ``w_*`` tensors have W + K rows;
    rows [0, W) are the last W keyframes before the chunk (front rows
    inactive when fewer exist; row W-1 is the most recent), row W+t is
    chunk keyframe t. ``w_poses`` rows W.. are written here with the
    matched poses.

    Step t: (a) rebuild the latest map from rows [t, t+W), centered at
    pose row W+t-1 (grid_map_builder.cpp:196-207), (b) match keyframe t
    from ``compound(pose[W+t-1], rel_from_update[t])``, (c) write the
    matched pose into row W+t. No step reads a device value on the host.
    """
    dev = w_poses.device
    k = rel_from_update.shape[0]
    half = device_mod.upload(
        0.5 * resolution * np.array([latest_size, latest_size], np.float32),
        dev, site="replay_chunk")
    win_x, win_y, win_t = matcher._window(resolution)
    empty_lo = torch.zeros((latest_size, latest_size), dtype=torch.float32,
                           device=dev)
    empty_ob = torch.zeros((latest_size, latest_size), dtype=torch.bool,
                           device=dev)
    rows = []
    for t in range(k):
        prev_pose = w_poses[window + t - 1]
        win = slice(t, t + window)
        latest = raycast.integrate_scans(
            gridops.GridMap(empty_lo, empty_ob, prev_pose[:2] - half,
                            resolution),
            w_poses[win], w_ranges[win], w_angles[win], w_valid[win],
            w_rel[win], w_rmin[win], w_rmax[win], scan_active=w_active[win],
            prob_hit=prob_hit, prob_miss=prob_miss, max_steps=max_steps)
        kf = slice(window + t, window + t + 1)
        summary = matchers_sweep.correlative_match_sweep(
            gridops.values(latest), latest,
            se2.compound(prev_pose, rel_from_update[t])[None],
            w_ranges[kf], w_angles[kf], w_valid[kf],
            kf_min_range[t:t + 1], kf_max_range[t:t + 1], w_rel[kf],
            matcher.scan_range_max, matcher.range_theta,
            matcher.usable_range_min, matcher.usable_range_max, 0.0,
            kf_beams[t:t + 1], win_x=win_x, win_y=win_y,
            win_theta_max=win_t, cost_type=matcher.cost_type,
            greedy_params=matcher.greedy_params, score_gate="correlative")
        w_poses[window + t] = summary.estimated_pose[0]
        rows.append(matchers_sweep.pack_summary(summary))
    return torch.cat(rows, dim=0)


class ReplayRunner:
    """Drive a :class:`slam.LidarGraphSlam` through a log in chunks.

    Stand-in for the per-scan launcher loop (slam_launcher.cpp:980-1013):
    the same SLAM object and the same graph/builder/backend state
    afterwards, with the frontend's device work run ``chunk`` keyframes at
    a time. Needs the RealTimeCorrelative frontend matcher.
    """

    def __init__(self, slam_obj: slam_mod.LidarGraphSlam, chunk: int = 16):
        self.slam = slam_obj
        self.chunk = int(chunk)
        m = slam_obj.frontend.matcher
        if not isinstance(m, CorrelativeMatcher):
            raise ValueError(
                "replay mode requires the RealTimeCorrelative frontend "
                f"matcher (got {type(m).__name__})")
        self.matcher = m

    # -- chunk preparation ---------------------------------------------------

    def _window_arrays(self, scan_ids: np.ndarray, nb: int):
        """The W + K row arrays of one chunk whose K keyframe scans are
        ``scan_ids`` (see :func:`replay_chunk`)."""
        slam_obj = self.slam
        st = slam_obj.scans
        bcfg = slam_obj.builder.config
        w = bcfg.num_scans_for_latest_map
        k = len(scan_ids)
        n_nodes = slam_obj.graph.num_nodes
        pre = min(w, n_nodes)
        pre_nodes = np.arange(n_nodes - pre, n_nodes)
        pre_ids = slam_obj.graph.scan_ids[pre_nodes].astype(np.int64)

        rows = w + k
        poses = np.zeros((rows, 3), np.float32)
        active = np.zeros((rows,), bool)
        ranges = np.zeros((rows, nb), np.float32)
        angles = np.zeros((rows, nb), np.float32)
        valid = np.zeros((rows, nb), bool)
        rel = np.zeros((rows, 3), np.float32)
        rmin = np.full((rows,), bcfg.usable_range_min, np.float32)
        rmax = np.full((rows,), bcfg.usable_range_max, np.float32)

        def fill(row, sid):
            ranges[row] = st.ranges[sid, :nb]
            angles[row] = st.angles[sid, :nb]
            valid[row] = st.valid[sid, :nb]
            rel[row] = st.rel_sensor_pose[sid]
            rmin[row] = max(bcfg.usable_range_min, float(st.min_range[sid]))
            rmax[row] = min(bcfg.usable_range_max, float(st.max_range[sid]))

        for j, (node, sid) in enumerate(zip(pre_nodes, pre_ids)):
            row = w - pre + j
            poses[row] = slam_obj.graph.poses[node]
            active[row] = True
            fill(row, int(sid))
        for t, sid in enumerate(scan_ids):
            active[w + t] = True
            fill(w + t, int(sid))
        return poses, active, ranges, angles, valid, rel, rmin, rmax

    def _run_chunk(self, kf_batch: List[Keyframe]):
        """Run one chunk; returns (scan ids, poses, covariances, found) on
        the host."""
        slam_obj = self.slam
        st = slam_obj.scans
        bcfg = slam_obj.builder.config
        k = len(kf_batch)

        scan_ids = np.array([st.append(kf.scan) for kf in kf_batch],
                            np.int64)
        w = bcfg.num_scans_for_latest_map
        n_nodes = slam_obj.graph.num_nodes
        pre_ids = slam_obj.graph.scan_ids[
            max(0, n_nodes - w):n_nodes].astype(np.int64)
        all_ids = np.concatenate([pre_ids, scan_ids])
        nb = st.beam_bucket()
        reach = min(bcfg.usable_range_max,
                    float(st.max_range[all_ids].max()))
        steps = int(-(-(reach / bcfg.resolution + 2) // 64) * 64)
        steps = min(steps, bcfg.max_ray_steps)

        rel_upd = np.zeros((k, 3), np.float32)
        for t, kf in enumerate(kf_batch):
            rel_upd[t] = kf.rel_from_update
        dev = slam_obj.builder.device

        def up(arr):
            return device_mod.upload(arr, dev, site="replay_chunk")

        packed = replay_chunk(
            *(up(a) for a in self._window_arrays(scan_ids, nb)),
            up(rel_upd), up(st.min_range[scan_ids]),
            up(st.max_range[scan_ids]),
            up(np.maximum(st.raw_beams[scan_ids], 1).astype(np.float32)),
            self.matcher, bcfg.resolution, bcfg.prob_hit, bcfg.prob_miss,
            window=w, latest_size=bcfg.latest_map_size, max_steps=steps)
        # ONE transfer for the whole chunk.
        out = device_mod.sync(packed, site="replay_chunk").numpy()
        MetricManager.instance().counters("FrontendMxuMatches").increment(k)
        return scan_ids, out[:, 0:3], out[:, 3:12].reshape(k, 3, 3), \
            out[:, 14] > 0.5

    # -- top-level loop ------------------------------------------------------

    def run(self, scan_records: List[RawScan], progress_cb=None) -> int:
        """Process the whole log; returns the number of keyframes."""
        metrics = MetricManager.instance()
        slam_obj = self.slam
        fe = slam_obj.frontend
        t0 = time.time()
        kfs = precompute_keyframes(
            scan_records, fe.config,
            interpolator=fe.interpolator, accumulator=fe.accumulator)
        if not kfs:
            return 0
        metrics.gauges("ReplayPrecomputeSeconds").set(time.time() - t0)

        # Bootstrap: first keyframe at the initial pose
        # (lidar_graph_slam_frontend.cpp:86-90), then its map update.
        t0 = time.time()
        slam_obj.append_first_node(fe.config.initial_pose, kfs[0].scan)
        slam_obj.update_grid_map()
        fe.process_count = 1
        metrics.gauges("ReplayBootstrapSeconds").set(time.time() - t0)

        last_pass_node = 0
        i = 1
        while i < len(kfs):
            batch = kfs[i:i + self.chunk]
            with metrics.device_timer("FrontendChunkTime", slam_obj.device):
                scan_ids, est, cov, found = self._run_chunk(batch)
                if not bool(np.all(found)):
                    raise RuntimeError("scan matching failed in replay chunk")

                # Nodes + odometry edges at the matched poses, as the
                # per-scan frontend appends them.
                first_node = slam_obj.graph.num_nodes
                for t in range(len(batch)):
                    latest_pose = slam_obj.graph.latest_pose()
                    edge_rel = se2.inverse_compound_np(
                        latest_pose, est[t].astype(np.float64))
                    slam_obj.append_odometry_node_and_edge(
                        int(scan_ids[t]), edge_rel,
                        cov[t].astype(np.float64))

                slam_obj.builder.append_scans_chunk(
                    slam_obj.graph, first_node, len(batch))
            metrics.counters("ReplayKeyframes").increment(len(batch))

            fe.process_count += len(batch)
            if any(kf.notify for kf in batch) and \
                    slam_obj.backend is not None:
                # Coalesced pass at the chunk boundary (the condvar
                # drop-while-busy semantics, lidar_graph_slam.cpp:447-456)
                # over every node appended since the last pass.
                with metrics.device_timer("BackendPassTime",
                                          slam_obj.device):
                    slam_obj.backend.run_once(
                        slam_obj,
                        window_nodes=range(last_pass_node + 1,
                                           slam_obj.graph.num_nodes))
                last_pass_node = slam_obj.graph.num_nodes - 1
            if progress_cb is not None:
                progress_cb(fe.process_count)
            i += len(batch)
        return len(kfs)
