"""Frontend scan-matcher strategy wrapper.

Counterpart of ``my_lidar_graph_slam_tpu/models/scan_matchers.py:34-62,
147-263,312-325``: :class:`CorrelativeMatcher` (ScanMatcherRealTimeCorrelative
config, launcher_settings_default.json:42-50) on the exhaustive sweep path
(``ops/matchers_sweep.py``). A match is one sequence of device launches and
ONE ``.cpu()`` of a packed [Q, 16] result. The pruned gather path, the
asynchronous match and the other matcher strategies are not ported yet.

Default greedy-endpoint parameters replicate the launcher's *effective*
configuration, including the swapped (scale, sigma) constructor arguments
(slam_launcher.cpp:70-72).

Frontend score threshold: the reference passes the smallest POSITIVE
double as the normalized threshold (scan_matcher_real_time_correlative
.cpp:40-46) and asserts pose_found (lidar_graph_slam_frontend.cpp:109-110);
scores are sums of non-negative occupancies, so the equivalent is threshold
0.0 with strict ``>``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from my_lidar_graph_slam_tpu_torch.ops import grid as gridops
from my_lidar_graph_slam_tpu_torch.ops import matchers, matchers_sweep

DEFAULT_GREEDY_PARAMS = (
    ("hit_and_missed_dist", 0.075),
    ("occupancy_threshold", 0.1),
    ("kernel_size", 1),
    ("standard_deviation", 1.0),
    ("scaling_factor", 0.05),
)


def unpack_summary(packed: np.ndarray, initial_poses) -> matchers.MatchSummary:
    """Host MatchSummary (NumPy fields) from a packed [Q, 16] array."""
    return matchers.MatchSummary(
        pose_found=packed[:, 14] > 0.5,
        normalized_cost=packed[:, 13],
        normalized_score=packed[:, 12],
        initial_pose=np.asarray(initial_poses, np.float32),
        estimated_pose=packed[:, 0:3],
        covariance=packed[:, 3:12].reshape(-1, 3, 3),
    )


@dataclasses.dataclass
class CorrelativeMatcher:
    """ScanMatcherRealTimeCorrelative config: every (theta, dx, dy)
    candidate of the window is scored (``low_resolution`` is kept for
    config parity only)."""

    low_resolution: int = 5
    range_x: float = 0.2
    range_y: float = 0.2
    range_theta: float = 0.5
    scan_range_max: float = 20.0
    usable_range_min: float = 0.01
    usable_range_max: float = 20.0
    cost_type: str = "greedy_endpoint"
    greedy_params: tuple = DEFAULT_GREEDY_PARAMS

    def _window(self, res: float):
        win_x = int(np.ceil(0.5 * self.range_x / res))
        win_y = int(np.ceil(0.5 * self.range_y / res))
        win_t = matchers.static_max_theta_window(
            res, self.scan_range_max, self.range_theta)
        return win_x, win_y, win_t

    def match_batch(self, grid: gridops.GridMap, store, scan_ids,
                    initial_poses) -> matchers.MatchSummary:
        """Match Q stored scans against ``grid``; returns a host
        MatchSummary with a leading Q axis."""
        win_x, win_y, win_t = self._window(grid.resolution)
        ids = np.asarray(scan_ids)
        nb = store.beam_bucket()
        dev = grid.device

        def up(arr):
            return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)

        poses = np.asarray(initial_poses, np.float32)
        summary = matchers_sweep.correlative_match_sweep(
            gridops.values(grid), grid, up(poses),
            up(store.ranges[ids][:, :nb]), up(store.angles[ids][:, :nb]),
            up(store.valid[ids][:, :nb]), up(store.min_range[ids]),
            up(store.max_range[ids]), up(store.rel_sensor_pose[ids]),
            self.scan_range_max, self.range_theta, self.usable_range_min,
            self.usable_range_max, 0.0,
            up(store.raw_beams[ids].astype(np.float32)),
            win_x=win_x, win_y=win_y, win_theta_max=win_t,
            cost_type=self.cost_type, greedy_params=self.greedy_params,
            score_gate="correlative")
        packed = matchers_sweep.pack_summary(summary).cpu().numpy()
        return unpack_summary(packed, poses)

    def match(self, grid: gridops.GridMap, store, scan_id: int,
              initial_pose) -> matchers.MatchSummary:
        """Single-query frontend match."""
        out = self.match_batch(
            grid, store, [scan_id],
            np.asarray(initial_pose, np.float32)[None, :])
        return matchers.MatchSummary(*(leaf[0] for leaf in out))
