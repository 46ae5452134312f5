"""Sensor data containers.

Copy of ``my_lidar_graph_slam_tpu/sensor/data.py`` (NumPy only).

Host side: :class:`RawScan` / :class:`OdometryData` mirror the reference's
``Sensor::ScanData`` / ``Sensor::OdometryData`` (sensor_data.hpp:37-158) as
plain NumPy records with variable beam counts.

Device side: :class:`ScanBatch` is the fixed-width tensor form — ranges /
angles padded to a static beam capacity with a validity mask. Fixed widths are
what make every hot loop batchable on TPU (replacing the reference's per-beam
``continue`` filtering, e.g. score_function_pixel_accurate.cpp:40-41, with
masking).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np


@dataclasses.dataclass
class OdometryData:
    """Odometry record (sensor_data.hpp:37-62)."""

    sensor_id: str
    timestamp: float
    pose: np.ndarray      # [3] world-frame odometry pose
    velocity: np.ndarray  # [3]


@dataclasses.dataclass
class RawScan:
    """One LiDAR scan with metadata (sensor_data.hpp:65-158)."""

    sensor_id: str
    timestamp: float
    odom_pose: np.ndarray          # [3]
    velocity: np.ndarray           # [3]
    rel_sensor_pose: np.ndarray    # [3] sensor pose in the robot frame
    min_range: float
    max_range: float
    min_angle: float
    max_angle: float
    angles: np.ndarray             # [N]
    ranges: np.ndarray             # [N]

    @property
    def num_beams(self) -> int:
        return int(self.ranges.shape[0])

    def hit_points(self, sensor_pose: np.ndarray) -> np.ndarray:
        """Beam endpoints in world frame (sensor_data.hpp:161-173)."""
        a = sensor_pose[2] + self.angles
        return np.stack([
            sensor_pose[0] + self.ranges * np.cos(a),
            sensor_pose[1] + self.ranges * np.sin(a),
        ], axis=-1)


class ScanBatch(NamedTuple):
    """Fixed-width device form of one or more scans.

    All arrays share a leading batch axis ``K`` (use ``K=1`` for a single
    scan) and a static beam capacity ``NB``.
    """

    ranges: np.ndarray   # f32[K, NB]
    angles: np.ndarray   # f32[K, NB]
    valid: np.ndarray    # bool[K, NB]  (beam slot holds real data)
    min_range: np.ndarray  # f32[K] scan-reported min range
    max_range: np.ndarray  # f32[K] scan-reported max range
    rel_sensor_pose: np.ndarray  # f32[K, 3]

    @property
    def capacity(self) -> int:
        return int(self.ranges.shape[-1])


def pack_scan(scan: RawScan, capacity: int) -> ScanBatch:
    """Pack one raw scan into a fixed-width single-element batch."""
    return pack_scans([scan], capacity)


def pack_scans(scans: Sequence[RawScan], capacity: int) -> ScanBatch:
    """Pack raw scans into a fixed-width batch, truncating beyond capacity."""
    k = len(scans)
    ranges = np.zeros((k, capacity), np.float32)
    angles = np.zeros((k, capacity), np.float32)
    valid = np.zeros((k, capacity), bool)
    min_r = np.zeros((k,), np.float32)
    max_r = np.zeros((k,), np.float32)
    rel = np.zeros((k, 3), np.float32)
    for i, s in enumerate(scans):
        n = min(s.num_beams, capacity)
        ranges[i, :n] = s.ranges[:n]
        angles[i, :n] = s.angles[:n]
        valid[i, :n] = True
        min_r[i] = s.min_range
        max_r[i] = s.max_range
        rel[i] = s.rel_sensor_pose
    return ScanBatch(ranges, angles, valid, min_r, max_r, rel)
