"""Scan preprocessing: interpolation and accumulation.

Copy of ``my_lidar_graph_slam_tpu/models/preprocess.py`` (NumPy only).

Host-side ingest stage (NumPy): runs once per raw scan at O(beams) cost with
data-dependent output sizes, which is exactly the kind of ragged sequential
work that belongs on the host side of the host/device seam. The fixed-width
tensors it emits are what the device kernels consume.

Reference parity: ``ScanInterpolator::Interpolate`` (scan_interpolator.cpp:
10-99) and ``ScanAccumulator`` (scan_accumulator.cpp:12-93).
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np

from my_lidar_graph_slam_tpu_torch.sensor.data import RawScan
from my_lidar_graph_slam_tpu_torch.utils import se2


@dataclasses.dataclass
class ScanInterpolator:
    """Resample scan points to uniform spacing along the scan polyline.

    ``dist_scans``: target spacing between adjacent points;
    ``dist_threshold_empty``: gaps at least this long are considered empty
    space and are not filled (scan_interpolator.cpp:39-68).
    """

    dist_scans: float = 0.05
    dist_threshold_empty: float = 0.25

    def __call__(self, scan: RawScan) -> RawScan:
        n = scan.num_beams
        assert n > 0
        px = scan.ranges * np.cos(scan.angles)
        py = scan.ranges * np.sin(scan.angles)

        out_x = [px[0]]
        out_y = [py[0]]
        prev_x, prev_y = px[0], py[0]
        accum = 0.0
        i = 1
        while i < n:
            x, y = px[i], py[i]
            dist = float(np.hypot(x - prev_x, y - prev_y))
            if accum + dist < self.dist_scans:
                # Adjacent points too close: skip without emitting.
                accum += dist
                prev_x, prev_y = x, y
                i += 1
            elif accum + dist >= self.dist_threshold_empty:
                # Gap considered empty: emit the endpoint, no interpolation.
                out_x.append(x)
                out_y.append(y)
                prev_x, prev_y = x, y
                accum = 0.0
                i += 1
            else:
                # Emit an interpolated point and re-process this segment.
                ratio = (self.dist_scans - accum) / dist
                ix = (x - prev_x) * ratio + prev_x
                iy = (y - prev_y) * ratio + prev_y
                out_x.append(ix)
                out_y.append(iy)
                prev_x, prev_y = ix, iy
                accum = 0.0

        out_x = np.asarray(out_x)
        out_y = np.asarray(out_y)
        ranges = np.hypot(out_x, out_y)
        angles = np.arctan2(out_y, out_x)

        return RawScan(
            sensor_id=scan.sensor_id,
            timestamp=scan.timestamp,
            odom_pose=scan.odom_pose,
            velocity=scan.velocity,
            rel_sensor_pose=scan.rel_sensor_pose,
            min_range=scan.min_range,
            max_range=scan.max_range,
            min_angle=float(angles[0]),
            max_angle=float(angles[-1]),
            angles=angles,
            ranges=ranges,
        )


@dataclasses.dataclass
class ScanAccumulator:
    """Concatenate recent scans re-projected into the latest sensor frame.

    Uses the law-of-cosines re-projection of the reference
    (scan_accumulator.cpp:44-77).
    """

    num_accumulated_scans: int = 3

    def __post_init__(self):
        assert self.num_accumulated_scans > 0
        self._scans: collections.deque[RawScan] = collections.deque()

    def append(self, scan: RawScan) -> None:
        self._scans.appendleft(scan)

    def concatenated(self) -> RawScan:
        assert self._scans
        latest = self._scans.popleft()
        latest_sensor_pose = se2.compound_np(
            latest.odom_pose, latest.rel_sensor_pose)

        if not self._scans:
            return latest

        ranges = [latest.ranges]
        angles = [latest.angles]
        num = min(len(self._scans), self.num_accumulated_scans - 1)
        for idx in range(num):
            prev = self._scans[idx]
            sensor_pose = se2.compound_np(prev.odom_pose, prev.rel_sensor_pose)
            rel = se2.inverse_compound_np(sensor_pose, latest_sensor_pose)
            r, a = prev.ranges, prev.angles
            s, c = np.sin(a), np.cos(a)
            new_r = np.sqrt(
                r * r + rel[0] * rel[0] + rel[1] * rel[1]
                - 2.0 * r * (rel[0] * c + rel[1] * s))
            sx = r * c - rel[0]
            sy = r * s - rel[1]
            new_a = se2.normalize_angle_np(np.arctan2(sy, sx) - rel[2])
            ranges.append(new_r)
            angles.append(new_a)
        self._scans.clear()

        return RawScan(
            sensor_id=latest.sensor_id,
            timestamp=latest.timestamp,
            odom_pose=latest.odom_pose,
            velocity=latest.velocity,
            rel_sensor_pose=latest.rel_sensor_pose,
            min_range=latest.min_range,
            max_range=latest.max_range,
            min_angle=latest.min_angle,
            max_angle=latest.max_angle,
            angles=np.concatenate(angles),
            ranges=np.concatenate(ranges),
        )
