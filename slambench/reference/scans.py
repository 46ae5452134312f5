"""The reference's own reading of the log and of each keyframe's scan.

The reference takes nothing the program made: it parses the CARMEN text
that the benchmark wrote (old-format FLASER records under laser PARAMs,
as ``carmen_reader.cpp:319-394`` reads them) and resamples each scan with
its own copy of the scan interpolator. The interpolator is a frozen copy
of ``ScanInterpolator`` in ``my_lidar_graph_slam_tpu_torch/models/
preprocess.py`` at commit 8e18ecb (scan_interpolator.cpp:10-99). NumPy
only.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np


class Scan(NamedTuple):
    """One laser record as the reference reads it."""

    timestamp: float
    odom_pose: np.ndarray      # [3] float64
    rel_sensor_pose: np.ndarray  # [3] float64, sensor pose in robot frame
    min_range: float
    max_range: float
    angles: np.ndarray         # [N] float64
    ranges: np.ndarray         # [N] float64


def _inverse_compound(start, end):
    s, c = np.sin(start[2]), np.cos(start[2])
    dx, dy = end[0] - start[0], end[1] - start[1]
    return np.array([c * dx + s * dy, -s * dx + c * dy, end[2] - start[2]])


def parse_flaser(text: str) -> List[Scan]:
    """Every FLASER record of ``text``, in order."""
    params = {}
    scans: List[Scan] = []
    for line in text.splitlines():
        tok = line.split()
        if not tok:
            continue
        if tok[0] == "PARAM" and len(tok) >= 3:
            params[tok[1]] = tok[2]
            continue
        if tok[0] != "FLASER":
            continue
        num = int(tok[1])
        ranges = np.array([float(v) for v in tok[2:2 + num]])
        base = 2 + num
        laser = np.array([float(v) for v in tok[base:base + 3]])
        robot = np.array([float(v) for v in tok[base + 3:base + 6]])
        ts = float(tok[base + 6])
        incr = float(params["Laser.AngleIncrement"])
        min_angle = float(params["Laser.MinAngle"])
        scans.append(Scan(
            timestamp=ts, odom_pose=robot,
            rel_sensor_pose=_inverse_compound(robot, laser),
            min_range=float(params.get("Laser.MinRange", 0.0)),
            max_range=float(params["Laser.MaxRange"]),
            angles=min_angle + incr * np.arange(num), ranges=ranges))
    return scans


def interpolate(scan: Scan, dist_scans: float,
                dist_threshold_empty: float) -> Scan:
    """Resample the scan points to ``dist_scans`` spacing along the scan
    polyline; gaps of ``dist_threshold_empty`` or more stay empty."""
    n = len(scan.ranges)
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
        if accum + dist < dist_scans:
            accum += dist
            prev_x, prev_y = x, y
            i += 1
        elif accum + dist >= dist_threshold_empty:
            out_x.append(x)
            out_y.append(y)
            prev_x, prev_y = x, y
            accum = 0.0
            i += 1
        else:
            ratio = (dist_scans - accum) / dist
            ix = (x - prev_x) * ratio + prev_x
            iy = (y - prev_y) * ratio + prev_y
            out_x.append(ix)
            out_y.append(iy)
            prev_x, prev_y = ix, iy
            accum = 0.0
    out_x = np.asarray(out_x)
    out_y = np.asarray(out_y)
    return scan._replace(ranges=np.hypot(out_x, out_y),
                         angles=np.arctan2(out_y, out_x))


class ScanBook:
    """The reference's scans, by raw log index, interpolated on first use
    as the frontend configuration asks."""

    def __init__(self, raw: List[Scan], interpolator: dict):
        self.raw = raw
        self.interpolator = interpolator
        self._cache = {}

    def scan(self, raw_index: int) -> Scan:
        if raw_index not in self._cache:
            s = self.raw[raw_index]
            if self.interpolator:
                s = interpolate(s, **self.interpolator)
            self._cache[raw_index] = s
        return self._cache[raw_index]
