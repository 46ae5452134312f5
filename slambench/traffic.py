"""The traffic generator: a synthetic floor, a route, a simulated laser and
odometry, written as a CARMEN log.

Frozen copy of ``my_lidar_graph_slam_tpu_torch/io/synth.py`` at commit
8e18ecb (``trajectory_from_waypoints``, ``raycast_segments``,
``SimConfig``, ``simulate``, ``write_carmen_log`` in its ``flaser``
format, and the rotation of ``intel_world``/``aces_world`` and their
waypoints), NumPy only, so that later changes to the program cannot move
the yardstick. The floors themselves are data: a configuration's
``site`` holds the boxes, segments, clutter and route that
``intel_world``/``intel_waypoints`` and ``aces_world``/``aces_waypoints``
built in code, and :func:`site_world` and :func:`site_waypoints` build
them again in the same order. With the same site and seed every array
and every byte of the log equals that commit's.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Tuple

import numpy as np


class SimScan(NamedTuple):
    """One simulated scan: what ``write_carmen_log`` needs of a RawScan."""

    timestamp: float
    odom_pose: np.ndarray
    min_angle: float
    angles: np.ndarray
    ranges: np.ndarray


def _compound(start, diff):
    s, c = np.sin(start[..., 2]), np.cos(start[..., 2])
    return np.stack([
        c * diff[..., 0] - s * diff[..., 1] + start[..., 0],
        s * diff[..., 0] + c * diff[..., 1] + start[..., 1],
        start[..., 2] + diff[..., 2],
    ], axis=-1)


def _inverse_compound(start, end):
    s, c = np.sin(start[..., 2]), np.cos(start[..., 2])
    dx = end[..., 0] - start[..., 0]
    dy = end[..., 1] - start[..., 1]
    return np.stack([c * dx + s * dy, -s * dx + c * dy,
                     end[..., 2] - start[..., 2]], axis=-1)


def _rotate_segments(segs: np.ndarray, angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, -s], [s, c]])
    p0 = segs[:, 0:2] @ rot.T
    p1 = segs[:, 2:4] @ rot.T
    return np.concatenate([p0, p1], axis=1)


def _rotate_points(pts: np.ndarray, angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, -s], [s, c]])
    return pts @ rot.T


def site_world(site: dict) -> np.ndarray:
    """Wall segments [M, 4] of a site: its ``boxes`` (four walls each),
    then its ``segments``, then a box of side ``clutter_size`` at each
    ``clutter`` corner, all rotated by ``rotation`` radians."""
    segs = []

    def box(x0, y0, x1, y1):
        segs.extend([(x0, y0, x1, y0), (x1, y0, x1, y1),
                     (x1, y1, x0, y1), (x0, y1, x0, y0)])

    for b in site["boxes"]:
        box(*b)
    segs.extend(tuple(s) for s in site["segments"])
    size = site["clutter_size"]
    for cx, cy in site["clutter"]:
        box(cx, cy, cx + size, cy + size)
    return _rotate_segments(np.asarray(segs, dtype=np.float64),
                            site["rotation"])


def site_waypoints(site: dict, laps: int) -> np.ndarray:
    """The route: the site's ``lap`` repeated ``laps`` times, then its
    first ``closing`` points again, rotated like the walls."""
    lap = np.asarray(site["lap"], dtype=np.float64)
    wps = np.concatenate([lap] * laps + [lap[:site["closing"]]], axis=0)
    return _rotate_points(wps, site["rotation"])


def trajectory_from_waypoints(waypoints: np.ndarray,
                              step: float = 0.1) -> np.ndarray:
    """Constant-speed poses [T, 3] along the waypoint polyline.

    Heading follows the path tangent with smoothing at corners.
    """
    pts: List[np.ndarray] = []
    for i in range(len(waypoints) - 1):
        p0, p1 = waypoints[i], waypoints[i + 1]
        d = np.linalg.norm(p1 - p0)
        n = max(int(np.ceil(d / step)), 1)
        for j in range(n):
            pts.append(p0 + (p1 - p0) * (j / n))
    pts.append(waypoints[-1])
    pts_arr = np.asarray(pts)

    diffs = np.diff(pts_arr, axis=0)
    headings = np.arctan2(diffs[:, 1], diffs[:, 0])
    headings = np.concatenate([headings, headings[-1:]])
    unwrapped = np.unwrap(headings)
    win = 15
    kernel = np.ones(win) / win
    pad = np.pad(unwrapped, (win // 2, win // 2), mode="edge")
    smooth = np.convolve(pad, kernel, mode="valid")
    return np.concatenate([pts_arr, smooth[:, None]], axis=1)


def raycast_segments(origin: np.ndarray, angles: np.ndarray,
                     segments: np.ndarray, max_range: float) -> np.ndarray:
    """Exact ranges [N] from ``origin`` along world-frame ``angles``."""
    ox, oy = origin[0], origin[1]
    dx = np.cos(angles)[:, None]
    dy = np.sin(angles)[:, None]
    p0x, p0y = segments[None, :, 0], segments[None, :, 1]
    ex = segments[None, :, 2] - p0x
    ey = segments[None, :, 3] - p0y
    rx = p0x - ox
    ry = p0y - oy
    denom = dx * ey - dy * ex
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (rx * ey - ry * ex) / denom
        s = (rx * dy - ry * dx) / denom
    hit = (np.abs(denom) > 1e-12) & (t > 1e-9) & (s >= 0.0) & (s <= 1.0)
    t = np.where(hit, t, np.inf)
    dist = t.min(axis=1)
    return np.minimum(dist, max_range)


@dataclasses.dataclass
class SimConfig:
    num_beams: int = 181
    fov: float = np.pi
    max_range: float = 20.0
    range_noise: float = 0.01
    odom_drift_per_m: float = 0.004
    odom_theta_drift_per_m: float = 0.004
    odom_noise_xy: float = 0.001
    odom_noise_theta: float = 0.0015
    step: float = 0.1
    seed: int = 0
    odom_scale: float = 1.0
    odom_slip_prob: float = 0.0
    odom_slip_mag: float = 0.0


def simulate(world: np.ndarray, waypoints: np.ndarray, config: SimConfig
             ) -> Tuple[List[SimScan], np.ndarray]:
    """Simulate scans along the route. Returns (scans, true_poses [T, 3]);
    timestamps are 0.1 s apart (a 10 Hz scanner)."""
    cfg = config
    rng = np.random.default_rng(cfg.seed)
    poses = trajectory_from_waypoints(waypoints, step=cfg.step)
    beam_angles = np.linspace(-cfg.fov / 2.0, cfg.fov / 2.0, cfg.num_beams)

    scans: List[SimScan] = []
    odom = poses[0].copy()
    for t in range(len(poses)):
        true_pose = poses[t]
        world_angles = true_pose[2] + beam_angles
        ranges = raycast_segments(true_pose[:2], world_angles, world,
                                  cfg.max_range)
        noisy = np.where(
            ranges < cfg.max_range,
            np.maximum(ranges + rng.normal(0.0, cfg.range_noise,
                                           ranges.shape), 0.0),
            cfg.max_range)
        if t > 0:
            rel = _inverse_compound(poses[t - 1], true_pose)
            d = float(np.hypot(rel[0], rel[1]))
            rel[0] = cfg.odom_scale * rel[0] + cfg.odom_drift_per_m * d + \
                rng.normal(0.0, cfg.odom_noise_xy)
            rel[1] = cfg.odom_scale * rel[1] + rng.normal(
                0.0, cfg.odom_noise_xy)
            rel[2] += cfg.odom_theta_drift_per_m * d + rng.normal(
                0.0, cfg.odom_noise_theta)
            if cfg.odom_slip_prob > 0.0 and \
                    rng.random() < cfg.odom_slip_prob:
                rel[0] += cfg.odom_slip_mag
            odom = _compound(odom, rel)
        scans.append(SimScan(timestamp=0.1 * t, odom_pose=odom.copy(),
                             min_angle=float(beam_angles[0]),
                             angles=beam_angles.copy(), ranges=noisy))
    return scans, poses


def carmen_text(scans: List[SimScan], max_range: float = 20.0) -> str:
    """The log as ``write_carmen_log(..., fmt="flaser")`` writes it: laser
    PARAMs, then one old-format FLASER record per scan."""
    incr = scans[0].angles[1] - scans[0].angles[0]
    lines = ["PARAM Laser.MaxRange %.2f" % max_range,
             "PARAM Laser.MinAngle %.6f" % scans[0].min_angle,
             "PARAM Laser.AngleIncrement %.9f" % incr]
    for s in scans:
        parts = ["FLASER", str(len(s.ranges))]
        parts.extend("%.3f" % r for r in s.ranges)
        parts.extend("%.6f" % v for v in s.odom_pose)
        parts.extend("%.6f" % v for v in s.odom_pose)
        parts.extend(["%.6f" % s.timestamp, "synth", "%.6f" % s.timestamp])
        lines.append(" ".join(parts))
    return "\n".join(lines) + "\n"


def make_log(site: dict, sensor: dict, laps: int, seed: int
             ) -> Tuple[str, np.ndarray, np.ndarray]:
    """The cell's log text, the true poses [T, 3] and their timestamps,
    from a configuration's ``site`` and ``sensor`` and the cell's laps."""
    cfg = SimConfig(seed=seed, **sensor)
    scans, poses = simulate(site_world(site), site_waypoints(site, laps),
                            cfg)
    times = np.array([s.timestamp for s in scans])
    return carmen_text(scans, max_range=cfg.max_range), poses, times
