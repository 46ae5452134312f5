"""Synthetic 2D LiDAR world simulator and CARMEN log generator.

Subset of ``my_lidar_graph_slam_tpu/io/synth.py`` (NumPy only): the
intel.clf-like world and route, the constant-speed trajectory, exact
segment ray casting, the odometry/range-noise simulator and the CARMEN
writer. With the same seed, :func:`write_carmen_log` writes a log
byte-identical to the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from my_lidar_graph_slam_tpu_torch.sensor.data import RawScan
from my_lidar_graph_slam_tpu_torch.utils import se2

WORLD_ROTATION = 0.1  # radians


def _rotate_segments(segs: np.ndarray, angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, -s], [s, c]])
    p0 = segs[:, 0:2] @ rot.T
    p1 = segs[:, 2:4] @ rot.T
    return np.concatenate([p0, p1], axis=1)


def rotate_points(pts: np.ndarray, angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, -s], [s, c]])
    return pts @ rot.T


def intel_world() -> np.ndarray:
    """A larger intel.clf-like floor: 36 x 26 m shell, two corridor loops
    around central office blocks, rooms and clutter along the walls —
    enough travel for multi-loop trajectories and several local maps."""
    segs = []

    def box(x0, y0, x1, y1):
        segs.extend([(x0, y0, x1, y0), (x1, y0, x1, y1),
                     (x1, y1, x0, y1), (x0, y1, x0, y0)])

    box(-18.0, -13.0, 18.0, 13.0)        # outer shell
    box(-13.0, -8.0, -2.0, 8.0)          # west office block
    box(2.0, -8.0, 13.0, 8.0)            # east office block
    # Doorway gaps in the blocks (interior rooms).
    segs.append((-13.0, 0.0, -11.0, 0.0))
    segs.append((-4.0, 0.0, -2.0, 0.0))
    segs.append((2.0, 0.0, 4.0, 0.0))
    segs.append((11.0, 0.0, 13.0, 0.0))
    # Wall rooms along the south side.
    segs.append((-18.0, -10.5, -15.0, -10.5))
    segs.append((-12.0, -10.5, -8.0, -10.5))
    segs.append((-8.0, -10.5, -8.0, -13.0))
    segs.append((4.0, -10.5, 9.0, -10.5))
    segs.append((9.0, -10.5, 9.0, -13.0))
    # Clutter breaking longitudinal ambiguity in every corridor lane.
    clutter = [
        (-16.2, -11.4), (-9.5, -11.6), (-0.6, -11.2), (6.4, -11.5),
        (14.8, -11.0), (16.0, -4.2), (15.6, 3.8), (14.6, 10.6),
        (7.2, 10.9), (-0.4, 11.3), (-8.8, 10.8), (-15.8, 11.1),
        (-16.2, 3.4), (-15.9, -4.6), (-0.8, -4.4), (0.6, 4.2),
        (-0.5, -0.8), (0.4, -7.9),
    ]
    for cx, cy in clutter:
        box(cx, cy, cx + 0.45, cy + 0.45)
    return _rotate_segments(np.asarray(segs, dtype=np.float64),
                            WORLD_ROTATION)


def intel_waypoints(laps: int = 2) -> np.ndarray:
    """Multi-loop route through :func:`intel_world`: a figure-eight around
    both office blocks, repeated ``laps`` times, ending with a revisit of
    the first corridor (closes several loops per lap)."""
    west = np.array([
        [-15.5, -10.5], [-1.0, -10.5], [0.0, -9.3],
        [0.0, 9.3], [-1.2, 10.5], [-14.3, 10.5], [-15.5, 9.3],
        [-15.5, -9.3], [-14.3, -10.5],
    ])
    east = np.array([
        [-14.0, -10.5], [14.3, -10.5], [15.5, -9.3],
        [15.5, 9.3], [14.3, 10.5], [1.2, 10.5], [0.0, 9.3],
        [0.0, -9.3], [1.2, -10.5],
    ])
    lap = np.concatenate([west, east], axis=0)
    wps = lap
    for _ in range(laps - 1):
        wps = np.concatenate([wps, lap], axis=0)
    wps = np.concatenate([wps, west[:3]], axis=0)
    return rotate_points(wps, WORLD_ROTATION)


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

    # Tangent headings, smoothed to bound the turn rate.
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
    dx = np.cos(angles)[:, None]                      # [N, 1]
    dy = np.sin(angles)[:, None]
    p0x, p0y = segments[None, :, 0], segments[None, :, 1]  # [1, M]
    ex = segments[None, :, 2] - p0x
    ey = segments[None, :, 3] - p0y
    rx = p0x - ox
    ry = p0y - oy
    denom = dx * ey - dy * ex                          # cross(d, e)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (rx * ey - ry * ex) / denom                # along ray
        s = (rx * dy - ry * dx) / denom                # along segment
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
    odom_drift_per_m: float = 0.004      # systematic translational drift
    odom_theta_drift_per_m: float = 0.004
    odom_noise_xy: float = 0.001
    odom_noise_theta: float = 0.0015
    step: float = 0.1                    # meters between simulated scans
    seed: int = 0
    odom_scale: float = 1.0              # multiplicative translation error
    odom_slip_prob: float = 0.0          # per-step P(slip event)
    odom_slip_mag: float = 0.0           # meters of phantom translation


def simulate(world: np.ndarray, waypoints: np.ndarray,
             config: SimConfig | None = None
             ) -> Tuple[List[RawScan], np.ndarray]:
    """Simulate scans along the route. Returns (scans, true_poses [T, 3])."""
    cfg = config or SimConfig()
    rng = np.random.default_rng(cfg.seed)
    poses = trajectory_from_waypoints(waypoints, step=cfg.step)

    beam_angles = np.linspace(-cfg.fov / 2.0, cfg.fov / 2.0, cfg.num_beams)

    scans: List[RawScan] = []
    odom = poses[0].copy()
    for t in range(len(poses)):
        true_pose = poses[t]
        # Exact ranges + noise; sensor frame == robot frame.
        world_angles = true_pose[2] + beam_angles
        ranges = raycast_segments(true_pose[:2], world_angles, world,
                                  cfg.max_range)
        noisy = np.where(
            ranges < cfg.max_range,
            np.maximum(ranges + rng.normal(0.0, cfg.range_noise,
                                           ranges.shape), 0.0),
            cfg.max_range)

        # Odometry: integrate true relative motion with drift + noise.
        if t > 0:
            rel = se2.inverse_compound_np(poses[t - 1], true_pose)
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
            odom = se2.compound_np(odom, rel)

        scans.append(RawScan(
            sensor_id="FLASER",
            timestamp=0.1 * t,
            odom_pose=odom.copy(),
            velocity=np.zeros(3),
            rel_sensor_pose=np.zeros(3),
            min_range=0.0,
            max_range=cfg.max_range,
            min_angle=float(beam_angles[0]),
            max_angle=float(beam_angles[-1]),
            angles=beam_angles.copy(),
            ranges=noisy,
        ))
    return scans, poses


def write_carmen_log(path: str, scans: List[RawScan],
                     max_range: float = 20.0) -> None:
    """Write scans as old-format FLASER records plus the laser PARAMs
    (angles derived from the PARAM geometry, carmen_reader.cpp:354-377)."""
    incr = scans[0].angles[1] - scans[0].angles[0]
    with open(path, "w") as f:
        f.write("PARAM Laser.MaxRange %.2f\n" % max_range)
        f.write("PARAM Laser.MinAngle %.6f\n" % scans[0].min_angle)
        f.write("PARAM Laser.AngleIncrement %.9f\n" % incr)
        for s in scans:
            parts = ["FLASER", str(s.num_beams)]
            parts.extend("%.3f" % r for r in s.ranges)
            # Sensor frame == robot frame in the simulator.
            parts.extend("%.6f" % v for v in s.odom_pose)
            parts.extend("%.6f" % v for v in s.odom_pose)
            parts.extend(["%.6f" % s.timestamp, "synth",
                          "%.6f" % s.timestamp])
            f.write(" ".join(parts) + "\n")
