"""Synthetic 2D LiDAR world simulator and CARMEN log generator.

Counterpart of ``my_lidar_graph_slam_tpu/io/synth.py`` (NumPy only): the
segment worlds (the two-room default, intel-, aces- and killian-like
floors, the mini loop) and their routes, the constant-speed trajectory,
exact segment ray casting, the odometry/range-noise simulator with its
adversarial profiles, and the CARMEN writer in its three record families.
With the same seed every array equals the JAX package's and
:func:`write_carmen_log` writes the same bytes. :func:`ring_graph` builds
the noisy ring pose graph of the JAX package's solver tests
(``tests/test_optimizer_solvers.py::make_ring``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from my_lidar_graph_slam_tpu_torch.models.pose_graph import PoseGraph
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


def default_world() -> np.ndarray:
    """Wall segments [M, 4] as (x0, y0, x1, y1): a two-room office loop."""
    segs = []

    def box(x0, y0, x1, y1):
        segs.extend([(x0, y0, x1, y0), (x1, y0, x1, y1),
                     (x1, y1, x0, y1), (x0, y1, x0, y0)])

    # Outer shell 22 x 16 m.
    box(-11.0, -8.0, 11.0, 8.0)
    # Central block creating a loop corridor.
    box(-6.0, -3.0, 6.0, 3.0)
    # Rooms along the south wall.
    segs.append((-11.0, -5.5, -8.5, -5.5))
    segs.append((-7.0, -5.5, -4.0, -5.5))
    segs.append((-4.0, -5.5, -4.0, -8.0))
    # Pillar-ish features for matchability in the corridor: every few meters
    # each corridor lane has a feature breaking the longitudinal ambiguity.
    box(8.0, -6.5, 8.8, -5.7)
    box(-9.2, 4.8, -8.4, 5.6)
    box(7.6, 4.6, 8.4, 5.4)
    box(-5.8, -6.6, -5.4, -6.2)
    box(0.0, -7.2, 0.4, -6.8)
    box(4.4, -6.9, 4.8, -6.5)
    box(-9.6, -0.4, -9.2, 0.0)
    box(9.2, -0.6, 9.6, -0.2)
    box(-2.4, 6.6, -2.0, 7.0)
    box(3.0, 6.4, 3.4, 6.8)
    segs_arr = np.asarray(segs, dtype=np.float64)
    # Rotate the whole world a few degrees: axis-aligned walls whose
    # coordinates are exact multiples of the map resolution share one
    # quantization phase, which makes the correlative score surface a
    # coherent sawtooth whose noise rectification drags the matcher
    # systematically backward — an artifact real buildings don't exhibit.
    return _rotate_segments(segs_arr, WORLD_ROTATION)


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


def aces_world() -> np.ndarray:
    """An aces3-like building: one large loop corridor around a solid
    core with long straight segments and sparse features — the workload
    shape that exercises the BRANCH-AND-BOUND frontend matcher (BASELINE
    config 2): long corridors make the correlative window ambiguous along
    the corridor axis, so frontend matching leans on the wide-window BB
    search the aces log is traditionally run with."""
    segs = []

    def box(x0, y0, x1, y1):
        segs.extend([(x0, y0, x1, y0), (x1, y0, x1, y1),
                     (x1, y1, x0, y1), (x0, y1, x0, y0)])

    box(-28.0, -20.0, 28.0, 20.0)        # outer shell
    box(-22.0, -14.0, 22.0, 14.0)        # solid core (atrium block)
    # Door alcoves along the corridor plus door-frame clutter at
    # real-building spacing (~6-8 m): the real aces3 corridors carry
    # door frames, columns and furniture at that cadence — without them
    # the along-corridor score is a plateau and ANY correlative/BB
    # matcher (the reference's included) slips systematically toward the
    # first-maximum tie-break end of the window.
    segs.append((-22.0, -16.8, -19.0, -16.8))
    segs.append((5.0, -16.8, 8.0, -16.8))
    segs.append((22.0, 8.0, 24.6, 8.0))
    segs.append((-24.6, -6.0, -22.0, -6.0))
    segs.append((-8.0, 16.8, -5.0, 16.8))
    segs.append((16.0, 16.8, 19.0, 16.8))
    clutter = [(-25.8, -18.2), (12.2, -18.4), (25.6, -10.2), (25.4, 12.8),
               (2.4, 17.6), (-18.6, 17.9), (-25.7, 2.2), (-12.4, -18.0),
               (-19.4, -18.3), (-5.6, -18.1), (5.8, -18.3), (19.2, -18.2),
               (25.7, -17.4), (25.5, -3.8), (25.8, 4.6), (25.4, 17.2),
               (18.4, 17.8), (10.2, 17.5), (-5.2, 17.8), (-12.8, 17.6),
               (-25.4, 17.5), (-25.6, 9.8), (-25.8, -10.4), (-25.5, -17.8),
               (-22.3, -14.6), (22.2, -14.4), (22.4, 14.2), (-22.1, 14.4)]
    for cx, cy in clutter:
        box(cx, cy, cx + 0.4, cy + 0.4)
    return _rotate_segments(np.asarray(segs, dtype=np.float64),
                            WORLD_ROTATION)


def aces_waypoints(laps: int = 2) -> np.ndarray:
    """Laps of the aces-like loop corridor, with chamfered corners."""
    lap = np.array([
        [-25.0, -17.0], [23.8, -17.0], [25.0, -15.8],
        [25.0, 15.8], [23.8, 17.0],
        [-23.8, 17.0], [-25.0, 15.8],
        [-25.0, -15.8], [-23.8, -17.0],
    ])
    wps = lap
    for _ in range(laps - 1):
        wps = np.concatenate([wps, lap], axis=0)
    wps = np.concatenate([wps, lap[:2]], axis=0)
    return rotate_points(wps, WORLD_ROTATION)


def killian_world() -> np.ndarray:
    """An mit-killian-like multi-wing floor: ~90 x 64 m of long
    interconnected corridors forming several nested loops — the
    LARGE-SCALE workload (BASELINE config 4: thousands of scans, many
    submaps, loop closures across distant wings; the shape the
    mesh-sharded backend pipeline is sized for)."""
    segs = []

    def box(x0, y0, x1, y1):
        segs.extend([(x0, y0, x1, y0), (x1, y0, x1, y1),
                     (x1, y1, x0, y1), (x0, y1, x0, y0)])

    box(-45.0, -32.0, 45.0, 32.0)        # outer shell
    # Three solid building blocks -> two N-S connector corridors plus the
    # outer loop ("infinite corridor" along the south face).
    box(-39.0, -26.0, -12.0, 26.0)       # west block
    box(-6.0, -26.0, 21.0, 26.0)         # center block
    box(27.0, -26.0, 39.0, 26.0)         # east block
    # E-W cut corridors through the west and center blocks.
    segs.append((-39.0, 3.0, -12.0, 3.0))
    segs.append((-39.0, 9.0, -12.0, 9.0))
    segs.append((-6.0, -9.0, 21.0, -9.0))
    segs.append((-6.0, -3.0, 21.0, -3.0))
    # Alcoves + clutter breaking corridor ambiguity at intervals.
    alcoves = [
        (-42.6, -29.0), (-28.4, -29.2), (-9.2, -29.0), (8.6, -29.3),
        (24.2, -29.1), (42.1, -29.2), (42.3, -12.4), (42.2, 8.6),
        (42.4, 28.8), (24.4, 29.1), (7.8, 28.7), (-9.4, 29.2),
        (-27.6, 28.9), (-42.8, 29.1), (-42.5, 10.2), (-42.7, -10.8),
        (-24.8, 5.6), (-18.2, 6.4), (-33.0, 6.1), (3.2, -6.3),
        (9.8, -5.7), (16.4, -6.2), (-9.1, -12.2), (-9.3, 14.6),
        (23.9, 12.2), (24.1, -14.8),
    ]
    for cx, cy in alcoves:
        box(cx, cy, cx + 0.5, cy + 0.5)
    return _rotate_segments(np.asarray(segs, dtype=np.float64),
                            WORLD_ROTATION)


def killian_waypoints(laps: int = 1) -> np.ndarray:
    """A long multi-loop route: outer loop, both cut corridors, both
    connector corridors, then a partial outer revisit — several hundred
    meters per lap, closing loops across every wing."""
    outer = np.array([
        [-42.0, -29.0], [40.8, -29.0], [42.0, -27.8],
        [42.0, 27.8], [40.8, 29.0],
        [-40.8, 29.0], [-42.0, 27.8], [-42.0, -27.8], [-40.8, -29.0],
    ])
    west_cut = np.array([
        [-30.0, -29.0], [-40.5, -29.0], [-42.0, -27.0], [-42.0, 4.5],
        [-40.5, 6.0], [-13.5, 6.0], [-12.0, 4.5], [-12.0, -27.5],
        [-13.5, -29.0],
    ])
    center_cut = np.array([
        [-10.0, -29.0], [-7.5, -29.0], [-6.0, -27.5], [-6.0, -7.5],
        [-4.5, -6.0], [19.5, -6.0], [21.0, -7.5], [21.0, -27.5],
        [19.5, -29.0], [0.0, -29.0],
    ])
    lap = np.concatenate([outer, west_cut, center_cut], axis=0)
    wps = lap
    for _ in range(laps - 1):
        wps = np.concatenate([wps, lap], axis=0)
    wps = np.concatenate([wps, outer[:3]], axis=0)
    return rotate_points(wps, WORLD_ROTATION)


def mini_world() -> np.ndarray:
    """A 12 x 8 m single-corridor office loop — small enough for
    interpret-mode CI tests at 0.1 m resolution."""
    segs = []

    def box(x0, y0, x1, y1):
        segs.extend([(x0, y0, x1, y0), (x1, y0, x1, y1),
                     (x1, y1, x0, y1), (x0, y1, x0, y0)])

    box(-6.0, -4.0, 6.0, 4.0)       # outer shell
    box(-3.0, -1.5, 3.0, 1.5)       # central block -> loop corridor
    # Corner features breaking longitudinal corridor ambiguity.
    box(4.8, -3.6, 5.2, -3.2)
    box(-5.2, 3.0, -4.8, 3.4)
    box(-0.2, -3.8, 0.2, -3.4)
    box(0.6, 3.2, 1.0, 3.6)
    return _rotate_segments(np.asarray(segs, np.float64), WORLD_ROTATION)


def mini_loop_waypoints() -> np.ndarray:
    """One chamfered lap of :func:`mini_world` plus a revisit leg."""
    wps = np.array([
        [-4.5, -2.7], [3.8, -2.7], [4.5, -2.0],
        [4.5, 2.0], [3.8, 2.7],
        [-3.8, 2.7], [-4.5, 2.0],
        [-4.5, -1.9], [-3.8, -2.6], [0.0, -2.6], [2.0, -2.6],
    ])
    return rotate_points(wps, WORLD_ROTATION)


def loop_waypoints() -> np.ndarray:
    """A chamfered rectangular loop through :func:`default_world`'s corridor.

    Corners are cut diagonally: real robots round corners, and sharp
    90-degree turns with a forward-only FOV leave consecutive keyframe scans
    with almost no overlap — a failure mode for any correlative matcher,
    the reference included.
    """
    wps = np.array([
        [-8.5, -5.0], [7.3, -5.0], [8.5, -3.8],
        [8.5, 3.8], [7.3, 5.0],
        [-7.3, 5.0], [-8.5, 3.8],
        [-8.5, -3.6], [-7.3, -4.8], [0.0, -4.8],
    ])
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


# Three adversarial odometry profiles (the JAX package records the ATE of
# each in BASELINE.md).
ADVERSARIAL_PROFILES = {
    # 3% wheel-scale error + strong heading bias: odometry consistently
    # overshoots and curls.
    "bias": dict(odom_scale=1.03, odom_theta_drift_per_m=0.012),
    # 5x the default systematic drift on every axis.
    "drift": dict(odom_drift_per_m=0.02, odom_theta_drift_per_m=0.02),
    # Discrete slip events: 5% of steps add 25 cm of phantom forward
    # translation the robot never made.
    "slip": dict(odom_slip_prob=0.05, odom_slip_mag=0.25),
}


def simulate(world: np.ndarray | None = None,
             waypoints: np.ndarray | None = None,
             config: SimConfig | None = None
             ) -> Tuple[List[RawScan], np.ndarray]:
    """Simulate scans along the route (by default :func:`loop_waypoints`
    through :func:`default_world`). Returns (scans, true_poses [T, 3])."""
    cfg = config or SimConfig()
    rng = np.random.default_rng(cfg.seed)
    world = default_world() if world is None else world
    waypoints = loop_waypoints() if waypoints is None else waypoints
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
                     max_range: float = 20.0,
                     fmt: str = "flaser") -> None:
    """Write scans in one of the CARMEN record families the reader
    supports (carmen_reader.cpp:506-530):

    * ``"flaser"`` — old-format FLASER records plus laser PARAMs
      (angles derived from the PARAM geometry, carmen_reader.cpp:354-377).
    * ``"robotlaser"`` — new-format ROBOTLASER1 records carrying the
      laser geometry and the laser/robot poses inline
      (carmen_reader.cpp:239-316).
    * ``"rawlaser"`` — new-format RAWLASER1 records (geometry + ranges,
      NO pose — the reference leaves the odometry pose zero,
      carmen_reader.cpp:163-236) interleaved with ODOM records carrying
      the robot odometry (carmen_reader.cpp:135-160).
    """
    incr = scans[0].angles[1] - scans[0].angles[0]
    fov = incr * (scans[0].num_beams - 1)
    with open(path, "w") as f:
        if fmt == "flaser":
            f.write("PARAM Laser.MaxRange %.2f\n" % max_range)
            f.write("PARAM Laser.MinAngle %.6f\n" % scans[0].min_angle)
            f.write("PARAM Laser.AngleIncrement %.9f\n" % incr)
        for s in scans:
            if fmt == "flaser":
                parts = ["FLASER", str(s.num_beams)]
                parts.extend("%.3f" % r for r in s.ranges)
                # Sensor frame == robot frame in the simulator.
                parts.extend("%.6f" % v for v in s.odom_pose)
                parts.extend("%.6f" % v for v in s.odom_pose)
                parts.extend(["%.6f" % s.timestamp, "synth",
                              "%.6f" % s.timestamp])
            elif fmt == "robotlaser":
                # laser_type start_angle fov ang_res max_range accuracy
                # remission_mode num ranges... laser_pose robot_pose
                # tv rv fwd_safety side_safety turn_axis ts host logger_ts
                parts = ["ROBOTLASER1", "0", "%.6f" % s.min_angle,
                         "%.6f" % fov, "%.9f" % incr,
                         "%.2f" % max_range, "0.01", "0",
                         str(s.num_beams)]
                parts.extend("%.3f" % r for r in s.ranges)
                parts.extend("%.6f" % v for v in s.odom_pose)  # laser pose
                parts.extend("%.6f" % v for v in s.odom_pose)  # robot pose
                parts.extend(["0.0", "0.0", "0.0", "0.0", "0.0"])
                parts.extend(["%.6f" % s.timestamp, "synth",
                              "%.6f" % s.timestamp])
            elif fmt == "rawlaser":
                odom = ["ODOM"]
                odom.extend("%.6f" % v for v in s.odom_pose)
                odom.extend(["0.0", "0.0", "0.0",
                             "%.6f" % s.timestamp, "synth",
                             "%.6f" % s.timestamp])
                f.write(" ".join(odom) + "\n")
                parts = ["RAWLASER1", "0", "%.6f" % s.min_angle,
                         "%.6f" % fov, "%.9f" % incr,
                         "%.2f" % max_range, "0.01", "0",
                         str(s.num_beams)]
                parts.extend("%.3f" % r for r in s.ranges)
                parts.append("0")  # no remissions
                parts.extend(["%.6f" % s.timestamp, "synth",
                              "%.6f" % s.timestamp])
            else:
                raise ValueError(f"unknown log format: {fmt}")
            f.write(" ".join(parts) + "\n")


def make_dataset(path_prefix: str, config: SimConfig | None = None) -> str:
    """Write ``<prefix>.clf`` and ``<prefix>_gt.npz``; returns the log path."""
    scans, true_poses = simulate(config=config)
    log_path = path_prefix + ".clf"
    cfg = config or SimConfig()
    write_carmen_log(log_path, scans, max_range=cfg.max_range)
    np.savez(path_prefix + "_gt.npz", true_poses=true_poses,
             timestamps=np.array([s.timestamp for s in scans]))
    return log_path


def ring_graph(n: int, seed: int = 0, n_loops: int = 4,
               noise: float = 0.01) -> Tuple[PoseGraph, np.ndarray]:
    """A pose graph of ``n`` nodes on a 10 m circle: odometry edges with
    Gaussian noise (``noise`` per component, from ``seed``) chained from
    the first true pose, and loop edges from every ``n // n_loops``-th
    node to the node opposite it, at their true relative pose. Returns
    (graph, true poses [n, 3]); the same graph, node for node, as
    ``make_ring`` of the JAX package's solver tests."""
    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * np.arange(n) / n
    gt = np.stack([10 * np.cos(ang), 10 * np.sin(ang), ang + np.pi / 2],
                  axis=-1)
    graph = PoseGraph()
    info = np.diag([100.0, 100.0, 400.0])
    pose = gt[0].copy()
    graph.append_node(pose, 0)
    for k in range(1, n):
        rel = se2.inverse_compound_np(gt[k - 1], gt[k]) + \
            rng.normal(0, noise, 3)
        pose = se2.compound_np(pose, rel)
        graph.append_node(pose, k)
        graph.append_edge(k - 1, k, rel, info)
    for k in range(0, n, max(1, n // n_loops)):
        j = (k + n // 2) % n
        graph.append_edge(min(k, j), max(k, j),
                          se2.inverse_compound_np(gt[min(k, j)],
                                                  gt[max(k, j)]),
                          np.diag([1e3, 1e3, 4e3]))
    return graph, gt
