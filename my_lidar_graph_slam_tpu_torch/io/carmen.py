"""CARMEN log reader.

Feature-parity Python port of the reference's line-oriented parser
(carmen_reader.cpp:11-534): PARAM, ODOM, RAWLASER1-4, ROBOTLASER1-2,
FLASER/RLASER (old front/rear laser), LASER3/LASER4 (old other laser),
including the old-format angle-geometry guessing by beam count
(carmen_reader.cpp:463-503) and the relative sensor pose computed as
``InverseCompound(robotPose, laserPose)`` (carmen_reader.cpp:313).

Counterpart of ``my_lidar_graph_slam_tpu/io/carmen.py``: :func:`load`,
the pure-Python reader and the semantics oracle, and
:func:`load_old_laser_fast`, the old-format laser records through the C++
tokenizer ``csrc/carmen_tokenizer.cpp``. The tokenizer is compiled with the
host's C++ compiler at first use into ``my_lidar_graph_slam_tpu_torch/
build/`` (ignored by git), named by a hash of its source so that an
edited source is rebuilt and an unchanged one reused; a failed build
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Union

import numpy as np

from my_lidar_graph_slam_tpu_torch.sensor.data import OdometryData, RawScan

SensorRecord = Union[OdometryData, RawScan]

_OLD_LASER_IDS = ("FLASER", "RLASER")
_OLD_OTHER_LASER_IDS = ("LASER3", "LASER4")
_RAW_LASER_IDS = ("RAWLASER1", "RAWLASER2", "RAWLASER3", "RAWLASER4")
_ROBOT_LASER_IDS = ("ROBOTLASER1", "ROBOTLASER2")


def _guess_angle_range(num: int) -> float:
    """carmen_reader.cpp:463-481."""
    return {
        181: math.pi,
        180: math.pi * 179.0 / 180.0,
        361: math.pi,
        360: math.pi * 179.5 / 180.0,
        401: math.pi * 100.0 / 180.0,
        400: math.pi * 99.75 / 180.0,
    }.get(num, math.pi)


def _guess_angle_increment(num: int) -> float:
    """carmen_reader.cpp:484-503."""
    table = {
        181: math.pi / 180.0,
        180: math.pi / 180.0,
        361: math.pi / 360.0,
        360: math.pi / 360.0,
        401: math.pi / 720.0,
        400: math.pi / 720.0,
    }
    if num in table:
        return table[num]
    return _guess_angle_range(num) / float(num - 1)


def _inverse_compound(start, end):
    s, c = math.sin(start[2]), math.cos(start[2])
    dx, dy = end[0] - start[0], end[1] - start[1]
    return np.array([c * dx + s * dy, -s * dx + c * dy, end[2] - start[2]])


def load(path: str) -> List[SensorRecord]:
    """Load a CARMEN log file into a list of sensor records."""
    records: List[SensorRecord] = []
    params: Dict[str, str] = {}
    with open(path, "r") as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            tag = tok[0]
            try:
                if tag == "PARAM":
                    if len(tok) >= 3:
                        params[tok[1]] = tok[2]
                    elif len(tok) == 2:
                        params[tok[1]] = ""
                elif tag == "ODOM":
                    records.append(_parse_odom(tag, tok))
                elif tag in _RAW_LASER_IDS:
                    records.append(_parse_raw_laser(tag, tok))
                elif tag in _ROBOT_LASER_IDS:
                    records.append(_parse_robot_laser(tag, tok))
                elif tag in _OLD_LASER_IDS:
                    records.append(_parse_old_laser(tag, tok, params))
                elif tag in _OLD_OTHER_LASER_IDS:
                    records.append(_parse_old_other_laser(tag, tok, params))
            except (ValueError, IndexError):
                # Mirrors the reference's "error check ignored" stance for
                # malformed records: skip them.
                continue
    return records


def _parse_odom(tag: str, tok: List[str]) -> OdometryData:
    """ODOM x y theta tv rv accel ipc_ts host logger_ts
    (carmen_reader.cpp:135-160)."""
    x, y, th = float(tok[1]), float(tok[2]), float(tok[3])
    tv, rv = float(tok[4]), float(tok[5])
    ts = float(tok[7]) if len(tok) > 7 else 0.0
    return OdometryData(
        sensor_id=tag, timestamp=ts,
        pose=np.array([x, y, th]),
        velocity=np.array([tv, 0.0, rv]))


def _parse_raw_laser(tag: str, tok: List[str]) -> RawScan:
    """RAWLASERn: laser config + ranges + remissions
    (carmen_reader.cpp:163-236)."""
    start_angle = float(tok[2])
    ang_res = float(tok[4])
    max_range = float(tok[5])
    num = int(tok[8])
    base = 9
    ranges = np.array([float(v) for v in tok[base:base + num]])
    base += num
    num_rem = int(tok[base])
    base += 1 + num_rem
    ts = float(tok[base]) if len(tok) > base else 0.0
    angles = start_angle + ang_res * np.arange(num)
    max_angle = start_angle + ang_res * (num - 1)
    return RawScan(
        sensor_id=tag, timestamp=ts,
        odom_pose=np.zeros(3), velocity=np.zeros(3),
        rel_sensor_pose=np.zeros(3),
        min_range=0.0, max_range=max_range,
        min_angle=start_angle, max_angle=max_angle,
        angles=angles, ranges=ranges)


def _parse_robot_laser(tag: str, tok: List[str]) -> RawScan:
    """ROBOTLASERn: laser config + ranges + laser/robot pose
    (carmen_reader.cpp:239-316)."""
    start_angle = float(tok[2])
    ang_res = float(tok[4])
    max_range = float(tok[5])
    num = int(tok[8])
    base = 9
    ranges = np.array([float(v) for v in tok[base:base + num]])
    base += num
    # The reference reads laser/robot pose immediately after the ranges; real
    # ROBOTLASER records carry a remission count there, but we replicate the
    # reference's interpretation (carmen_reader.cpp:285-292).
    laser_pose = np.array([float(tok[base]), float(tok[base + 1]),
                           float(tok[base + 2])])
    robot_pose = np.array([float(tok[base + 3]), float(tok[base + 4]),
                           float(tok[base + 5])])
    tv, rv = float(tok[base + 6]), float(tok[base + 7])
    base += 11
    ts = float(tok[base]) if len(tok) > base else 0.0
    angles = start_angle + ang_res * np.arange(num)
    max_angle = start_angle + ang_res * (num - 1)
    return RawScan(
        sensor_id=tag, timestamp=ts,
        odom_pose=robot_pose,
        velocity=np.array([tv, 0.0, rv]),
        rel_sensor_pose=_inverse_compound(robot_pose, laser_pose),
        min_range=0.0, max_range=max_range,
        min_angle=start_angle, max_angle=max_angle,
        angles=angles, ranges=ranges)


def _laser_params(params: Dict[str, str], num: int):
    """Old-format laser geometry from PARAMs or guessing
    (carmen_reader.cpp:354-377)."""
    min_range = float(params.get("Laser.MinRange", 0.0))
    max_range = float(params.get("Laser.MaxRange", 80.0))
    if "Laser.AngleIncrement" in params:
        incr = float(params["Laser.AngleIncrement"])
        guessed_incr = False
    else:
        incr = _guess_angle_increment(num)
        guessed_incr = True
    min_angle = float(params.get("Laser.MinAngle", -math.pi / 2.0))
    if "Laser.MaxAngle" in params:
        max_angle = float(params["Laser.MaxAngle"])
    elif not guessed_incr:
        max_angle = min_angle + incr * num
    else:
        max_angle = min_angle + _guess_angle_range(num)
    return min_range, max_range, incr, min_angle, max_angle


def _parse_old_laser(tag: str, tok: List[str],
                     params: Dict[str, str]) -> RawScan:
    """FLASER/RLASER: n ranges... laser_pose robot_pose ts host logger_ts
    (carmen_reader.cpp:319-394)."""
    num = int(tok[1])
    base = 2
    ranges = np.array([float(v) for v in tok[base:base + num]])
    base += num
    laser_pose = np.array([float(tok[base]), float(tok[base + 1]),
                           float(tok[base + 2])])
    robot_pose = np.array([float(tok[base + 3]), float(tok[base + 4]),
                           float(tok[base + 5])])
    base += 6
    ts = float(tok[base]) if len(tok) > base else 0.0
    min_range, max_range, incr, min_angle, max_angle = _laser_params(
        params, num)
    angles = min_angle + incr * np.arange(num)
    return RawScan(
        sensor_id=tag, timestamp=ts,
        odom_pose=robot_pose, velocity=np.zeros(3),
        rel_sensor_pose=_inverse_compound(robot_pose, laser_pose),
        min_range=min_range, max_range=max_range,
        min_angle=min_angle, max_angle=max_angle,
        angles=angles, ranges=ranges)


def _parse_old_other_laser(tag: str, tok: List[str],
                           params: Dict[str, str]) -> RawScan:
    """LASER3/LASER4: n ranges... ts host logger_ts (no poses)
    (carmen_reader.cpp:397-460)."""
    num = int(tok[1])
    base = 2
    ranges = np.array([float(v) for v in tok[base:base + num]])
    base += num
    ts = float(tok[base]) if len(tok) > base else 0.0
    min_range, max_range, incr, min_angle, max_angle = _laser_params(
        params, num)
    angles = min_angle + incr * np.arange(num)
    return RawScan(
        sensor_id=tag, timestamp=ts,
        odom_pose=np.zeros(3), velocity=np.zeros(3),
        rel_sensor_pose=np.zeros(3),
        min_range=min_range, max_range=max_range,
        min_angle=min_angle, max_angle=max_angle,
        angles=angles, ranges=ranges)


# ---------------------------------------------------------------------------
# Native fast path (C++ tokenizer, ctypes binding)
# ---------------------------------------------------------------------------

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKENIZER_SOURCE = os.path.join(_PKG, "csrc", "carmen_tokenizer.cpp")
BUILD = os.path.join(_PKG, "build")
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None


def _compiler() -> str:
    path = shutil.which("c++") or shutil.which("g++")
    if path is None:
        raise RuntimeError("no C++ compiler (c++ or g++) to build the CARMEN "
                           "tokenizer")
    return path


def tokenizer_library() -> ctypes.CDLL:
    """The loaded tokenizer library, built if needed; raises if the build
    fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        with open(TOKENIZER_SOURCE, "rb") as f:
            digest = hashlib.sha1(f.read()).hexdigest()[:12]
        target = os.path.join(BUILD, f"libcarmen_tokenizer-{digest}.so")
        if not os.path.exists(target):
            os.makedirs(BUILD, exist_ok=True)
            tmp = f"{target}.{os.getpid()}.tmp"
            out = subprocess.run(
                [_compiler(), *CXX_FLAGS, "-o", tmp, TOKENIZER_SOURCE],
                capture_output=True, text=True)
            if out.returncode != 0:
                raise RuntimeError("building the CARMEN tokenizer failed:\n"
                                   + out.stdout + out.stderr)
            os.replace(tmp, target)
        lib = ctypes.CDLL(target)
        lib.carmen_scan_count.restype = ctypes.c_int
        lib.carmen_scan_count.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.carmen_parse_old_laser.restype = ctypes.c_int
        lib.carmen_parse_old_laser.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        _lib = lib
        return lib


def load_old_laser_fast(path: str, tag: str = "FLASER",
                        max_beams: int = 4096) -> List[RawScan]:
    """All old-format laser records of one tag, parsed by the C++
    tokenizer (``load_old_laser_fast`` of the JAX package): ranges, poses
    and timestamps from the tokenizer, the laser geometry from the PARAMs
    read here, as :func:`load`'s FLASER path does (carmen_reader.cpp:
    319-394). Raises ``OSError`` when the file cannot be read."""
    lib = tokenizer_library()
    n = lib.carmen_scan_count(path.encode(), tag.encode())
    if n < 0:
        raise OSError(f"cannot read {path}")
    if n == 0:
        return []
    ranges = np.zeros((n, max_beams), np.float32)
    laser_poses = np.zeros((n, 3), np.float64)
    robot_poses = np.zeros((n, 3), np.float64)
    timestamps = np.zeros((n,), np.float64)
    beam_counts = np.zeros((n,), np.int32)
    got = lib.carmen_parse_old_laser(
        path.encode(), tag.encode(), max_beams, n, ranges.ctypes.data,
        laser_poses.ctypes.data, robot_poses.ctypes.data,
        timestamps.ctypes.data, beam_counts.ctypes.data)
    if got < 0:
        raise OSError(f"cannot read {path}")

    params: Dict[str, str] = {}
    with open(path, "r") as f:
        for line in f:
            if not line.startswith("PARAM"):
                continue
            tok = line.split()
            if len(tok) >= 3:
                params[tok[1]] = tok[2]

    scans = []
    for i in range(got):
        num = int(beam_counts[i])
        nkeep = min(num, max_beams)
        min_range, max_range, incr, min_angle, max_angle = _laser_params(
            params, num)
        scans.append(RawScan(
            sensor_id=tag, timestamp=float(timestamps[i]),
            odom_pose=robot_poses[i].copy(), velocity=np.zeros(3),
            rel_sensor_pose=_inverse_compound(robot_poses[i],
                                              laser_poses[i]),
            min_range=min_range, max_range=max_range,
            min_angle=min_angle, max_angle=max_angle,
            angles=min_angle + incr * np.arange(nkeep),
            ranges=ranges[i, :nkeep].astype(np.float64)))
    return scans
