"""SE(2) pose algebra on torch tensors, plus NumPy mirrors for the host.

Counterpart of ``my_lidar_graph_slam_tpu/utils/se2.py``. Poses are tensors
of shape ``[..., 3]`` holding ``(x, y, theta)``; every function broadcasts
over leading axes.

Reference parity: ``Compound`` / ``InverseCompound`` / ``MoveForward`` /
``MoveBackward`` (reference pose.hpp:150-206), ``NormalizeAngle``
(util.hpp:125-144), covariance frame rotation (util.hpp:164-195),
``Distance`` (pose.hpp:121-131).
"""

from __future__ import annotations

import math

import numpy as np
import torch

# --------------------------------------------------------------------------
# torch versions (device, batched)
# --------------------------------------------------------------------------


def normalize_angle(theta: torch.Tensor) -> torch.Tensor:
    """Normalize angles to (-pi, pi]. Mirrors util.hpp:125-135."""
    t = torch.remainder(theta, 2.0 * math.pi)
    t = torch.where(t > math.pi, t - 2.0 * math.pi, t)
    return torch.where(t < -math.pi, t + 2.0 * math.pi, t)


def normalize_pose(pose: torch.Tensor) -> torch.Tensor:
    """Normalize the angular component of a pose tensor ``[..., 3]``."""
    return torch.cat([pose[..., :2], normalize_angle(pose[..., 2:3])],
                     dim=-1)


def compound(start: torch.Tensor, diff: torch.Tensor) -> torch.Tensor:
    """SE(2) compounding ``start (+) diff`` (pose.hpp:150-161)."""
    s = torch.sin(start[..., 2])
    c = torch.cos(start[..., 2])
    x = c * diff[..., 0] - s * diff[..., 1] + start[..., 0]
    y = s * diff[..., 0] + c * diff[..., 1] + start[..., 1]
    t = start[..., 2] + diff[..., 2]
    return torch.stack([x, y, t], dim=-1)


def inverse_compound(start: torch.Tensor, end: torch.Tensor) -> torch.Tensor:
    """Relative pose of ``end`` in the frame of ``start`` (pose.hpp:165-180)."""
    s = torch.sin(start[..., 2])
    c = torch.cos(start[..., 2])
    dx = end[..., 0] - start[..., 0]
    dy = end[..., 1] - start[..., 1]
    return torch.stack([c * dx + s * dy, -s * dx + c * dy,
                        end[..., 2] - start[..., 2]], dim=-1)


def move_forward(start: torch.Tensor, diff: torch.Tensor) -> torch.Tensor:
    """Alias of :func:`compound` (pose.hpp:185-190)."""
    return compound(start, diff)


def move_backward(end: torch.Tensor, diff: torch.Tensor) -> torch.Tensor:
    """Pose ``p`` such that ``compound(p, diff) == end`` (pose.hpp:195-206)."""
    t = end[..., 2] - diff[..., 2]
    s = torch.sin(t)
    c = torch.cos(t)
    x = end[..., 0] - c * diff[..., 0] + s * diff[..., 1]
    y = end[..., 1] - s * diff[..., 0] - c * diff[..., 1]
    return torch.stack([x, y, t], dim=-1)


def rotation_matrix(theta: torch.Tensor) -> torch.Tensor:
    """SE(2) covariance rotation matrix ``[..., 3, 3]`` (util.hpp:164-179)."""
    s = torch.sin(theta)
    c = torch.cos(theta)
    z = torch.zeros_like(theta)
    o = torch.ones_like(theta)
    return torch.stack([torch.stack([c, -s, z], dim=-1),
                        torch.stack([s, c, z], dim=-1),
                        torch.stack([z, z, o], dim=-1)], dim=-2)


def rotate_covariance(theta: torch.Tensor, cov: torch.Tensor) -> torch.Tensor:
    """``R(theta) @ cov @ R(theta)^T`` for ``cov [..., 3, 3]``.

    Each product is a multiply-and-sum, not a matrix product, so the TF32
    settings of the card do not reach it.
    """
    rot = rotation_matrix(theta)
    tmp = (rot[..., :, :, None] * cov[..., None, :, :]).sum(dim=-2)
    return (tmp[..., :, None, :] * rot[..., None, :, :]).sum(dim=-1)


def covariance_world_to_robot(pose: torch.Tensor,
                              cov: torch.Tensor) -> torch.Tensor:
    """World-frame covariance -> robot frame (util.hpp:182-187)."""
    return rotate_covariance(-pose[..., 2], cov)


def covariance_robot_to_world(pose: torch.Tensor,
                              cov: torch.Tensor) -> torch.Tensor:
    """Robot-frame covariance -> world frame (util.hpp:190-195)."""
    return rotate_covariance(pose[..., 2], cov)


def distance(p0: torch.Tensor, p1=None) -> torch.Tensor:
    """Euclidean translation distance (pose.hpp:121-131)."""
    if p1 is None:
        return torch.hypot(p0[..., 0], p0[..., 1])
    return torch.hypot(p0[..., 0] - p1[..., 0], p0[..., 1] - p1[..., 1])


# --------------------------------------------------------------------------
# NumPy mirrors (host bookkeeping)
# --------------------------------------------------------------------------


def normalize_angle_np(theta):
    t = np.mod(theta, 2.0 * np.pi)
    t = np.where(t > np.pi, t - 2.0 * np.pi, t)
    t = np.where(t < -np.pi, t + 2.0 * np.pi, t)
    return t


def compound_np(start, diff):
    start = np.asarray(start, dtype=np.float64)
    diff = np.asarray(diff, dtype=np.float64)
    s, c = np.sin(start[..., 2]), np.cos(start[..., 2])
    return np.stack([
        c * diff[..., 0] - s * diff[..., 1] + start[..., 0],
        s * diff[..., 0] + c * diff[..., 1] + start[..., 1],
        start[..., 2] + diff[..., 2],
    ], axis=-1)


def inverse_compound_np(start, end):
    start = np.asarray(start, dtype=np.float64)
    end = np.asarray(end, dtype=np.float64)
    s, c = np.sin(start[..., 2]), np.cos(start[..., 2])
    dx = end[..., 0] - start[..., 0]
    dy = end[..., 1] - start[..., 1]
    return np.stack([
        c * dx + s * dy,
        -s * dx + c * dy,
        end[..., 2] - start[..., 2],
    ], axis=-1)


def move_backward_np(end, diff):
    end = np.asarray(end, dtype=np.float64)
    diff = np.asarray(diff, dtype=np.float64)
    t = end[..., 2] - diff[..., 2]
    s, c = np.sin(t), np.cos(t)
    return np.stack([
        end[..., 0] - c * diff[..., 0] + s * diff[..., 1],
        end[..., 1] - s * diff[..., 0] - c * diff[..., 1],
        t,
    ], axis=-1)


def rotate_covariance_np(theta, cov):
    s, c = np.sin(theta), np.cos(theta)
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    return rot @ np.asarray(cov) @ rot.T


def covariance_world_to_robot_np(pose, cov):
    return rotate_covariance_np(-np.asarray(pose)[2], cov)


def distance_np(p0, p1=None):
    p0 = np.asarray(p0)
    if p1 is None:
        return np.hypot(p0[..., 0], p0[..., 1])
    p1 = np.asarray(p1)
    return np.hypot(p0[..., 0] - p1[..., 0], p0[..., 1] - p1[..., 1])
