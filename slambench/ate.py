"""Absolute trajectory error (ATE) against ground truth.

Frozen copy of ``my_lidar_graph_slam_tpu_torch/utils/ate.py`` at commit
8e18ecb (NumPy only): associate by timestamp, align with the best-fit
SE(2) transform (2-D Umeyama without scale), report translational RMSE.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def associate(est_times: np.ndarray, gt_times: np.ndarray,
              max_dt: float = 0.25) -> Tuple[np.ndarray, np.ndarray]:
    """Nearest-timestamp association; returns (est_idx, gt_idx) pairs."""
    gi = np.searchsorted(gt_times, est_times)
    gi = np.clip(gi, 1, len(gt_times) - 1)
    left = gi - 1
    pick = np.where(
        np.abs(gt_times[gi] - est_times) <
        np.abs(gt_times[left] - est_times), gi, left)
    ok = np.abs(gt_times[pick] - est_times) <= max_dt
    return np.flatnonzero(ok), pick[ok]


def align_se2(est_xy: np.ndarray, gt_xy: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Best-fit rotation R and translation t mapping est -> gt
    (2-D Umeyama / Kabsch, no scale)."""
    me = est_xy.mean(axis=0)
    mg = gt_xy.mean(axis=0)
    h = (est_xy - me).T @ (gt_xy - mg)
    u, _, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    r = vt.T @ np.diag([1.0, d]) @ u.T
    t = mg - r @ me
    return r, t


def ate_rmse(est_poses: np.ndarray, gt_poses: np.ndarray,
             est_times: Optional[np.ndarray] = None,
             gt_times: Optional[np.ndarray] = None,
             aligned: bool = True) -> float:
    """Translational ATE RMSE (meters).

    ``est_poses``/``gt_poses``: [N, 3] / [M, 3]. With timestamps, pairs are
    associated first; otherwise the arrays must correspond row-to-row.
    ``aligned`` applies the best-fit SE(2) alignment (standard ATE); set
    False for anchored error.
    """
    if est_times is not None and gt_times is not None:
        ei, gi = associate(np.asarray(est_times), np.asarray(gt_times))
        est = np.asarray(est_poses)[ei, :2]
        gt = np.asarray(gt_poses)[gi, :2]
    else:
        n = min(len(est_poses), len(gt_poses))
        est = np.asarray(est_poses)[:n, :2]
        gt = np.asarray(gt_poses)[:n, :2]
    if len(est) == 0:
        return float("nan")
    if aligned and len(est) >= 2:
        r, t = align_se2(est, gt)
        est = est @ r.T + t
    err = est - gt
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))
