"""The reference pose-graph solver: Levenberg-Marquardt with robust
weights on the snapshot a backend pass solved.

Frozen copy of ``optimize_host`` in ``my_lidar_graph_slam_tpu_torch/
models/optimizer_host.py`` at commit 8e18ecb (pose_graph_optimizer_lm.cpp:
13-65, 110-115, 164-168, 224-299): the same loop (every step applied, the
lambda halved after a step that lowered the error and doubled otherwise,
a stop once the error changes by less than the tolerance), the same
robust losses and the same gauge anchor on the first node. It solves
the normal equations densely with NumPy instead of with a sparse
factorisation, in ``dtype``: float64 for the reference, float32 for the
control.
"""

from __future__ import annotations

import numpy as np

GAUGE = 1e9


def _loss_weight(name: str, s: float, t):
    if name == "Squared":
        return np.ones_like(t)
    if name == "Huber":
        return np.where(t <= s, 1.0, np.sqrt(s / np.maximum(t, 1e-30)))
    if name == "Cauchy":
        return s / (s + t)
    if name == "Fair":
        return 1.0 / (1.0 + np.sqrt(t / s))
    if name == "GemanMcClure":
        return (s * s) / ((s + t) * (s + t))
    if name == "Welsch":
        return np.exp(-t / s)
    if name == "DCS":
        w = 2.0 * s / (s + t)
        return np.where(t <= s, 1.0, w * w)
    raise ValueError(f"unknown loss {name}")


def _loss_value(name: str, s: float, t):
    if name == "Squared":
        return t
    if name == "Huber":
        return np.where(t <= s, t, 2.0 * np.sqrt(s * t) - s)
    if name == "Cauchy":
        return s * np.log1p(t / s)
    if name == "Fair":
        sq = np.sqrt(t / s)
        return 2.0 * s * (sq - np.log1p(sq))
    if name == "GemanMcClure":
        return s * t / (s + t)
    if name == "Welsch":
        return s * -np.expm1(-t / s)
    if name == "DCS":
        return s * t / (s + t)
    raise ValueError(f"unknown loss {name}")


def _errors_and_jacobians(poses, ei, ej, rel):
    pi, pj = poses[ei], poses[ej]
    th = pi[:, 2]
    s, c = np.sin(th), np.cos(th)
    dx = pj[:, 0] - pi[:, 0]
    dy = pj[:, 1] - pi[:, 1]
    e = np.stack([c * dx + s * dy, -s * dx + c * dy,
                  pj[:, 2] - pi[:, 2]], axis=-1) - rel
    e[:, 2] = np.arctan2(np.sin(e[:, 2]), np.cos(e[:, 2]))
    a = -s * dx + c * dy
    b = -c * dx - s * dy
    z, o = np.zeros_like(th), np.ones_like(th)
    ji = np.stack([np.stack([-c, -s, a], -1), np.stack([s, -c, b], -1),
                   np.stack([z, z, -o], -1)], axis=-2)
    jj = np.stack([np.stack([c, s, z], -1), np.stack([-s, c, z], -1),
                   np.stack([z, z, o], -1)], axis=-2)
    return e, ji, jj


def optimize(poses, edge_i, edge_j, edge_rel, edge_info, loss_name: str,
             loss_scale: float, max_iterations: int, error_tolerance: float,
             initial_lambda: float, dtype=np.float64) -> np.ndarray:
    """Optimised poses [N, 3] of the graph (node poses [N, 3], edges
    (i, j, relative pose [3], information [3, 3]))."""
    poses = np.asarray(poses, dtype).copy()
    ei = np.asarray(edge_i, np.int64)
    ej = np.asarray(edge_j, np.int64)
    rel = np.asarray(edge_rel, dtype)
    info = np.asarray(edge_info, dtype)
    n = poses.shape[0]
    s = dtype(loss_scale)

    def total_error(p):
        e, _, _ = _errors_and_jacobians(p, ei, ej, rel)
        sq = np.einsum("ei,eij,ej->e", e, info, e)
        return float(_loss_value(loss_name, s, sq).sum())

    lam = float(initial_lambda)
    prev_err = np.inf
    for _ in range(max_iterations):
        e, ji, jj = _errors_and_jacobians(poses, ei, ej, rel)
        sq = np.einsum("ei,eij,ej->e", e, info, e)
        w = _loss_weight(loss_name, s, sq).astype(dtype)
        winfo = w[:, None, None] * info
        jtw_i = np.einsum("eji,ejk->eik", ji, winfo)
        jtw_j = np.einsum("eji,ejk->eik", jj, winfo)
        h = np.zeros((n, 3, n, 3), dtype)
        np.add.at(h, (ei, slice(None), ei), jtw_i @ ji)
        np.add.at(h, (ej, slice(None), ej), jtw_j @ jj)
        np.add.at(h, (ei, slice(None), ej), jtw_i @ jj)
        np.add.at(h, (ej, slice(None), ei), np.swapaxes(jtw_i @ jj, 1, 2))
        h = h.reshape(3 * n, 3 * n)
        h[np.arange(3 * n), np.arange(3 * n)] += dtype(lam)
        h[:3, :3] += dtype(GAUGE) * np.eye(3, dtype=dtype)
        b = np.zeros((n, 3), dtype)
        np.add.at(b, ei, np.einsum("eij,ej->ei", jtw_i, e))
        np.add.at(b, ej, np.einsum("eij,ej->ei", jtw_j, e))
        delta = np.linalg.solve(h, -b.reshape(-1)).astype(dtype)
        poses = poses + delta.reshape(n, 3)
        err = total_error(poses)
        if abs(prev_err - err) < error_tolerance:
            break
        lam = lam * 0.5 if err < prev_err else lam * 2.0
        prev_err = err
    return poses
