"""Host (CPU, scipy-sparse) pose-graph LM solver — the Eigen-equivalent path.

Copy of ``my_lidar_graph_slam_tpu/models/optimizer_host.py`` (NumPy and
SciPy only), with ``LMConfig`` and ``GAUGE`` copied from
``my_lidar_graph_slam_tpu/models/optimizer_lm.py:36-60``; the device
solver (matrix-free PCG, ``optimizer_lm.py``) shares them.

The reference solves the normal equations with Eigen SimplicialLDLT or CG on
one CPU core (pose_graph_optimizer_lm.cpp:178-206). This module reproduces
that path with NumPy + scipy.sparse: triplet assembly of the sparse H
(:136-157), gauge fix by +1e9 on the first diagonal block (:164-168), the
double/halve lambda schedule (:55-61), and robust M-estimator weights
scaling each edge's information matrix (:110-115). Float64 throughout like
the reference's doubles.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from my_lidar_graph_slam_tpu_torch.models.pose_graph import GraphArrays
from my_lidar_graph_slam_tpu_torch.utils import se2

GAUGE = 1e9  # First-node diagonal anchor (pose_graph_optimizer_lm.cpp:168).


@dataclasses.dataclass(frozen=True)
class LMConfig:
    solver: str = "cg"                  # "cg" | "dense"
    max_iterations: int = 10
    error_tolerance: float = 1e-4
    initial_lambda: float = 1e-4
    loss_name: str = "Huber"
    loss_scale: float = 0.01
    cg_max_iterations: int = 256
    cg_tolerance: float = 1e-6
    # "chain": exact block-tridiagonal solve of the odometry chain via
    # cyclic reduction (log2 N batched 3x3 steps — the TPU-native
    # replacement for a sparse factorization); "jacobi": 3x3 block diagonal.
    preconditioner: str = "chain"


def _loss_weight(name: str, s: float, t: np.ndarray) -> np.ndarray:
    """NumPy weights w(t) on squared error t for all seven reference losses
    (robust_loss_function.cpp:26-188)."""
    t = np.asarray(t, np.float64)
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
        # robust_loss_function.cpp:182-188: w = 1 for t <= s.
        w = 2.0 * s / (s + t)
        return np.where(t <= s, 1.0, w * w)
    raise ValueError(f"unknown loss {name}")


def _loss_value(name: str, s: float, t: np.ndarray) -> np.ndarray:
    t = np.asarray(t, np.float64)
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
        # robust_loss_function.cpp:170-179: rho(t) = s t / (s + t).
        return s * t / (s + t)
    raise ValueError(f"unknown loss {name}")


def _errors_and_jacobians(poses, ei, ej, rel):
    """Batched SE(2) edge errors + analytic Jacobians, NumPy
    (pose_graph_optimizer_lm.cpp:224-299)."""
    pi = poses[ei]
    pj = poses[ej]
    e = se2.inverse_compound_np(pi, pj) - rel
    e[:, 2] = np.arctan2(np.sin(e[:, 2]), np.cos(e[:, 2]))

    th = pi[:, 2]
    s = np.sin(th)
    c = np.cos(th)
    dx = pj[:, 0] - pi[:, 0]
    dy = pj[:, 1] - pi[:, 1]
    a = -s * dx + c * dy
    b = -c * dx - s * dy
    z = np.zeros_like(th)
    o = np.ones_like(th)
    ji = np.stack([
        np.stack([-c, -s, a], axis=-1),
        np.stack([s, -c, b], axis=-1),
        np.stack([z, z, -o], axis=-1),
    ], axis=-2)
    jj = np.stack([
        np.stack([c, s, z], axis=-1),
        np.stack([-s, c, z], axis=-1),
        np.stack([z, z, o], axis=-1),
    ], axis=-2)
    return e, ji, jj


@dataclasses.dataclass
class HostSolveResult:
    poses: np.ndarray
    total_error: float
    iterations: int


def optimize_host(graph: GraphArrays, config: LMConfig) -> HostSolveResult:
    """Full LM loop on the host with a sparse Cholesky-equivalent solve.

    Same loop structure as ``optimizer_lm.optimize`` / the reference
    (pose_graph_optimizer_lm.cpp:13-65): up to ``max_iterations`` steps,
    each step solves (H + lam I) dx = -b and ALWAYS applies the step (the
    reference accepts uphill steps too, only the lambda schedule reacts).
    """
    nmask = np.asarray(graph.node_mask, bool)
    emask = np.asarray(graph.edge_mask, bool)
    n = int(nmask.sum())
    poses = np.asarray(graph.poses, np.float64)[:n].copy()
    ei = np.asarray(graph.edge_i, np.int64)[emask]
    ej = np.asarray(graph.edge_j, np.int64)[emask]
    rel = np.asarray(graph.edge_rel, np.float64)[emask]
    info = np.asarray(graph.edge_info, np.float64)[emask]
    ne = ei.shape[0]

    def total_error(p):
        e, _, _ = _errors_and_jacobians(p, ei, ej, rel)
        sq = np.einsum("ei,eij,ej->e", e, info, e)
        return float(_loss_value(config.loss_name, config.loss_scale,
                                 sq).sum())

    # Static triplet layout: each edge contributes 4 3x3 blocks (ii, jj,
    # ij, ji); row/col indices never change across iterations.
    bi = 3 * ei
    bj = 3 * ej
    off = np.arange(3)
    rows = np.concatenate([
        (b[:, None, None] + off[None, :, None]).repeat(3, 2).reshape(-1)
        for b in (bi, bj, bi, bj)])
    cols = np.concatenate([
        (b[:, None, None] + off[None, None, :]).repeat(3, 1).reshape(-1)
        for b in (bi, bj, bj, bi)])

    lam = float(config.initial_lambda)
    prev_err = np.inf
    iters = 0
    for _ in range(config.max_iterations):
        e, ji, jj = _errors_and_jacobians(poses, ei, ej, rel)
        sq = np.einsum("ei,eij,ej->e", e, info, e)
        w = _loss_weight(config.loss_name, config.loss_scale, sq)
        winfo = w[:, None, None] * info

        jtw_i = np.einsum("eji,ejk->eik", ji, winfo)   # Ji^T W
        jtw_j = np.einsum("eji,ejk->eik", jj, winfo)
        hii = jtw_i @ ji
        hjj = jtw_j @ jj
        hij = jtw_i @ jj
        data = np.concatenate([hii.reshape(-1), hjj.reshape(-1),
                               hij.reshape(-1),
                               np.swapaxes(hij, -1, -2).reshape(-1)])
        h = sp.coo_matrix((data, (rows, cols)), shape=(3 * n, 3 * n)).tocsc()
        h = h + sp.identity(3 * n, format="csc") * lam
        h[:3, :3] += GAUGE * np.eye(3)

        b = np.zeros((n, 3))
        np.add.at(b, ei, np.einsum("eij,ej->ei", jtw_i, e))
        np.add.at(b, ej, np.einsum("eij,ej->ei", jtw_j, e))

        delta = spla.spsolve(h, -b.reshape(-1))
        poses = poses + delta.reshape(n, 3)
        err = total_error(poses)
        iters += 1
        if abs(prev_err - err) < config.error_tolerance:
            prev_err = err
            break
        lam = lam * 0.5 if err < prev_err else lam * 2.0
        prev_err = err

    out = np.asarray(graph.poses, np.float64).copy()
    out[:n] = poses
    return HostSolveResult(poses=out, total_error=prev_err,
                           iterations=iters)
