"""Robust Levenberg-Marquardt pose-graph optimizer on the device (Sparse
Pose Adjustment).

Counterpart of ``my_lidar_graph_slam_tpu/models/optimizer_lm.py:36-363``
(PoseGraphOptimizerLM, pose_graph_optimizer_lm.cpp:13-338, after Konolige
et al. IROS 2010), with ``LMConfig`` and ``GAUGE`` shared with
``optimizer_host.py``:

 * Per-edge SE(2) errors and analytic 3x3 Jacobians for ALL edges as one
   batched computation (:224-299); robust M-estimator weights scale each
   edge's information matrix (:110-115).
 * The normal equations are never assembled as a sparse matrix: a
   matrix-free preconditioned conjugate gradient whose product is a
   scatter-add (``index_add_``) over edge blocks, preconditioned by the
   exact block-tridiagonal solve of the odometry chain (cyclic reduction,
   ``chain_factor``/``chain_solve``) or by the 3x3 block diagonal. A dense
   solve serves the other ``SolverType`` values.
 * Gauge freedom is fixed by adding 1e9 to the first node's diagonal block
   (:164-168); lambda doubles or halves on error increase or decrease
   (:41-64).

Full float32 whatever the caller's TF32 setting: every batched 3x3
product is an explicit multiply-and-sum (``_mm``, ``_mv``) and every 3x3
inverse the adjugate formula (``_inv3``), never ``matmul`` or a library
call that may round through TF32; the dense path solves in float64.

The JAX package's two ``lax.while_loop`` s become host loops. The LM loop
reads its stopping flag once per step, as the JAX loop tests it. The CG
loop computes its stopping test on the device and freezes converged
state with ``torch.where``, so its iterate equals the JAX loop's, and
reads the flag only every ``CG_CHECK_EVERY`` steps; ``OptimizeResult``
counts these reads. On CUDA the scatter-adds use float atomics, so two
solves of one graph may differ in the last bits.

Inputs are the capacity-padded ``GraphArrays`` snapshot (NumPy); masked
edges carry zero information and masked nodes receive zero increments.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from my_lidar_graph_slam_tpu_torch.models import robust_loss
from my_lidar_graph_slam_tpu_torch.models.optimizer_host import GAUGE, LMConfig
from my_lidar_graph_slam_tpu_torch.models.pose_graph import GraphArrays
from my_lidar_graph_slam_tpu_torch.utils import device as device_mod
from my_lidar_graph_slam_tpu_torch.utils import se2

# CG steps between host reads of the device-side stopping flag.
CG_CHECK_EVERY = 8


class OptimizeResult(NamedTuple):
    poses: torch.Tensor        # f32[N_cap, 3]
    total_error: torch.Tensor  # f32[]
    iterations: int            # LM steps
    cg_iterations: int         # CG steps over all LM steps
    host_syncs: int            # host reads of device values


def _mm(a, b):
    """Batched 3x3 product ``a @ b`` as multiply-and-sum (full float32)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def _mv(a, v):
    """Batched ``a @ v`` as multiply-and-sum (full float32)."""
    return (a * v[..., None, :]).sum(dim=-1)


def _t(a):
    return a.transpose(-1, -2)


def _quad(e, info):
    """e^T Lambda e per edge."""
    return (e * _mv(info, e)).sum(dim=-1)


def _inv3(a):
    """Inverse of each 3x3 block of ``a`` [..., 3, 3] by the adjugate
    formula: cofactor (i, j) is a[i+1, j+1] a[i+2, j+2] - a[i+1, j+2]
    a[i+2, j+1], indices mod 3, taken with rolls (an index list would be
    copied to the device, which synchronizes the stream)."""
    a1 = a.roll(-1, dims=-2)                       # rows i + 1
    a2 = a.roll(-2, dims=-2)                       # rows i + 2
    cof = a1.roll(-1, dims=-1) * a2.roll(-2, dims=-1) - \
        a1.roll(-2, dims=-1) * a2.roll(-1, dims=-1)
    det = (a[..., 0, :] * cof[..., 0, :]).sum(dim=-1)
    return _t(cof) / det[..., None, None]


def pair_errors(pi, pj, rel):
    """SE(2) error h(c_i, c_j) - z_ij with normalized angle from explicit
    endpoint poses (pose_graph_optimizer_lm.cpp:283-299)."""
    err = se2.inverse_compound(pi, pj) - rel
    return torch.cat([err[..., :2], se2.normalize_angle(err[..., 2:3])],
                     dim=-1)


def pair_jacobians(pi, pj):
    """Analytic 3x3 Jacobians wrt the start and end poses from explicit
    endpoint poses (pose_graph_optimizer_lm.cpp:224-280)."""
    th = pi[..., 2]
    s = torch.sin(th)
    c = torch.cos(th)
    dx = pj[..., 0] - pi[..., 0]
    dy = pj[..., 1] - pi[..., 1]
    a = -s * dx + c * dy
    b = -c * dx - s * dy
    z = torch.zeros_like(th)
    o = torch.ones_like(th)
    ji = torch.stack([
        torch.stack([-c, -s, a], dim=-1),
        torch.stack([s, -c, b], dim=-1),
        torch.stack([z, z, -o], dim=-1),
    ], dim=-2)
    jj = torch.stack([
        torch.stack([c, s, z], dim=-1),
        torch.stack([-s, c, z], dim=-1),
        torch.stack([z, z, o], dim=-1),
    ], dim=-2)
    return ji, jj


def edge_errors(poses, edge_i, edge_j, edge_rel):
    """Batched error of the edges (i, j) of ``poses``."""
    return pair_errors(poses[edge_i], poses[edge_j], edge_rel)


def edge_jacobians(poses, edge_i, edge_j):
    """Batched Jacobians of the edges (i, j) of ``poses``: (Ji, Jj)
    [E, 3, 3]."""
    return pair_jacobians(poses[edge_i], poses[edge_j])


def to_device(graph: GraphArrays, device) -> GraphArrays:
    """The snapshot's arrays as tensors on ``device``: poses, relative
    poses and information float32, indices int64."""
    f32, i64 = torch.float32, torch.int64

    def up(a, dtype):
        return device_mod.upload(np.asarray(a), device,
                                 site="lm_graph").to(dtype)

    return GraphArrays(
        poses=up(graph.poses, f32), node_mask=up(graph.node_mask, torch.bool),
        edge_i=up(graph.edge_i, i64), edge_j=up(graph.edge_j, i64),
        edge_rel=up(graph.edge_rel, f32), edge_info=up(graph.edge_info, f32),
        edge_mask=up(graph.edge_mask, torch.bool))


def total_error(poses, graph: GraphArrays, loss: robust_loss.RobustLoss):
    """Robust total error (pose_graph_optimizer_lm.cpp:302-338)."""
    err = edge_errors(poses, graph.edge_i, graph.edge_j, graph.edge_rel)
    sq = _quad(err, graph.edge_info)
    return torch.where(graph.edge_mask, loss.loss(sq),
                       torch.zeros_like(sq)).sum()


def _build_normal_terms(poses, graph: GraphArrays,
                        loss: robust_loss.RobustLoss):
    """Per-edge weighted blocks + RHS for the normal equations."""
    err = edge_errors(poses, graph.edge_i, graph.edge_j, graph.edge_rel)
    ji, jj = edge_jacobians(poses, graph.edge_i, graph.edge_j)
    sq = _quad(err, graph.edge_info)
    w = torch.where(graph.edge_mask, loss.weight(sq), torch.zeros_like(sq))
    winfo = w[:, None, None] * graph.edge_info          # [E, 3, 3]

    tr_ji_w = _mm(_t(ji), winfo)                        # Ji^T W
    tr_jj_w = _mm(_t(jj), winfo)                        # Jj^T W

    b = torch.zeros_like(poses)
    b.index_add_(0, graph.edge_i, _mv(tr_ji_w, err))
    b.index_add_(0, graph.edge_j, _mv(tr_jj_w, err))
    return ji, jj, winfo, tr_ji_w, tr_jj_w, b


def _diag_edges(edge_i, edge_j, ji, jj, winfo, n):
    """The edges' part of the 3x3 diagonal blocks of H, over ``n``
    nodes."""
    hii = _mm(_mm(_t(ji), winfo), ji)
    hjj = _mm(_mm(_t(jj), winfo), jj)
    diag = torch.zeros((n, 3, 3), dtype=ji.dtype, device=ji.device)
    diag.index_add_(0, edge_i, hii)
    diag.index_add_(0, edge_j, hjj)
    return diag


def _block_diag(graph: GraphArrays, ji, jj, winfo, lam, n):
    """3x3 diagonal blocks of H (for the preconditioner)."""
    eye = torch.eye(3, dtype=ji.dtype, device=ji.device)
    diag = _diag_edges(graph.edge_i, graph.edge_j, ji, jj, winfo, n) + \
        lam * eye
    diag[0] += GAUGE * eye
    return diag


def _hv_edges(v, edge_i, edge_j, ji, jj, winfo):
    """The edges' part of H @ v, a scatter-add over edge blocks."""
    u = _mv(ji, v[edge_i]) + _mv(jj, v[edge_j])                # [E, 3]
    t = _mv(winfo, u)
    out = torch.zeros_like(v)
    out.index_add_(0, edge_i, _mv(_t(ji), t))
    out.index_add_(0, edge_j, _mv(_t(jj), t))
    return out


def _hv(v, graph: GraphArrays, ji, jj, winfo, lam):
    """Matrix-free H @ v."""
    out = _hv_edges(v, graph.edge_i, graph.edge_j, ji, jj, winfo) + lam * v
    out[0] += GAUGE * v[0]
    return out


def _chain_subdiag(graph: GraphArrays, ji, jj, winfo, n):
    """Sub-diagonal 3x3 blocks A[i] (coupling node i to node i-1) of the
    ODOMETRY-CHAIN part of H: only edges with j == i + 1 contribute
    (pose_graph.hpp:165-169 defines odometric edges exactly so)."""
    is_odom = (graph.edge_j == graph.edge_i + 1) & graph.edge_mask
    hij = _mm(_mm(_t(ji), winfo), jj)                  # H_ij blocks
    a = torch.zeros((n, 3, 3), dtype=ji.dtype, device=ji.device)
    a.index_add_(0, torch.where(is_odom, graph.edge_j,
                                torch.zeros_like(graph.edge_j)),
                 torch.where(is_odom[:, None, None], _t(hij),
                             torch.zeros_like(hij)))
    a[0] = 0.0
    return a


def chain_factor(diag, sub):
    """Cyclic-reduction factorization of the block-tridiagonal matrix with
    diagonal blocks ``diag`` [N, 3, 3] and sub-diagonal ``sub`` [N, 3, 3]
    (``sub[i]`` couples x_i to x_{i-1}; ``sub[0]`` ignored).

    log2(N) levels, each a batched 3x3 inverse and products over the
    remaining blocks: O(N) work, O(log N) depth. As the CG preconditioner
    it solves the odometry chain exactly, so CG only corrects for the
    loop-closure edges. N is padded to a power of two with identity blocks.
    Returns (per-level tensors, final 3x3 inverse, padded N) for
    :func:`chain_solve`.
    """
    n = diag.shape[0]
    npow = 1
    while npow < n:
        npow *= 2
    dtype, dev = diag.dtype, diag.device
    if npow != n:
        eye = torch.eye(3, dtype=dtype, device=dev)
        diag = torch.cat([diag, eye.expand(npow - n, 3, 3)])
        sub = torch.cat([sub, torch.zeros((npow - n, 3, 3), dtype=dtype,
                                          device=dev)])
    z = torch.zeros((1, 3, 3), dtype=dtype, device=dev)
    levels = []
    d, a = diag, sub
    while d.shape[0] > 1:
        h = d.shape[0] // 2
        dinv_odd = _inv3(d[1::2])                        # [h, 3, 3]
        a_odd = a[1::2]                                  # x_odd <- x_even(k)
        c_odd = _t(torch.cat([a[2::2], z])[:h])
        c_even = _t(a[1::2])
        adinv = _mm(a[0::2], torch.cat([z, dinv_odd])[:h])
        cdinv = _mm(c_even, dinv_odd)
        a_odd_sh = torch.cat([z, a_odd])[:h]
        c_odd_sh = torch.cat([z, c_odd])[:h]
        d_next = d[0::2] - _mm(adinv, c_odd_sh) - _mm(cdinv, a_odd)
        a_next = -_mm(adinv, a_odd_sh)
        levels.append((dinv_odd, a_odd, c_odd, adinv, cdinv))
        d, a = d_next, a_next
    return tuple(levels), _inv3(d[0]), npow


def chain_solve(levels, dinv_final, npow, b):
    """Solve M x = b with the factorization from :func:`chain_factor`."""
    n0 = b.shape[0]
    z = torch.zeros((1, 3), dtype=b.dtype, device=b.device)
    if npow != n0:
        b = torch.cat([b, z.expand(npow - n0, 3)])
    stack = []
    for _, _, _, adinv, cdinv in levels:
        b_odd = b[1::2]
        b_odd_sh = torch.cat([z, b_odd])[:b_odd.shape[0]]
        stack.append(b_odd)
        b = b[0::2] - _mv(adinv, b_odd_sh) - _mv(cdinv, b_odd)
    x = _mv(dinv_final, b[0])[None]
    for (dinv_odd, a_odd, c_odd, _, _), b_odd in zip(reversed(levels),
                                                     reversed(stack)):
        x_next = torch.cat([x[1:], z])
        x_odd = _mv(dinv_odd, b_odd - _mv(a_odd, x) - _mv(c_odd, x_next))
        x = torch.stack([x, x_odd], dim=1).reshape(-1, 3)
    return x[:n0]


def _each(fn, *lists):
    """``fn`` applied shard by shard to lists holding one entry per
    shard."""
    return [fn(*args) for args in zip(*lists)]


def _div(a, b):
    return a / torch.clamp(b, min=1e-30)


def _axpy(y, a, x):
    return y + a * x


def _pcg(rhs, hv, precond, dot, max_iters: int, tol: float, agree=list):
    """Preconditioned CG for H x = rhs over one or more shards
    (``parallel/distributed.py`` runs it over a mesh): ``rhs`` and every
    iterate are lists with one [n, 3] tensor per shard; ``hv`` and
    ``precond`` map such lists; ``dot(a, b)`` gives each shard's copy of
    the inner product (equal on every shard); ``agree`` turns the host's
    flags into flags that every process shares.

    Returns (x, CG steps taken, host reads). The JAX loop's condition is
    computed on the device before every step and a step is applied only
    where it holds (the step bound is the Python loop's); the host reads
    it every ``CG_CHECK_EVERY`` steps."""
    x = [torch.zeros_like(r) for r in rhs]
    r = list(rhs)
    z = precond(r)
    p = z
    rz = dot(r, z)
    rr = dot(r, r)
    thresh = [tol * tol * v for v in rr]
    it = torch.zeros((), dtype=torch.int64, device=rhs[0].device)
    steps = syncs = 0
    for step in range(1, max_iters + 1):
        active = _each(torch.gt, rr, thresh)
        hp = hv(p)
        alpha = _each(_div, rz, dot(p, hp))
        x_new = _each(_axpy, x, alpha, p)
        r_new = _each(lambda r_, a, h: r_ - a * h, r, alpha, hp)
        z_new = precond(r_new)
        rz_new = dot(r_new, z_new)
        rr_new = dot(r_new, r_new)
        p_new = _each(_axpy, z_new, _each(_div, rz_new, rz), p)
        x, r, p, rz, rr = (_each(torch.where, active, new, old)
                           for new, old in ((x_new, x), (r_new, r),
                                            (p_new, p), (rz_new, rz),
                                            (rr_new, rr)))
        it = it + active[0].to(torch.int64)
        if step % CG_CHECK_EVERY == 0 or step == max_iters:
            more, steps = agree(device_mod.sync(torch.stack(
                [(rr[0] > thresh[0]).to(torch.int64), it]),
                site="lm_cg").tolist())
            syncs += 1
            if not more:
                break
    return x, steps, syncs


def _dense_solve(rhs, graph, ji, jj, winfo, lam, n):
    """Dense assembly + solve (parity path; mirrors the SparseCholesky
    branch, pose_graph_optimizer_lm.cpp:179-188). Assembled in float32 as
    the JAX package does, solved in float64 so that no TF32 rounding
    enters the factorization."""
    hii = _mm(_mm(_t(ji), winfo), ji)
    hjj = _mm(_mm(_t(jj), winfo), jj)
    hij = _mm(_mm(_t(ji), winfo), jj)
    dev = ji.device
    off = torch.arange(3, device=dev)
    h = torch.zeros((3 * n) * (3 * n), dtype=ji.dtype, device=dev)

    def add(rows, cols, blocks):
        r = 3 * rows[:, None, None] + off[None, :, None]
        c = 3 * cols[:, None, None] + off[None, None, :]
        h.index_add_(0, (r * (3 * n) + c).reshape(-1), blocks.reshape(-1))

    ei, ej = graph.edge_i, graph.edge_j
    add(ei, ei, hii)
    add(ej, ej, hjj)
    add(ei, ej, hij)
    add(ej, ei, _t(hij))
    h = h.reshape(3 * n, 3 * n) + lam * torch.eye(3 * n, dtype=ji.dtype,
                                                  device=dev)
    h[:3, :3] += GAUGE * torch.eye(3, dtype=ji.dtype, device=dev)
    delta = torch.linalg.solve(h.double(), rhs.reshape(-1).double())
    return delta.to(ji.dtype).reshape(n, 3)


def _lm(poses, node_mask, step, total_err, config: LMConfig, agree=list):
    """The LM loop (pose_graph_optimizer_lm.cpp:13-65) over one or more
    shards, lists as in :func:`_pcg`: ``step(poses, lam)`` gives
    (increment per shard, CG steps, host reads) and ``total_err(poses)``
    each shard's copy of the robust total error. Step -> total error ->
    convergence check -> lambda update; every step is applied, uphill
    ones too; only lambda reacts. Returns (poses, total error, LM steps,
    CG steps, host reads)."""
    f32 = torch.float32
    lam = [torch.full((), config.initial_lambda, dtype=f32, device=p.device)
           for p in poses]
    prev = [torch.full((), torch.finfo(f32).max, dtype=f32, device=p.device)
            for p in poses]
    iters = cg_steps = syncs = 0
    while True:
        delta, steps, reads = step(poses, lam)
        cg_steps += steps
        syncs += reads
        poses = _each(lambda p, d, m: p + d * m[:, None], poses, delta,
                      node_mask)
        err = total_err(poses)
        iters += 1
        converged = torch.abs(prev[0] - err[0]) < config.error_tolerance
        lam = _each(lambda l, e, pe: torch.where(e < pe, l * 0.5, l * 2.0),
                    lam, err, prev)
        prev = err
        syncs += 1
        if iters >= config.max_iterations or \
                not agree([not bool(device_mod.sync(
                    converged, site="lm_step"))])[0]:
            break
    return poses, prev[0], iters, cg_steps, syncs


def optimize(graph: GraphArrays, config: LMConfig,
             device=None) -> OptimizeResult:
    """Full LM loop (pose_graph_optimizer_lm.cpp:13-65) on ``device``
    (``None`` means ``cuda``)."""
    dev = device_mod.resolve(device)
    g = to_device(graph, dev)
    loss = robust_loss.create(config.loss_name, config.loss_scale)
    n = g.poses.shape[0]

    def step(poses, lam):
        poses, lam = poses[0], lam[0]
        ji, jj, winfo, _, _, b = _build_normal_terms(poses, g, loss)
        if config.solver == "dense":
            # One host read: the solver's singularity check.
            return [_dense_solve(-b, g, ji, jj, winfo, lam, n)], 0, 1
        diag = _block_diag(g, ji, jj, winfo, lam, n)
        if config.preconditioner == "chain":
            sub = _chain_subdiag(g, ji, jj, winfo, n)
            levels, dinv_f, npow = chain_factor(diag, sub)

            def precond(r):
                return chain_solve(levels, dinv_f, npow, r)
        else:
            diag_inv = _inv3(diag)

            def precond(r):
                return _mv(diag_inv, r)
        return _pcg([-b], lambda v: [_hv(v[0], g, ji, jj, winfo, lam)],
                    lambda r: [precond(r[0])],
                    lambda u, v: [(u[0] * v[0]).sum()],
                    config.cg_max_iterations, config.cg_tolerance)

    poses, err, iters, cg_steps, syncs = _lm(
        [g.poses], [g.node_mask], step,
        lambda p: [total_error(p[0], g, loss)], config)
    return OptimizeResult(poses=poses[0], total_error=err, iterations=iters,
                          cg_iterations=cg_steps, host_syncs=syncs)
