"""Sharded pose-graph solvers and the branch-and-bound fan-out.

Counterpart of ``my_lidar_graph_slam_tpu/parallel/distributed.py``. JAX
runs each function as one ``shard_map`` program; here each shard's work
is a step of a Python loop over this process's shards (``parallel/
mesh.py``), and every ``jax.lax.psum`` of the JAX package is one
``mesh.psum`` call at the same place, so the collective volume is the
JAX package's (``psum_bytes_per_cg_step``).

 * :func:`optimize_sharded`: LM with the CG solve sharded over EDGES.
   Poses are replicated; each shard computes its edges' partials of b,
   the block diagonal, the chain sub-diagonal, H v and the total error,
   and one psum completes each. Lambda and the gauge are added after the
   psum. Every shard factors the chain preconditioner redundantly.
 * :func:`partition_graph_by_nodes` (host NumPy) and
   :func:`optimize_sharded_nodes`: LM with contiguous NODE blocks per
   shard; the replicated cross edges (loop closures and chain crossings)
   are the only coupling, one [C, 2, 3] psum per CG step plus the scalar
   dot products.
 * :func:`branch_bound_fanout` and :func:`branch_bound_fanout_multi`: K
   candidate rows split over the shards, each shard running the Q-batched
   ``ops/matchers.py::branch_bound_match`` (K2 for the cost tail) on its
   block.

The CG and LM loops are ``models/optimizer_lm.py``'s ``_pcg`` and
``_lm``: host loops that stop on values every shard holds equally (the
psum'd residual and total error), with the decision itself agreed over
processes (``mesh.agree``). Each sharded call first checks that every
process calls it with the same shapes (``mesh.check_same``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from my_lidar_graph_slam_tpu_torch.models import optimizer_lm, robust_loss
from my_lidar_graph_slam_tpu_torch.models.optimizer_host import (GAUGE,
                                                                 LMConfig)
from my_lidar_graph_slam_tpu_torch.models.optimizer_lm import (
    OptimizeResult, _each, _mm, _mv, _quad, _t, chain_factor, chain_solve,
    pair_errors, pair_jacobians)
from my_lidar_graph_slam_tpu_torch.models.pose_graph import GraphArrays
from my_lidar_graph_slam_tpu_torch.ops import grid as gridops
from my_lidar_graph_slam_tpu_torch.ops import matchers
from my_lidar_graph_slam_tpu_torch.parallel import mesh as mesh_mod
from my_lidar_graph_slam_tpu_torch.parallel import multihost
from my_lidar_graph_slam_tpu_torch.parallel.mesh import Mesh, ShardedArray


def _eye(dev):
    return torch.eye(3, dtype=torch.float32, device=dev)


def optimize_sharded(graph: GraphArrays, config: LMConfig, mesh: Mesh,
                     axis: str = "shard") -> OptimizeResult:
    """LM loop with the CG solve sharded over edges (``optimize_sharded``
    of the JAX package, distributed.py:49-188).

    ``graph``: a host ``GraphArrays`` snapshot (every process passes the
    full one; the edge capacity must divide by the mesh's shard count),
    or one already placed by ``multihost.shard_edges_global``. The CG
    runs with the chain preconditioner whatever ``config.solver`` and
    ``config.preconditioner`` say, as in the JAX package. Returns the
    replicated poses f32[N_cap, 3] on the mesh's first device."""
    if not isinstance(graph.edge_i, ShardedArray):
        graph = multihost.shard_edges_global(mesh, axis, graph)
    loss = robust_loss.create(config.loss_name, config.loss_scale)
    n = graph.poses.shards[0].shape[0]
    mesh_mod.check_same(mesh, "optimize_sharded", n,
                        graph.edge_i.shards[0].shape[0])
    gs = [GraphArrays(None, None, ei.long(), ej.long(), rel, info, mask)
          for ei, ej, rel, info, mask in zip(
              graph.edge_i.shards, graph.edge_j.shards,
              graph.edge_rel.shards, graph.edge_info.shards,
              graph.edge_mask.shards)]

    def psum(parts):
        return mesh_mod.psum(mesh, parts)

    def step(poses, lam):
        terms = _each(lambda p, g: optimizer_lm._build_normal_terms(
            p, g, loss), poses, gs)
        ji, jj, winfo = ([t[k] for t in terms] for k in range(3))
        b = psum([t[5] for t in terms])
        diag = psum(_each(lambda g, a, c, w: optimizer_lm._diag_edges(
            g.edge_i, g.edge_j, a, c, w, n), gs, ji, jj, winfo))
        sub = psum(_each(lambda g, a, c, w: optimizer_lm._chain_subdiag(
            g, a, c, w, n), gs, ji, jj, winfo))

        def factor(d, s, lm):
            eye = _eye(d.device)
            d = d + lm * eye
            d[0] += GAUGE * eye
            return chain_factor(d, s)

        factors = _each(factor, diag, sub, lam)

        def hv(v):
            out = psum(_each(lambda v_, g, a, c, w: optimizer_lm._hv_edges(
                v_, g.edge_i, g.edge_j, a, c, w), v, gs, ji, jj, winfo))

            def finish(o, v_, lm):
                o = o + lm * v_
                o[0] += GAUGE * v_[0]
                return o
            return _each(finish, out, v, lam)

        return optimizer_lm._pcg(
            _each(torch.neg, b), hv,
            lambda r: _each(lambda f, r_: chain_solve(*f, r_), factors, r),
            lambda u, v: _each(lambda a, c: (a * c).sum(), u, v),
            config.cg_max_iterations, config.cg_tolerance,
            lambda flags: mesh_mod.agree(mesh, flags))

    def total_err(poses):
        return psum(_each(lambda p, g: optimizer_lm.total_error(p, g, loss),
                          poses, gs))

    poses, err, iters, cg_steps, syncs = optimizer_lm._lm(
        graph.poses.shards, graph.node_mask.shards, step, total_err, config,
        lambda flags: mesh_mod.agree(mesh, flags))
    return OptimizeResult(poses=poses[0], total_error=err, iterations=iters,
                          cg_iterations=cg_steps, host_syncs=syncs)


# ---------------------------------------------------------------------------
# Branch-and-bound fan-out
# ---------------------------------------------------------------------------


def branch_bound_fanout(pyramid, grid: gridops.GridMap, initial_poses,
                        ranges, angles, valid, scan_min_range, scan_max_range,
                        rel_sensor_poses, num_total_beams,
                        scan_range_max: float, range_theta: float,
                        usable_range_min: float, usable_range_max: float,
                        normalized_score_threshold: float, mesh: Mesh,
                        axis: str = "shard", node_height_max: int = 6,
                        win_x: int = 20, win_y: int = 20,
                        win_theta_max: int = 100,
                        frontier_cap: int = 4096) -> matchers.MatchSummary:
    """Match K candidate rows against one local map, the rows split over
    the mesh's shards (distributed.py:191-250 of the JAX package).

    ``initial_poses`` f32[K, 3], scan arrays [K, NB], per-row scalars
    (``num_total_beams`` among them: each row's threshold scales with its
    own beam count) f32[K], as tensors or NumPy; K must be a multiple of
    the shard count (pad with all-invalid rows, which score 0 and are
    never found). The pyramid and map are replicated to each shard's
    device. Each shard runs ``branch_bound_match`` on its contiguous
    block of K / D rows, with the matcher's default greedy parameters as
    in the JAX package. Returns a MatchSummary whose fields are
    :class:`ShardedArray` s split along K (``multihost.fetch_global``
    brings them to the host)."""
    if axis != mesh.axis:
        raise ValueError(f"unknown mesh axis {axis!r}")
    k = int(np.shape(initial_poses)[0])
    if k % mesh.num_shards:
        raise ValueError(f"{k} rows do not split over the "
                         f"{mesh.num_shards} shards of the mesh")
    per = k // mesh.num_shards
    mesh_mod.check_same(mesh, "branch_bound_fanout", k,
                        int(np.shape(ranges)[1]), *pyramid.shape)
    outs = []
    for dev, shard in zip(mesh.devices, mesh.local_shards):
        rows = slice(shard * per, (shard + 1) * per)
        args = [torch.as_tensor(x)[rows].to(dev) for x in (
            initial_poses, ranges, angles, valid, scan_min_range,
            scan_max_range, rel_sensor_poses, num_total_beams)]
        g = gridops.GridMap(grid.log_odds.to(dev), grid.observed.to(dev),
                            grid.origin.to(dev), grid.resolution)
        outs.append(matchers.branch_bound_match(
            pyramid.to(dev), g, *args[:7], float(scan_range_max),
            float(range_theta), float(usable_range_min),
            float(usable_range_max), float(normalized_score_threshold),
            args[7], node_height_max=node_height_max, win_x=win_x,
            win_y=win_y, win_theta_max=win_theta_max,
            frontier_cap=frontier_cap))
    return matchers.MatchSummary(*(
        ShardedArray(mesh, list(field), 0) for field in zip(*outs)))


def branch_bound_fanout_multi(pyramids, grids, initial_poses, ranges,
                              angles, valid, scan_min_range, scan_max_range,
                              rel_sensor_poses, num_total_beams,
                              scan_range_max: float, range_theta: float,
                              usable_range_min: float,
                              usable_range_max: float,
                              normalized_score_threshold: float, mesh: Mesh,
                              axis: str = "shard", node_height_max: int = 6,
                              win_x: int = 20, win_y: int = 20,
                              win_theta_max: int = 100,
                              frontier_cap: int = 4096
                              ) -> matchers.MatchSummary:
    """M candidate maps' fan-outs (distributed.py:253-293 of the JAX
    package): ``pyramids[c]`` and ``grids[c]`` (a list of M GridMaps) are
    candidate c's; the row arrays have leading axes [M, K]. Loops over the
    candidates as the JAX package does; returns a MatchSummary of
    :class:`ShardedArray` s of shape [M, K, ...], split along K."""
    outs = [branch_bound_fanout(
        pyramids[c], grids[c], initial_poses[c], ranges[c], angles[c],
        valid[c], scan_min_range[c], scan_max_range[c], rel_sensor_poses[c],
        num_total_beams[c], scan_range_max, range_theta, usable_range_min,
        usable_range_max, normalized_score_threshold, mesh=mesh, axis=axis,
        node_height_max=node_height_max, win_x=win_x, win_y=win_y,
        win_theta_max=win_theta_max, frontier_cap=frontier_cap)
        for c in range(len(grids))]
    return matchers.MatchSummary(*(
        ShardedArray(mesh, [torch.stack(s) for s in zip(*(
            o.shards for o in field))], 1)
        for field in zip(*outs)))


# ---------------------------------------------------------------------------
# Node-sharded LM solve (O(N/D + boundary) memory and comm per shard)
# ---------------------------------------------------------------------------


class NodeShardedGraph(NamedTuple):
    """Pose graph partitioned into contiguous node blocks
    (distributed.py:301-328 of the JAX package). SE(2) pose graphs are
    chain-dominated, so contiguous blocks make almost every edge LOCAL to
    one shard; the only cross-shard edges are the D-1 chain crossings and
    the loop-closure edges. Leading axis D is the shard axis; the cross
    edge arrays are replicated. Host NumPy."""

    poses: np.ndarray        # f32[D, NB, 3]
    node_mask: np.ndarray    # bool[D, NB]
    l_i: np.ndarray          # i32[D, EL] local edge endpoint offsets
    l_j: np.ndarray          # i32[D, EL]
    l_rel: np.ndarray        # f32[D, EL, 3]
    l_info: np.ndarray       # f32[D, EL, 3, 3]
    l_mask: np.ndarray       # bool[D, EL]
    c_bi: np.ndarray         # i32[C] block of endpoint i
    c_oi: np.ndarray         # i32[C] offset of endpoint i
    c_bj: np.ndarray         # i32[C]
    c_oj: np.ndarray         # i32[C]
    c_rel: np.ndarray        # f32[C, 3]
    c_info: np.ndarray       # f32[C, 3, 3]
    c_mask: np.ndarray       # bool[C]


def _pad_pow2(n: int, minimum: int = 8) -> int:
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


def partition_graph_by_nodes(graph: GraphArrays,
                             n_devices: int) -> NodeShardedGraph:
    """Host-side partition of a GraphArrays snapshot into ``n_devices``
    node blocks (distributed.py:338-404 of the JAX package, array for
    array)."""
    d = n_devices
    node_mask = np.asarray(graph.node_mask, bool)
    emask = np.asarray(graph.edge_mask, bool)
    n_cap = node_mask.shape[0]
    nb = -(-n_cap // d)
    n_pad = d * nb

    poses = np.zeros((n_pad, 3), np.float32)
    poses[:n_cap] = np.asarray(graph.poses, np.float32)
    nmask = np.zeros((n_pad,), bool)
    nmask[:n_cap] = node_mask

    ei = np.asarray(graph.edge_i, np.int64)[emask]
    ej = np.asarray(graph.edge_j, np.int64)[emask]
    rel = np.asarray(graph.edge_rel, np.float32)[emask]
    info = np.asarray(graph.edge_info, np.float32)[emask]
    bi = ei // nb
    bj = ej // nb
    local = bi == bj

    # Local edges, bucketed per shard in edge order.
    el_counts = np.bincount(bi[local], minlength=d)
    el = _pad_pow2(max(int(el_counts.max(initial=0)), 1))
    l_i = np.zeros((d, el), np.int32)
    l_j = np.zeros((d, el), np.int32)
    l_rel = np.zeros((d, el, 3), np.float32)
    l_info = np.zeros((d, el, 3, 3), np.float32)
    l_mask = np.zeros((d, el), bool)
    idx = np.flatnonzero(local)
    dev = bi[idx]
    # Position of each local edge within its shard, in edge order.
    order = np.argsort(dev, kind="stable")
    starts = np.concatenate([[0], np.cumsum(el_counts)[:-1]])
    pos = np.empty_like(dev)
    pos[order] = np.arange(len(idx)) - starts[dev[order]]
    l_i[dev, pos] = ei[idx] - dev * nb
    l_j[dev, pos] = ej[idx] - dev * nb
    l_rel[dev, pos] = rel[idx]
    l_info[dev, pos] = info[idx]
    l_mask[dev, pos] = True

    # Cross edges, replicated (few: loop closures + chain crossings).
    cross = np.flatnonzero(~local)
    c = _pad_pow2(max(len(cross), 1))
    nc = len(cross)
    c_bi = np.zeros((c,), np.int32)
    c_oi = np.zeros((c,), np.int32)
    c_bj = np.zeros((c,), np.int32)
    c_oj = np.zeros((c,), np.int32)
    c_rel = np.zeros((c, 3), np.float32)
    c_info = np.zeros((c, 3, 3), np.float32)
    c_mask = np.zeros((c,), bool)
    c_bi[:nc] = bi[cross]
    c_oi[:nc] = ei[cross] - bi[cross] * nb
    c_bj[:nc] = bj[cross]
    c_oj[:nc] = ej[cross] - bj[cross] * nb
    c_rel[:nc] = rel[cross]
    c_info[:nc] = info[cross]
    c_mask[:nc] = True

    return NodeShardedGraph(
        poses=poses.reshape(d, nb, 3),
        node_mask=nmask.reshape(d, nb),
        l_i=l_i, l_j=l_j, l_rel=l_rel, l_info=l_info, l_mask=l_mask,
        c_bi=c_bi, c_oi=c_oi, c_bj=c_bj, c_oj=c_oj,
        c_rel=c_rel, c_info=c_info, c_mask=c_mask)


def psum_bytes_per_cg_step(sharded: NodeShardedGraph) -> int:
    """Collective volume per CG iteration as the JAX package counts it:
    two [C, 3] endpoint-value exchanges plus two scalars, O(boundary),
    independent of N. (The loop also psums a third scalar per step, the
    residual of its stopping test.)"""
    c = sharded.c_bi.shape[0]
    return 2 * c * 3 * 4 + 2 * 4


def optimize_sharded_nodes(sharded: NodeShardedGraph, config: LMConfig,
                           mesh: Mesh, axis: str = "shard"
                           ) -> OptimizeResult:
    """LM solve with NODE BLOCKS sharded across the mesh
    (distributed.py:414-633 of the JAX package).

    Each shard owns a contiguous block of poses and every edge interior
    to it; the replicated cross edges are the only coupling. Per CG step
    the collectives are one [C, 2, 3] psum (the cross edges' endpoint
    values, each from the shard that owns it) and the scalar dot
    products. The preconditioner is the per-shard chain cyclic reduction
    over the LOCAL odometric couplings (``sub[0] = 0`` in every shard);
    the gauge is added on global shard 0 only; each cross edge's error
    counts once, on the owner of its endpoint i. Returns the poses as a
    :class:`ShardedArray` [D * NB, 3] split over the shards
    (``multihost.fetch_global`` reads them)."""
    if axis != mesh.axis:
        raise ValueError(f"unknown mesh axis {axis!r}")
    d, nb, _ = np.shape(sharded.poses)
    if d != mesh.num_shards:
        raise ValueError(f"a graph partitioned into {d} blocks on a mesh "
                         f"of {mesh.num_shards} shards")
    c = int(np.shape(sharded.c_bi)[0])
    mesh_mod.check_same(mesh, "optimize_sharded_nodes", d, nb,
                        int(np.shape(sharded.l_i)[1]), c)
    loss = robust_loss.create(config.loss_name, config.loss_scale)
    f32, i64 = torch.float32, torch.int64
    devs = mesh.devices
    shards = list(mesh.local_shards)

    def up(x, dtype, dev, shard=None):
        x = np.asarray(x)
        return torch.as_tensor(x if shard is None else x[shard]).to(
            device=dev, dtype=dtype)

    local = [GraphArrays(None, None, up(sharded.l_i, i64, dv, s),
                         up(sharded.l_j, i64, dv, s),
                         up(sharded.l_rel, f32, dv, s),
                         up(sharded.l_info, f32, dv, s),
                         up(sharded.l_mask, torch.bool, dv, s))
             for dv, s in zip(devs, shards)]
    cross = [(up(sharded.c_oi, i64, dv), up(sharded.c_oj, i64, dv),
              up(sharded.c_rel, f32, dv), up(sharded.c_info, f32, dv),
              up(sharded.c_mask, torch.bool, dv),
              up(sharded.c_bi, i64, dv) == s, up(sharded.c_bj, i64, dv) == s)
             for dv, s in zip(devs, shards)]
    first = [s == 0 for s in shards]

    def psum(parts):
        return mesh_mod.psum(mesh, parts)

    def cross_vals(v):
        """The cross edges' endpoint values [C, 2, 3] on every shard."""
        def part(v_, cx):
            oi, oj, _, _, _, own_i, own_j = cx
            return torch.stack([torch.where(own_i[:, None], v_[oi], 0.0),
                                torch.where(own_j[:, None], v_[oj], 0.0)],
                               dim=1)
        return psum(_each(part, v, cross))

    def cross_terms(pc, cx):
        _, _, rel, info, mask, _, _ = cx
        err = pair_errors(pc[:, 0], pc[:, 1], rel)
        ji, jj = pair_jacobians(pc[:, 0], pc[:, 1])
        sq = _quad(err, info)
        w = torch.where(mask, loss.weight(sq), torch.zeros_like(sq))
        return err, ji, jj, w[:, None, None] * info

    def scatter_cross(out, ci, cj, cx):
        """Add the endpoint contributions of the cross edges this shard
        owns ([C, 3] vectors or [C, 3, 3] blocks)."""
        oi, oj, _, _, _, own_i, own_j = cx
        shape = (-1,) + (1,) * (ci.dim() - 1)
        out = out.index_add(0, oi, torch.where(own_i.reshape(shape), ci, 0.0))
        return out.index_add(0, oj, torch.where(own_j.reshape(shape), cj,
                                                0.0))

    def step(poses, lam):
        terms_l = _each(lambda p, g: optimizer_lm._build_normal_terms(
            p, g, loss), poses, local)
        pc = cross_vals(poses)
        terms_c = _each(cross_terms, pc, cross)

        def rhs(tl, tc, cx):
            errc, jic, jjc, winfoc = tc
            b = scatter_cross(tl[5], _mv(_mm(_t(jic), winfoc), errc),
                              _mv(_mm(_t(jjc), winfoc), errc), cx)
            return -b

        def factor(tl, tc, g, cx, lm, is_first):
            ji, jj, winfo = tl[:3]
            _, jic, jjc, winfoc = tc
            diag = optimizer_lm._diag_edges(g.edge_i, g.edge_j, ji, jj,
                                            winfo, nb)
            diag = scatter_cross(diag, _mm(_mm(_t(jic), winfoc), jic),
                                 _mm(_mm(_t(jjc), winfoc), jjc), cx)
            eye = _eye(diag.device)
            diag = diag + lm * eye
            if is_first:
                diag[0] += GAUGE * eye
            # Per-shard chain: local odometric couplings (j == i + 1).
            sub = optimizer_lm._chain_subdiag(g, ji, jj, winfo, nb)
            return chain_factor(diag, sub)

        factors = _each(factor, terms_l, terms_c, local, cross, lam, first)

        def hv(v):
            vc = cross_vals(v)

            def one(v_, vc_, tl, tc, g, cx, lm, is_first):
                ji, jj, winfo = tl[:3]
                _, jic, jjc, winfoc = tc
                out = optimizer_lm._hv_edges(v_, g.edge_i, g.edge_j, ji, jj,
                                             winfo)
                tcv = _mv(winfoc, _mv(jic, vc_[:, 0]) + _mv(jjc, vc_[:, 1]))
                out = scatter_cross(out, _mv(_t(jic), tcv),
                                    _mv(_t(jjc), tcv), cx)
                out = out + lm * v_
                if is_first:
                    out[0] += GAUGE * v_[0]
                return out
            return _each(one, v, vc, terms_l, terms_c, local, cross, lam,
                         first)

        return optimizer_lm._pcg(
            _each(rhs, terms_l, terms_c, cross), hv,
            lambda r: _each(lambda f, r_: chain_solve(*f, r_), factors, r),
            lambda u, v: psum(_each(lambda a, b: (a * b).sum(), u, v)),
            config.cg_max_iterations, config.cg_tolerance,
            lambda flags: mesh_mod.agree(mesh, flags))

    def total_err(poses):
        pc = cross_vals(poses)

        def one(p, pc_, g, cx):
            _, _, rel, info, mask, own_i, _ = cx
            e = optimizer_lm.total_error(p, g, loss)
            sqc = _quad(pair_errors(pc_[:, 0], pc_[:, 1], rel), info)
            # Each cross edge once: on the owner of endpoint i.
            return e + torch.where(mask & own_i, loss.loss(sqc),
                                   torch.zeros_like(sqc)).sum()
        return psum(_each(one, poses, pc, local, cross))

    poses0 = [up(sharded.poses, f32, dv, s) for dv, s in zip(devs, shards)]
    nmask = [up(sharded.node_mask, torch.bool, dv, s)
             for dv, s in zip(devs, shards)]
    poses, err, iters, cg_steps, syncs = optimizer_lm._lm(
        poses0, nmask, step, total_err, config,
        lambda flags: mesh_mod.agree(mesh, flags))
    return OptimizeResult(poses=ShardedArray(mesh, poses, 0),
                          total_error=err, iterations=iters,
                          cg_iterations=cg_steps, host_syncs=syncs)
