"""Scan matchers: the result type, shared helpers and four strategies.

Counterpart of ``my_lidar_graph_slam_tpu/ops/matchers.py:51-118,625-1165``
(``MatchSummary``, ``search_step_theta``, ``static_max_theta_window``,
``_range_gate``, ``_cost_and_covariance`` and the grid-search,
branch-and-bound, hill-climbing and linear-solver matchers). The
correlative matcher lives in ``matchers_sweep.py``; the pruned and brute
correlative batches are not ported yet.

Every matcher here takes a leading query axis Q, so one function serves
both the JAX package's single and ``_batch`` forms; per-query scalars
(scan ranges, ``num_total_beams``) are f32[Q]. The greedy-endpoint cost
and covariance at the best pose go through
``ops/cuda/greedy_cost.py::greedy_cost_cov``: the K2 kernel on a CUDA
tensor, its plain version on a CPU tensor.

Host synchronization: grid search and branch-and-bound read nothing back
(their level and chunk loops are static); hill climbing and the linear
solver loop on data and read one flag per step, counted in the
``host_syncs`` attribute of each function.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from my_lidar_graph_slam_tpu_torch.ops import cost as costops
from my_lidar_graph_slam_tpu_torch.ops import grid as gridops
from my_lidar_graph_slam_tpu_torch.ops import scoring
from my_lidar_graph_slam_tpu_torch.ops.cuda import greedy_cost
from my_lidar_graph_slam_tpu_torch.utils import se2

# Most (query, candidate, beam) reads the grid search holds at once: the
# lattice is scored in chunks of whole dy rows under this size.
GRID_CHUNK_ELEMS = 1 << 24


class MatchSummary(NamedTuple):
    """Mirror of ScanMatchingSummary (scan_matcher.hpp:47-77): the
    estimated pose is the ROBOT pose in the world frame, the covariance is
    world-frame. Fields carry a leading query axis."""

    pose_found: torch.Tensor        # bool[Q]
    normalized_cost: torch.Tensor   # f32[Q]
    normalized_score: torch.Tensor  # f32[Q] best score / total beams
    initial_pose: torch.Tensor      # f32[Q, 3] robot pose
    estimated_pose: torch.Tensor    # f32[Q, 3] robot pose
    covariance: torch.Tensor        # f32[Q, 3, 3] world frame
    # Exactness signal (branch_bound_match only): live frontier nodes
    # dropped by the per-level quota, over all levels. The reference DFS
    # is exact (scan_matcher_branch_bound.cpp:81-139); a nonzero count
    # means the batched search MAY have pruned the true optimum.
    frontier_overflow: torch.Tensor  # i64[Q]


def search_step_theta(resolution: torch.Tensor, max_range: torch.Tensor
                      ) -> torch.Tensor:
    """Angular step from the cosine law: acos(1 - res^2 / (2 r^2))
    (scan_matcher_real_time_correlative.cpp:156-175), in float32 with the
    JAX package's operation order: near 1 the argument's last bit moves
    the whole theta lattice."""
    t = resolution / max_range
    return torch.arccos(1.0 - 0.5 * t * t)


def static_max_theta_window(resolution: float, scan_range_max: float,
                            range_theta: float) -> int:
    """Static upper bound for the theta half-window: the step is smallest
    when the scan's max range equals ``scan_range_max``."""
    t = resolution / scan_range_max
    step = math.acos(1.0 - 0.5 * t * t)
    return int(math.ceil(0.5 * range_theta / step))


def range_gate(valid, ranges, usable_range_min, usable_range_max,
               scan_min_range, scan_max_range):
    """Combined usable-range/scan-range beam gate
    (score_function_pixel_accurate.cpp:27-41)."""
    min_r = torch.clamp(scan_min_range, min=usable_range_min)
    max_r = torch.clamp(scan_max_range, max=usable_range_max)
    return valid & (ranges > min_r) & (ranges < max_r)


def _cost_and_covariance(cost_type, value_map, grid: gridops.GridMap,
                         best_sensor_poses, ranges, angles, cost_mask,
                         greedy_params):
    """Cost f32[Q] and covariance f32[Q, 3, 3] at the best sensor poses
    f32[Q, 3] (``cost_mask`` bool[Q, NB])."""
    if cost_type == "square_error":
        c = costops.square_error_cost(value_map, grid, best_sensor_poses,
                                      ranges, angles, cost_mask)
        cov = costops.square_error_covariance(
            value_map, grid, best_sensor_poses, ranges, angles, cost_mask)
        return c, cov
    if cost_type != "greedy_endpoint":
        raise ValueError(f"unknown cost type {cost_type!r}")
    return greedy_cost.greedy_cost_cov(
        value_map, grid.origin, best_sensor_poses, ranges, angles,
        cost_mask, grid.resolution, **dict(greedy_params))


def _summary(found, cost, score, n_total, initial_poses, best_sensor_poses,
             rel_sensor_poses, cov, overflow=None) -> MatchSummary:
    if overflow is None:
        overflow = torch.zeros_like(found, dtype=torch.int64)
    return MatchSummary(
        pose_found=found,
        normalized_cost=cost / n_total,
        normalized_score=score / n_total,
        initial_pose=initial_poses,
        estimated_pose=se2.move_backward(best_sensor_poses, rel_sensor_poses),
        covariance=cov,
        frontier_overflow=overflow)


# ---------------------------------------------------------------------------
# Exhaustive grid search
# ---------------------------------------------------------------------------


def grid_search_match(value_map, grid: gridops.GridMap, initial_poses,
                      ranges, angles, valid, scan_min_range, scan_max_range,
                      rel_sensor_poses, usable_range_min: float,
                      usable_range_max: float,
                      normalized_score_threshold: float,
                      step_x: float, step_y: float, step_t: float,
                      num_total_beams, nx: int, ny: int, nt: int,
                      cost_type: str = "greedy_endpoint",
                      greedy_params: tuple = ()) -> MatchSummary:
    """Q exhaustive searches over a (dy, dx, dt) lattice against one map
    (scan_matcher_grid_search.cpp:45-114; ``_grid_search_core``,
    ``grid_search_match`` and ``grid_search_match_batch`` of the JAX
    package).

    Offsets are ``(i - n // 2) * step`` per axis. The lattice is scored in
    chunks of whole dy rows (at most ``GRID_CHUNK_ELEMS`` reads each), in
    the reference's loop order (dy outer, dx middle, dt inner); each chunk
    keeps its first maximum and a later chunk replaces the best only when
    strictly greater, so the first maximum of the whole lattice wins, as
    in the unchunked argmax.
    """
    dev = ranges.device
    q, nb = ranges.shape
    f32 = torch.float32
    n_total = num_total_beams.to(f32)
    sensor_poses = se2.compound(initial_poses, rel_sensor_poses)
    score_mask = range_gate(valid, ranges, usable_range_min,
                            usable_range_max, scan_min_range[:, None],
                            scan_max_range[:, None])

    dy = (torch.arange(ny, device=dev) - ny // 2).to(f32) * step_y
    dx = (torch.arange(nx, device=dev) - nx // 2).to(f32) * step_x
    dt = (torch.arange(nt, device=dev) - nt // 2).to(f32) * step_t
    xs = sensor_poses[:, 0, None] + dx                          # [Q, nx]
    ys = sensor_poses[:, 1, None] + dy                          # [Q, ny]
    ts = sensor_poses[:, 2, None] + dt                          # [Q, nt]

    row = nx * nt
    rows = max(1, GRID_CHUNK_ELEMS // max(1, q * row * nb))
    best_score = torch.full((q,), -torch.inf, dtype=f32, device=dev)
    best_idx = torch.zeros((q,), dtype=torch.int64, device=dev)
    beam = (slice(None), None, None, None, slice(None))
    for y0 in range(0, ny, rows):
        y1 = min(ny, y0 + rows)
        cand = torch.stack([
            xs[:, None, :, None].expand(q, y1 - y0, nx, nt),
            ys[:, y0:y1, None, None].expand(q, y1 - y0, nx, nt),
            ts[:, None, None, :].expand(q, y1 - y0, nx, nt)], dim=-1)
        score = scoring.score_poses(value_map, grid, cand, ranges[beam],
                                    angles[beam], score_mask[beam],
                                    1.0).score.reshape(q, -1)
        idx = torch.argmax(score, dim=1)
        val = torch.gather(score, 1, idx[:, None])[:, 0]
        better = val > best_score
        best_idx = torch.where(better, idx + y0 * row, best_idx)
        best_score = torch.where(better, val, best_score)

    iy, rem = best_idx // row, best_idx % row
    best_poses = torch.stack([
        torch.gather(xs, 1, (rem // nt)[:, None])[:, 0],
        torch.gather(ys, 1, iy[:, None])[:, 0],
        torch.gather(ts, 1, (rem % nt)[:, None])[:, 0]], dim=-1)
    found = best_score > normalized_score_threshold * n_total
    c, cov = _cost_and_covariance(cost_type, value_map, grid, best_poses,
                                  ranges, angles, score_mask, greedy_params)
    return _summary(found, c, best_score, n_total, initial_poses,
                    best_poses, rel_sensor_poses, cov)


# ---------------------------------------------------------------------------
# Branch-and-bound
# ---------------------------------------------------------------------------


def branch_bound_match(pyramid, grid: gridops.GridMap, initial_poses,
                       ranges, angles, valid, scan_min_range, scan_max_range,
                       rel_sensor_poses, scan_range_max: float,
                       range_theta: float, usable_range_min: float,
                       usable_range_max: float,
                       normalized_score_threshold: float, num_total_beams,
                       node_height_max: int, win_x: int, win_y: int,
                       win_theta_max: int, frontier_cap: int = 4096,
                       cost_type: str = "greedy_endpoint",
                       greedy_params: tuple = ()) -> MatchSummary:
    """Level-synchronous branch-and-bound over the map pyramid for Q
    queries (``branch_bound_match`` and ``branch_bound_match_batch`` of
    the JAX package, ``matchers.py:757-977``; the threshold scales with
    each query's ``num_total_beams``).

    ``pyramid``: f32[node_height_max + 1, H, W] from
    ``ops/pyramid.py::build_pyramid`` — level h at a cell bounds the max
    fine score over the 2^h x 2^h block starting there
    (grid_map_builder.cpp:471-536), which makes coarse scores valid upper
    bounds (scan_matcher_branch_bound.cpp:92-139).

    Each level scores the whole frontier at once, prunes by the score
    threshold and by the best leaf-level lower bound seen so far (each
    node's origin-corner score at level 0), keeps at most
    ``frontier_cap // 4`` nodes in frontier order and splits each into 4
    children (scan_matcher_branch_bound.cpp:122-138). As in the
    reference, children are not clipped to the search window. Frontier
    sizes depend only on the window and ``frontier_cap``, so the loop
    reads nothing back from the device.
    """
    dev = ranges.device
    q = ranges.shape[0]
    f32 = torch.float32
    n_total = num_total_beams.to(f32)
    sensor_poses = se2.compound(initial_poses, rel_sensor_poses)

    max_range = torch.clamp(
        torch.where(valid, ranges, torch.full_like(ranges, -torch.inf)
                    ).amax(dim=-1), max=scan_range_max)
    res = gridops.scalar(grid.resolution, dev)
    step_t = search_step_theta(res, max_range)                   # [Q]
    # An all-invalid row has step 0: every theta stays live, as the
    # saturating conversion of the JAX package leaves it.
    win_theta_act = torch.ceil(
        0.5 * gridops.scalar(range_theta, dev) / step_t)
    score_mask = range_gate(valid, ranges, usable_range_min,
                            usable_range_max, scan_min_range[:, None],
                            scan_max_range[:, None])
    score_threshold = normalized_score_threshold * n_total       # [Q]

    # Initial frontier: x/y on the 2^H lattice covering [-win, +win], all
    # thetas within the static bound (scan_matcher_branch_bound.cpp:81-88),
    # in (x, y, theta) order.
    step = 1 << node_height_max
    gx, gy, gt = torch.meshgrid(
        torch.arange(-win_x, win_x + 1, step, device=dev),
        torch.arange(-win_y, win_y + 1, step, device=dev),
        torch.arange(-win_theta_max, win_theta_max + 1, device=dev),
        indexing="ij")
    n0 = gx.numel()
    fx, fy, ft = (a.reshape(1, n0).expand(q, n0) for a in (gx, gy, gt))
    alive = ft.abs().to(f32) <= win_theta_act[:, None]
    cap = max(frontier_cap, n0)

    def node_poses(xs, ys, ts):
        return torch.stack([
            sensor_poses[:, 0, None] + xs.to(f32) * grid.resolution,
            sensor_poses[:, 1, None] + ys.to(f32) * grid.resolution,
            sensor_poses[:, 2, None] + ts.to(f32) * step_t[:, None],
        ], dim=-1)                                               # [Q, S, 3]

    def eval_level(level_map, mask):
        s = scoring.score_poses(level_map, grid, node_poses(fx, fy, ft),
                                ranges[:, None, :], angles[:, None, :],
                                score_mask[:, None, :], 1.0).score
        return torch.where(mask, s, torch.full_like(s, -torch.inf))

    best_score = score_threshold.clone()
    best_node = torch.zeros((q, 3), dtype=torch.int64, device=dev)
    found = torch.zeros((q,), dtype=torch.bool, device=dev)
    overflow = torch.zeros((q,), dtype=torch.int64, device=dev)
    for h in range(node_height_max, -1, -1):
        ub = eval_level(pyramid[h], alive)                       # upper
        if h == 0:
            leaf = torch.argmax(ub, dim=1)                       # first max
            leaf_score = torch.gather(ub, 1, leaf[:, None])[:, 0]
            improved = leaf_score > best_score
            best_score = torch.where(improved, leaf_score, best_score)
            node = torch.stack([torch.gather(a, 1, leaf[:, None])[:, 0]
                                for a in (fx, fy, ft)], dim=-1)
            best_node = torch.where(improved[:, None], node, best_node)
            found = found | improved
            break
        lb = eval_level(pyramid[0], alive)                       # lower
        best_lb = torch.maximum(lb.amax(dim=1), score_threshold)
        keep = alive & (ub > best_lb[:, None]) & \
            (ub > score_threshold[:, None])
        size = fx.shape[1]
        kquota = min(size, cap // 4)
        keep_count = keep.sum(dim=1)
        # Live nodes beyond the quota are dropped even though their upper
        # bound beats the best lower bound: the reference DFS would have
        # expanded them.
        overflow = overflow + torch.clamp(keep_count - kquota, min=0)
        if kquota == size:
            sel_ok, sx, sy, st = keep, fx, fy, ft
        else:
            # Compact the live nodes to the front in frontier order
            # (cumsum + scatter); rows past the quota go to a dump slot.
            pos = torch.cumsum(keep.to(torch.int64), dim=1) - 1
            slot = torch.where(keep & (pos < kquota), pos,
                               torch.full_like(pos, kquota))
            order = torch.zeros((q, kquota + 1), dtype=torch.int64,
                                device=dev).scatter_(
                1, slot, torch.arange(size, device=dev).expand(q, size)
            )[:, :kquota]
            sel_ok = torch.arange(kquota, device=dev)[None, :] < \
                torch.clamp(keep_count, max=kquota)[:, None]
            sx, sy, st = (torch.gather(a, 1, order) for a in (fx, fy, ft))
        w = 1 << (h - 1)
        kq = sx.shape[1]
        child = torch.arange(4, device=dev)       # (0, 0) (w, 0) (0, w) (w, w)
        child_dx = child % 2 * w
        child_dy = child // 2 * w
        fx = (sx[:, :, None] + child_dx).reshape(q, 4 * kq)
        fy = (sy[:, :, None] + child_dy).reshape(q, 4 * kq)
        ft = st[:, :, None].expand(q, kq, 4).reshape(q, 4 * kq)
        alive = sel_ok[:, :, None].expand(q, kq, 4).reshape(q, 4 * kq)

    best_sensor_poses = torch.where(
        found[:, None],
        node_poses(best_node[:, 0, None], best_node[:, 1, None],
                   best_node[:, 2, None])[:, 0], sensor_poses)
    c, cov = _cost_and_covariance(cost_type, pyramid[0], grid,
                                  best_sensor_poses, ranges, angles,
                                  score_mask, greedy_params)
    return _summary(found, c, best_score, n_total, initial_poses,
                    best_sensor_poses, rel_sensor_poses, cov, overflow)


# ---------------------------------------------------------------------------
# Hill climbing
# ---------------------------------------------------------------------------


def hill_climbing_match(value_map, grid: gridops.GridMap, initial_poses,
                        ranges, angles, valid, scan_min_range,
                        scan_max_range, rel_sensor_poses,
                        usable_range_min: float, usable_range_max: float,
                        num_total_beams, linear_step: float = 0.1,
                        angular_step: float = 0.1,
                        max_iterations: int = 100,
                        max_refinements: int = 5,
                        cost_type: str = "greedy_endpoint",
                        greedy_params: tuple = ()) -> MatchSummary:
    """Greedy six-direction descent with step halving for Q queries
    (scan_matcher_hill_climbing.cpp:26-109).

    The JAX package's ``lax.while_loop`` becomes a host loop that reads one
    flag per step (counted in ``hill_climbing_match.host_syncs``); a query
    whose loop has ended keeps its state, so each query's iterate equals
    the JAX loop's.
    """
    dev = ranges.device
    f32 = torch.float32
    n_total = num_total_beams.to(f32)
    sensor_poses = se2.compound(initial_poses, rel_sensor_poses)
    cost_mask = range_gate(valid, ranges, usable_range_min,
                           usable_range_max, scan_min_range[:, None],
                           scan_max_range[:, None])
    gp = dict(greedy_params)
    beam = (slice(None), None, slice(None))

    def cost_fn(poses):                                   # [Q, P, 3]
        args = (value_map, grid, poses, ranges[beam], angles[beam],
                cost_mask[beam])
        if cost_type == "square_error":
            return costops.square_error_cost(*args)
        return costops.greedy_endpoint_cost(*args, **gp)

    moves = torch.tensor([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0],
                          [0.0, 1.0, 0.0], [0.0, -1.0, 0.0],
                          [0.0, 0.0, 1.0], [0.0, 0.0, -1.0]], device=dev)
    q = ranges.shape[0]
    best_pose = sensor_poses
    best_cost = cost_fn(sensor_poses[:, None, :])[:, 0]
    lin = torch.full((q,), linear_step, dtype=f32, device=dev)
    ang = torch.full((q,), angular_step, dtype=f32, device=dev)
    refinements = torch.zeros((q,), dtype=torch.int64, device=dev)
    updated = torch.ones((q,), dtype=torch.bool, device=dev)
    for _ in range(max_iterations):
        active = updated | (refinements < max_refinements)
        hill_climbing_match.host_syncs += 1
        if not bool(active.any()):
            break
        scale = torch.stack([lin, lin, ang], dim=-1)
        cand = best_pose[:, None, :] + moves * scale[:, None, :]
        costs = cost_fn(cand)                             # [Q, 6]
        local = torch.argmin(costs, dim=1)
        local_cost = torch.gather(costs, 1, local[:, None])[:, 0]
        improved = local_cost < best_cost
        step_ok = active & improved
        best_pose = torch.where(
            step_ok[:, None],
            torch.gather(cand, 1, local[:, None, None].expand(q, 1, 3))[:, 0],
            best_pose)
        best_cost = torch.where(step_ok, local_cost, best_cost)
        shrink = active & ~improved
        lin = torch.where(shrink, lin * 0.5, lin)
        ang = torch.where(shrink, ang * 0.5, ang)
        refinements = refinements + shrink.to(torch.int64)
        updated = torch.where(active, improved, updated)

    _, cov = _cost_and_covariance(cost_type, value_map, grid, best_pose,
                                  ranges, angles, cost_mask, greedy_params)
    return _summary(torch.ones((q,), dtype=torch.bool, device=dev),
                    best_cost, torch.zeros((q,), dtype=f32, device=dev),
                    n_total, initial_poses, best_pose, rel_sensor_poses,
                    cov)


hill_climbing_match.host_syncs = 0


# ---------------------------------------------------------------------------
# Gauss-Newton (linear solver)
# ---------------------------------------------------------------------------


def linear_solver_match(value_map, grid: gridops.GridMap, initial_poses,
                        ranges, angles, valid, scan_min_range,
                        scan_max_range, rel_sensor_poses,
                        usable_range_min: float, usable_range_max: float,
                        num_total_beams,
                        translation_regularizer: float = 1e-3,
                        rotation_regularizer: float = 1e-3,
                        convergence_threshold: float = 1e-3,
                        max_iterations: int = 100) -> MatchSummary:
    """Iterative Gauss-Newton on the bicubic-smoothed map for Q queries
    (scan_matcher_linear_solver.cpp:38-148).

    A host loop that reads one flag per step (counted in
    ``linear_solver_match.host_syncs``); a finished query keeps its state.
    The 3x3 normal matrix is a multiply-and-sum, so it stays float32
    whatever the caller's TF32 setting.
    """
    dev = ranges.device
    f32 = torch.float32
    q = ranges.shape[0]
    n_total = num_total_beams.to(f32)
    sensor_poses = se2.compound(initial_poses, rel_sensor_poses)
    mask = range_gate(valid, ranges, usable_range_min, usable_range_max,
                      scan_min_range[:, None],
                      scan_max_range[:, None]).to(f32)
    reg = torch.diag(torch.tensor(
        [translation_regularizer, translation_regularizer,
         rotation_regularizer], dtype=f32, device=dev))

    def gn_step(pose):
        world_angle = pose[:, 2:3] + angles
        cos_t = torch.cos(world_angle)
        sin_t = torch.sin(world_angle)
        hx = pose[:, 0:1] + ranges * cos_t
        hy = pose[:, 1:2] + ranges * sin_t
        pts = torch.stack([hx, hy], dim=-1)
        fx, fy = gridops.world_to_cell_float(grid, pts)
        resid = (1.0 - costops.smoothed_value(value_map, fx, fy)) * mask
        g = costops.map_gradient(value_map, grid, pts)           # [Q, NB, 2]
        g_theta = -ranges * sin_t * g[..., 0] + ranges * cos_t * g[..., 1]
        jac = torch.stack([g[..., 0], g[..., 1], g_theta], dim=-1) * \
            mask[..., None]
        vec_b = (resid[..., None] * jac).sum(dim=1)
        mat_h = (jac[..., :, None] * jac[..., None, :]).sum(dim=1) + reg
        return pose + torch.linalg.solve(mat_h, vec_b[..., None])[..., 0]

    pose = sensor_poses
    cost = torch.full((q,), torch.inf, dtype=f32, device=dev)
    done = torch.zeros((q,), dtype=torch.bool, device=dev)
    for it in range(max_iterations):
        new_pose = gn_step(pose)
        c = costops.square_error_cost(value_map, grid, new_pose, ranges,
                                      angles, mask)
        active = ~done
        pose = torch.where(active[:, None], new_pose, pose)
        done = done | (torch.abs(cost - c) < convergence_threshold)
        cost = torch.where(active, c, cost)
        if it + 1 < max_iterations:
            linear_solver_match.host_syncs += 1
            if bool(done.all()):
                break

    cov = costops.square_error_covariance(value_map, grid, pose, ranges,
                                          angles, mask)
    return _summary(torch.ones((q,), dtype=torch.bool, device=dev), cost,
                    torch.zeros((q,), dtype=f32, device=dev), n_total,
                    initial_poses, pose, rel_sensor_poses, cov)


linear_solver_match.host_syncs = 0
