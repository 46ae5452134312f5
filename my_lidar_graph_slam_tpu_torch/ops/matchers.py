"""Scan matchers: the result type, shared helpers and five strategies.

Counterpart of ``my_lidar_graph_slam_tpu/ops/matchers.py:51-118,357-1165``
(``MatchSummary``, ``search_step_theta``, ``static_max_theta_window``,
``_range_gate``, ``_cost_and_covariance``, the pruned correlative batch
with its bound stack, and the grid-search, branch-and-bound,
hill-climbing and linear-solver matchers). The exhaustive correlative
sweep lives in ``matchers_sweep.py``; it is the JAX package's brute
``correlative_match_batch`` (the same full-window first maximum), so
that function has no second copy here.

Every matcher here takes a leading query axis Q, so one function serves
both the JAX package's single and ``_batch`` forms; per-query scalars
(scan ranges, ``num_total_beams``) are f32[Q]. The greedy-endpoint cost
and covariance at the best pose go through
``ops/cuda/greedy_cost.py::greedy_cost_cov``: the K2 kernel on a CUDA
tensor, its plain version on a CPU tensor.

Host synchronization: grid search and branch-and-bound read nothing back
(their level and chunk loops are static); hill climbing and the linear
solver loop on data and read one flag per step through
``utils/device.py::sync``, which counts it in ``HostSyncs.<layer>``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from my_lidar_graph_slam_tpu_torch.ops import cost as costops
from my_lidar_graph_slam_tpu_torch.ops import grid as gridops
from my_lidar_graph_slam_tpu_torch.ops import scoring
from my_lidar_graph_slam_tpu_torch.ops.cuda import greedy_cost
from my_lidar_graph_slam_tpu_torch.utils import device as device_mod
from my_lidar_graph_slam_tpu_torch.utils import se2

# Most (query, candidate, beam) reads the grid search holds at once: the
# lattice is scored in chunks of whole dy rows under this size.
GRID_CHUNK_ELEMS = 1 << 24
# Theta halos of the pruned matcher's bound stack (make_bound_stack).
BOUND_HALOS = (0, 1, 2, 3, 4, 5)


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


def top_k(x: torch.Tensor, k: int):
    """``(values, indices)`` of the ``k`` largest entries along the last
    axis, largest first and equal values in ascending index order: the
    order of XLA's ``lax.top_k``, which ``torch.topk`` does not promise
    for ties. A stable descending sort gives it."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def hit_cells_lattice(origins, resolution: float, sensor_poses, ranges,
                      angles, step_t, t_idx):
    """int32 (ix, iy) [Q, T, NB] beam endpoints at the theta lattice
    indices ``t_idx`` (i64 [T], shared, or [Q, T], per query), i.e. at
    ``theta_0 + t * step_t``, on grids of cell size ``resolution`` with
    origin ``origins`` f32[Q, 2] (or one origin f32[1, 2]). Rotation by
    angle addition, as ``matchers_mxu.py:229-243`` and the pruned matcher
    (``matchers.py:477-490``) of the JAX package."""
    dev = ranges.device
    t_idx = t_idx if t_idx.dim() == 2 else t_idx[None, :]
    st = sensor_poses[:, 2]
    c0 = torch.cos(st[:, None] + angles)                         # [Q, NB]
    s0 = torch.sin(st[:, None] + angles)
    dt = t_idx.to(torch.float32) * step_t[:, None]               # [Q, T]
    ct = torch.cos(dt)[:, :, None]
    st2 = torch.sin(dt)[:, :, None]
    cos_phi = c0[:, None, :] * ct - s0[:, None, :] * st2
    sin_phi = s0[:, None, :] * ct + c0[:, None, :] * st2
    hx = sensor_poses[:, 0, None, None] + ranges[:, None, :] * cos_phi
    hy = sensor_poses[:, 1, None, None] + ranges[:, None, :] * sin_phi
    res = gridops.scalar(resolution, dev)
    ix = torch.floor((hx - origins[:, 0, None, None]) / res).to(torch.int32)
    iy = torch.floor((hy - origins[:, 1, None, None]) / res).to(torch.int32)
    return ix, iy


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
# Pruned correlative matcher (bound and refine)
# ---------------------------------------------------------------------------


def _take2d(flat, pad: int, wp: int, hp: int, iy, ix, level_offset=0):
    """Read cells of a zero-padded map (or stack of maps) flattened to
    ``flat`` by RAW map indices: indices outside the padded frame clamp
    into the zero ring and read 0, the Unknown sentinel
    (``matchers.py:357-367`` of the JAX package)."""
    y = (iy + pad).clamp(0, hp - 1).long()
    x = (ix + pad).clamp(0, wp - 1).long()
    return flat[level_offset + y * wp + x]


def _centered_max(value_map, radius: int):
    """Max over the (2 radius + 1)^2 block centered at each cell, zeros
    past the edges: two separable passes, columns then rows, as the JAX
    package's ``reduce_window`` with "SAME" padding and init 0."""
    k = 2 * radius + 1
    m = torch.nn.functional.pad(value_map[None, None], (radius,) * 4)
    m = torch.nn.functional.max_pool2d(m, (1, k), stride=1)
    return torch.nn.functional.max_pool2d(m, (k, 1), stride=1)[0, 0]


def make_bound_stack(value_map, win_x: int, win_y: int,
                     halos: tuple = BOUND_HALOS):
    """f32[len(halos), H, W] centered windowed-max bound maps, one per
    theta halo (``make_bound_stack``, ``matchers.py:370-394`` of the JAX
    package): ``stack[l][c]`` is the max of ``value_map`` within
    ``max(win_x, win_y) + halos[l]`` cells of ``c`` in x and in y. Level 0
    bounds one theta's whole (dx, dy) window; level l also absorbs the
    endpoint drift of a theta group. Max is exact, so the levels equal the
    JAX package's bit for bit."""
    win = max(win_x, win_y)
    return torch.stack([_centered_max(value_map, win + h) for h in halos])


def correlative_match_pruned_batch(value_map, bound_stack,
                                   grid: gridops.GridMap, initial_poses,
                                   ranges, angles, valid, scan_min_range,
                                   scan_max_range, rel_sensor_poses,
                                   scan_range_max: float,
                                   range_theta: float,
                                   usable_range_min: float,
                                   usable_range_max: float,
                                   normalized_score_threshold: float,
                                   num_total_beams, win_x: int, win_y: int,
                                   win_theta_max: int, group: int = 7,
                                   top_groups: int = 8, top_thetas: int = 16,
                                   cost_type: str = "greedy_endpoint",
                                   greedy_params: tuple = ()):
    """Q pruned correlative matches, each with an exactness flag
    (``correlative_match_pruned_batch``, ``matchers.py:397-622`` of the JAX
    package; the coarse-to-fine prune of
    scan_matcher_real_time_correlative.cpp:50-145).

    Stage 1 bounds each group of ``group`` thetas with one read per beam
    of a halo-dilated bound map (the halo level chosen per beam from its
    range); stage 2 bounds each theta of the ``top_groups`` best groups on
    the halo-0 map; stage 3 scores the full (2 win + 1)^2 window of the
    ``top_thetas`` best thetas and takes the first maximum in the
    reference's (theta, dx, dy) order. Both cuts keep equal bounds in
    ascending index order, as the JAX package's ``lax.top_k`` does.

    ``exact[q]`` holds iff every bound left unexpanded is strictly below
    the best score: then the result equals the full-window sweep's, and
    callers re-run the other rows through the sweep. Tensor arguments and
    the result as :func:`grid_search_match`'s; returns
    ``(MatchSummary, exact bool[Q])``.
    """
    halos = BOUND_HALOS
    n_levels = bound_stack.shape[0]
    # The stage-1 bound is sound only while the halo stack covers a
    # group's worst endpoint drift, group // 2 + 2 cells at max range
    # (``matchers.py:447-461`` of the JAX package).
    if group // 2 + 2 > len(halos) - 1:
        raise ValueError(f"group={group} exceeds the halo stack "
                         f"({len(halos)} levels)")
    if n_levels < len(halos):
        raise ValueError("bound_stack has fewer halo levels than the "
                         f"matcher assumes ({len(halos)})")
    dev = ranges.device
    q = ranges.shape[0]
    f32 = torch.float32
    neg_inf = device_mod.upload(-math.inf, dev, f32, site="pruned_match")
    n_total = num_total_beams.to(f32)

    sensor_poses = se2.compound(initial_poses, rel_sensor_poses)
    max_range = torch.clamp(
        torch.where(valid, ranges, torch.full_like(ranges, -torch.inf)
                    ).amax(dim=-1), max=scan_range_max)          # [Q]
    res = gridops.scalar(grid.resolution, dev)
    step_t = search_step_theta(res, max_range)                   # [Q]
    win_act = torch.ceil(0.5 * gridops.scalar(range_theta, dev) / step_t)
    wgt = (valid & (ranges < scan_range_max)).to(f32)            # [Q, NB]

    h, w = value_map.shape
    wxn, wyn = 2 * win_x + 1, 2 * win_y + 1
    ncand = wxn * wyn
    # Zero-padded flats: clamped off-map reads land in the zero ring.
    pad = max(win_x, win_y) + max(halos) + 2
    hp, wp = h + 2 * pad, w + 2 * pad
    v_flat = torch.nn.functional.pad(value_map, (pad,) * 4).reshape(-1)
    b_flat = torch.nn.functional.pad(bound_stack, (pad,) * 4).reshape(-1)
    origin = grid.origin.reshape(1, 2)

    def cells(t_idx):
        return hit_cells_lattice(origin, grid.resolution, sensor_poses,
                                 ranges, angles, step_t, t_idx)

    # Stage 1: theta-group bounds.
    half = group // 2
    ng = -(-(2 * win_theta_max + 1) // group)
    top_groups = min(top_groups, ng)
    top_thetas = min(top_thetas, top_groups * group)
    g_start = torch.arange(ng, device=dev) * group - win_theta_max   # [NG]
    drift = torch.floor(half * ranges * step_t[:, None] / res) + 2.0
    lvl = drift.clamp(1, n_levels - 1).long()                    # [Q, NB]
    ixc, iyc = cells((g_start + half).expand(q, ng))             # [Q,NG,NB]
    bvals = _take2d(b_flat, pad, wp, hp, iyc, ixc,
                    (lvl * (hp * wp))[:, None, :])
    bound_g = (bvals * wgt[:, None, :]).sum(-1)                  # [Q, NG]
    g_live = (g_start[None, :] <= win_act[:, None]) & \
        (g_start[None, :] + group - 1 >= -win_act[:, None])
    bound_g = torch.where(g_live, bound_g, neg_inf)

    # Stage 2: per-theta bounds inside the best groups.
    top_g_val, top_g = top_k(bound_g, top_groups)                # [Q, TG]
    t2 = (g_start[top_g][:, :, None] + torch.arange(group, device=dev)
          ).reshape(q, top_groups * group)                       # [Q, TT]
    ix2, iy2 = cells(t2)
    bound_t = (_take2d(b_flat, pad, wp, hp, iy2, ix2) *
               wgt[:, None, :]).sum(-1)                          # [Q, TT]
    t_live = (t2.abs() <= win_act[:, None]) & (t2 <= win_theta_max) & \
        (t2 >= -win_theta_max) & \
        torch.isfinite(top_g_val).repeat_interleave(group, dim=-1)
    bound_t = torch.where(t_live, bound_t, neg_inf)

    # Stage 3: exact windows of the best thetas.
    _, top_t_idx = top_k(bound_t, top_thetas)                    # [Q, K]
    t3 = torch.gather(t2, 1, top_t_idx)
    t3_live = torch.gather(t_live, 1, top_t_idx)
    ix3, iy3 = cells(t3)                                         # [Q,K,NB]
    dy = torch.arange(-win_y, win_y + 1, device=dev)
    dx = torch.arange(-win_x, win_x + 1, device=dev)
    window = _take2d(v_flat, pad, wp, hp, iy3[..., None, None] + dy[:, None],
                     ix3[..., None, None] + dx[None, :])        # [Q,K,NB,y,x]
    scores = (window * wgt[:, None, :, None, None]).sum(2)       # [Q,K,y,x]
    scores = torch.where(t3_live[:, :, None, None], scores, neg_inf)

    # First maximum in the reference's (theta, dx, dy) order: the smallest
    # candidate rank among the best scores.
    sc_flat = scores.transpose(-1, -2).reshape(q, -1)            # [Q, K*x*y]
    rank = ((t3 + win_theta_max)[:, :, None] * ncand +
            torch.arange(ncand, device=dev)).reshape(q, -1)
    best_score = sc_flat.amax(dim=-1)
    best_rank = torch.where(sc_flat == best_score[:, None], rank,
                            torch.full_like(rank, 2 ** 30)).amin(dim=-1)
    bt = best_rank // ncand - win_theta_max
    bxi = (best_rank % ncand) // wyn
    byi = best_rank % wyn

    # Exactness certificate, strict: an unexplored candidate tied with the
    # best could precede it in the reference's order.
    ub_g = bound_g.scatter(1, top_g, -torch.inf)
    ub_t = bound_t.scatter(1, top_t_idx, -torch.inf)
    exact = (ub_g.amax(dim=-1) < best_score) & \
        (ub_t.amax(dim=-1) < best_score) & torch.isfinite(best_score)

    best_sensor_poses = torch.stack([
        sensor_poses[:, 0] + (bxi - win_x).to(f32) * res,
        sensor_poses[:, 1] + (byi - win_y).to(f32) * res,
        sensor_poses[:, 2] + bt.to(f32) * step_t], dim=-1)
    cost_mask = range_gate(valid, ranges, usable_range_min,
                           usable_range_max, scan_min_range[:, None],
                           scan_max_range[:, None])
    c, cov = _cost_and_covariance(cost_type, value_map, grid,
                                  best_sensor_poses, ranges, angles,
                                  cost_mask, greedy_params)
    found = best_score > normalized_score_threshold * n_total
    return _summary(found, c, best_score, n_total, initial_poses,
                    best_sensor_poses, rel_sensor_poses, cov), exact


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
    flag per step (``HostSyncs``); a query whose loop has ended keeps its
    state, so each query's iterate equals the JAX loop's.
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

    moves = device_mod.upload([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0],
                               [0.0, 1.0, 0.0], [0.0, -1.0, 0.0],
                               [0.0, 0.0, 1.0], [0.0, 0.0, -1.0]], dev,
                              site="hill_climbing")
    q = ranges.shape[0]
    best_pose = sensor_poses
    best_cost = cost_fn(sensor_poses[:, None, :])[:, 0]
    lin = torch.full((q,), linear_step, dtype=f32, device=dev)
    ang = torch.full((q,), angular_step, dtype=f32, device=dev)
    refinements = torch.zeros((q,), dtype=torch.int64, device=dev)
    updated = torch.ones((q,), dtype=torch.bool, device=dev)
    for _ in range(max_iterations):
        active = updated | (refinements < max_refinements)
        if not bool(device_mod.sync(active.any(), site="hill_climbing")):
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

    A host loop that reads one flag per step (``HostSyncs``); a finished
    query keeps its state.
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
    reg = torch.diag(device_mod.upload(
        [translation_regularizer, translation_regularizer,
         rotation_regularizer], dev, f32, site="linear_solver"))

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
            if bool(device_mod.sync(done.all(), site="linear_solver")):
                break

    cov = costops.square_error_covariance(value_map, grid, pose, ranges,
                                          angles, mask)
    return _summary(torch.ones((q,), dtype=torch.bool, device=dev), cost,
                    torch.zeros((q,), dtype=f32, device=dev), n_total,
                    initial_poses, pose, rel_sensor_poses, cov)

