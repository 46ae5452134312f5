"""Correlative matcher: an exhaustive (theta, dx, dy) window sweep.

Counterpart of ``my_lidar_graph_slam_tpu/ops/matchers_mxu.py:193-310``
(``correlative_match_mxu_batch`` / ``_match_one_map``): the brute-force
full-window sweep of ScanMatcherRealTimeCorrelative
(scan_matcher_real_time_correlative.cpp:50-145) with the same candidate
lattice, the same (theta, dx, dy) first-maximum tie order and the same
cost/covariance. Window scores come from the K1 kernel
(``ops/cuda/correlate.py``), which takes any window directly, so the JAX
package's 7x7 block assembly has no counterpart here; the cost and
covariance at the best pose come from the K2 kernel
(``ops/cuda/greedy_cost.py``). The folded multi-map matcher is not ported
yet.

Exact by construction: every candidate in the window is scored.
"""

from __future__ import annotations

import torch

from my_lidar_graph_slam_tpu_torch.ops import grid as gridops
from my_lidar_graph_slam_tpu_torch.ops import matchers
from my_lidar_graph_slam_tpu_torch.ops.cuda import correlate, greedy_cost
from my_lidar_graph_slam_tpu_torch.utils import se2


def hit_cells(grid: gridops.GridMap, sensor_poses, ranges, angles,
              step_t, win_theta_max: int):
    """int32 (ix, iy) [Q, NT, NB] beam endpoints over the ORDERED theta
    lattice ``theta_0 + i * step_t``, i in [-win_theta_max, win_theta_max]
    (rotation by angle addition, as ``matchers_mxu.py:229-243``)."""
    dev = ranges.device
    nt = 2 * win_theta_max + 1
    t_idx = torch.arange(nt, device=dev) - win_theta_max
    st = sensor_poses[:, 2]
    c0 = torch.cos(st[:, None] + angles)                         # [Q, NB]
    s0 = torch.sin(st[:, None] + angles)
    dt = t_idx[None, :].to(torch.float32) * step_t[:, None]      # [Q, NT]
    ct = torch.cos(dt)[:, :, None]
    st2 = torch.sin(dt)[:, :, None]
    cos_phi = c0[:, None, :] * ct - s0[:, None, :] * st2
    sin_phi = s0[:, None, :] * ct + c0[:, None, :] * st2
    hx = sensor_poses[:, 0, None, None] + ranges[:, None, :] * cos_phi
    hy = sensor_poses[:, 1, None, None] + ranges[:, None, :] * sin_phi
    res = gridops.scalar(grid.resolution, dev)
    ix = torch.floor((hx - grid.origin[0]) / res).to(torch.int32)
    iy = torch.floor((hy - grid.origin[1]) / res).to(torch.int32)
    return ix, iy


def correlative_match_sweep(value_map, grid: gridops.GridMap, initial_poses,
                            ranges, angles, valid, scan_min_range,
                            scan_max_range, rel_sensor_poses,
                            scan_range_max: float, range_theta: float,
                            usable_range_min: float, usable_range_max: float,
                            normalized_score_threshold: float,
                            num_total_beams, win_x: int, win_y: int,
                            win_theta_max: int,
                            cost_type: str = "greedy_endpoint",
                            greedy_params: tuple = (),
                            score_gate: str = "correlative"
                            ) -> matchers.MatchSummary:
    """Q full-window correlative matches against one map.

    Tensors on the map's device: ``value_map`` f32[H, W] (occupancy values
    of ``grid``), ``initial_poses`` f32[Q, 3], ``ranges``/``angles`` f32 and
    ``valid`` bool [Q, NB], ``scan_min_range``/``scan_max_range`` f32[Q],
    ``rel_sensor_poses`` f32[Q, 3], ``num_total_beams`` f32[Q].

    ``score_gate`` selects the beams that SCORE: ``"correlative"`` drops
    only beams at or beyond ``scan_range_max`` (the frontend matcher's
    projection gate, scan_matcher_real_time_correlative.cpp:189-193);
    ``"pixel_accurate"`` applies the usable/scan range gate of
    ScorePixelAccurate (score_function_pixel_accurate.cpp:27-41) as well —
    the loop detector's gate.
    """
    if cost_type != "greedy_endpoint":
        raise NotImplementedError(
            f"cost type {cost_type!r} is not ported yet")
    dev = ranges.device
    q = ranges.shape[0]
    f32 = torch.float32

    sensor_poses = se2.compound(initial_poses, rel_sensor_poses)
    max_range = torch.clamp(
        torch.where(valid, ranges, torch.full_like(ranges, -torch.inf)
                    ).amax(dim=-1), max=scan_range_max)           # [Q]
    res = gridops.scalar(grid.resolution, dev)
    step_t = matchers.search_step_theta(res, max_range)            # [Q]
    # An all-invalid (padding) row has step 0: every theta stays live,
    # as the saturating conversion of the JAX package leaves it.
    win_theta_act = torch.ceil(
        0.5 * gridops.scalar(range_theta, dev) / step_t
    ).clamp(max=win_theta_max)

    if score_gate == "pixel_accurate":
        proj_mask = matchers.range_gate(
            valid, ranges, usable_range_min, usable_range_max,
            scan_min_range[:, None], scan_max_range[:, None]) & \
            (ranges < scan_range_max)
    elif score_gate == "correlative":
        proj_mask = valid & (ranges < scan_range_max)
    else:
        raise ValueError(f"unknown score gate {score_gate!r}")
    wgt = proj_mask.to(f32)

    ix, iy = hit_cells(grid, sensor_poses, ranges, angles, step_t,
                       win_theta_max)
    scores = correlate.window_scores(value_map, ix, iy, wgt, win_x, win_y)
    nt = 2 * win_theta_max + 1
    t_idx = torch.arange(nt, device=dev) - win_theta_max
    live = t_idx.abs()[None, :].to(f32) <= win_theta_act[:, None]
    scores = torch.where(live[:, :, None, None], scores,
                         torch.full_like(scores, -torch.inf))

    # First maximum in (theta, dx, dy) order == the reference loop order
    # (scan_matcher_real_time_correlative.cpp:98-118).
    wxn = 2 * win_x + 1
    wyn = 2 * win_y + 1
    flat = scores.reshape(q, -1)
    best = torch.argmax(flat, dim=-1)
    best_score = torch.gather(flat, 1, best[:, None])[:, 0]
    bt = best // (wxn * wyn) - win_theta_max
    bx = (best // wyn) % wxn - win_x
    by = best % wyn - win_y

    n_total = num_total_beams.to(f32)
    pose_found = best_score > normalized_score_threshold * n_total
    best_sensor_poses = torch.stack([
        sensor_poses[:, 0] + bx.to(f32) * res,
        sensor_poses[:, 1] + by.to(f32) * res,
        sensor_poses[:, 2] + bt.to(f32) * step_t,
    ], dim=-1)

    cost_mask = matchers.range_gate(
        valid, ranges, usable_range_min, usable_range_max,
        scan_min_range[:, None], scan_max_range[:, None])
    gp = dict(greedy_params)
    c, cov = greedy_cost.greedy_cost_cov(
        value_map, grid.origin, best_sensor_poses, ranges, angles,
        cost_mask, grid.resolution,
        hit_and_missed_dist=gp.get("hit_and_missed_dist", 0.075),
        occupancy_threshold=gp.get("occupancy_threshold", 0.1),
        kernel_size=gp.get("kernel_size", 1),
        standard_deviation=gp.get("standard_deviation", 1.0),
        scaling_factor=gp.get("scaling_factor", 0.05))

    return matchers.MatchSummary(
        pose_found=pose_found,
        normalized_cost=c / n_total,
        normalized_score=best_score / n_total,
        initial_pose=initial_poses,
        estimated_pose=se2.move_backward(best_sensor_poses, rel_sensor_poses),
        covariance=cov,
    )


def pack_summary(summary: matchers.MatchSummary) -> torch.Tensor:
    """f32[Q, 16] (pose 0:3, covariance 3:12, score 12, cost 13, found 14,
    exact 15), so the host reads a match back in ONE transfer
    (``scan_matchers._pack_summary`` of the JAX package)."""
    q = summary.estimated_pose.shape[0]
    return torch.cat([
        summary.estimated_pose,
        summary.covariance.reshape(q, 9),
        summary.normalized_score[:, None],
        summary.normalized_cost[:, None],
        summary.pose_found[:, None].to(torch.float32),
        torch.ones((q, 1), dtype=torch.float32,
                   device=summary.estimated_pose.device),
    ], dim=1)
