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
(``ops/cuda/greedy_cost.py``), or, with the square-error cost on one map,
from ``ops/cost.py``. :func:`correlative_match_sweep_multi` folds
several stacked maps into one set of launches through ``map_idx``.

Exact by construction: every candidate in the window is scored.
"""

from __future__ import annotations

import torch

from my_lidar_graph_slam_tpu_torch.ops import grid as gridops
from my_lidar_graph_slam_tpu_torch.ops import matchers
from my_lidar_graph_slam_tpu_torch.ops.cuda import correlate, greedy_cost
from my_lidar_graph_slam_tpu_torch.utils import se2


def hit_cells_at(origins, resolution: float, sensor_poses, ranges, angles,
                 step_t, win_theta_max: int):
    """int32 (ix, iy) [Q, NT, NB] beam endpoints on grids of cell size
    ``resolution`` with a per-query origin ``origins`` f32[Q, 2] (or one
    origin f32[1, 2] for every query), over the ORDERED theta lattice
    ``theta_0 + i * step_t``, i in [-win_theta_max, win_theta_max]
    (rotation by angle addition, as ``matchers_mxu.py:229-243``)."""
    t_idx = torch.arange(2 * win_theta_max + 1,
                         device=ranges.device) - win_theta_max
    return matchers.hit_cells_lattice(origins, resolution, sensor_poses,
                                      ranges, angles, step_t, t_idx)


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
    return _sweep(value_map, grid.origin, grid.resolution, None,
                  initial_poses, ranges, angles, valid, scan_min_range,
                  scan_max_range, rel_sensor_poses, scan_range_max,
                  range_theta, usable_range_min, usable_range_max,
                  normalized_score_threshold, num_total_beams, win_x, win_y,
                  win_theta_max, cost_type, greedy_params, score_gate)


def correlative_match_sweep_multi(value_maps, origins, resolution: float,
                                  initial_poses, ranges, angles, valid,
                                  scan_min_range, scan_max_range,
                                  rel_sensor_poses, scan_range_max: float,
                                  range_theta: float,
                                  usable_range_min: float,
                                  usable_range_max: float,
                                  normalized_score_threshold: float,
                                  num_total_beams, win_x: int, win_y: int,
                                  win_theta_max: int,
                                  cost_type: str = "greedy_endpoint",
                                  greedy_params: tuple = (),
                                  score_gate: str = "pixel_accurate"
                                  ) -> matchers.MatchSummary:
    """M candidate maps x K queries each in one set of kernel launches
    (``matchers_mxu.py:318-482``, ``correlative_match_mxu_multi``).

    ``value_maps`` f32[M, H, W] stacked same-size maps, ``origins``
    f32[M, 2]; the query tensors of :func:`correlative_match_sweep` with
    leading axes [M, K]. The (map, query) axes fold into the kernels'
    query axis: query ``m * K + k`` reads map ``m`` through ``map_idx``,
    with map ``m``'s origin for its hit cells and its cost. K2 takes
    ``map_idx`` at any ``kernel_size``, so the greedy-endpoint cost always
    folds; the square-error cost, which reads one map, takes the JAX
    package's per-map path (``matchers_mxu.py:363-379``): one sweep per
    map. Returns a MatchSummary with leading axes [M, K].
    """
    m, k = ranges.shape[:2]
    dev = ranges.device
    if cost_type == "square_error":
        outs = [_sweep(value_maps[i], origins[i], resolution, None,
                       initial_poses[i], ranges[i], angles[i], valid[i],
                       scan_min_range[i], scan_max_range[i],
                       rel_sensor_poses[i], scan_range_max, range_theta,
                       usable_range_min, usable_range_max,
                       normalized_score_threshold, num_total_beams[i],
                       win_x, win_y, win_theta_max, cost_type,
                       greedy_params, score_gate) for i in range(m)]
        return matchers.MatchSummary(*(torch.stack(x) for x in zip(*outs)))

    def fold(x):
        return x.reshape((m * k,) + tuple(x.shape[2:]))

    map_idx = torch.arange(m, dtype=torch.int32,
                           device=dev).repeat_interleave(k)
    origin_q = origins.repeat_interleave(k, dim=0)              # [Q, 2]
    summary = _sweep(value_maps, origin_q, resolution, map_idx,
                     fold(initial_poses), fold(ranges), fold(angles),
                     fold(valid), fold(scan_min_range), fold(scan_max_range),
                     fold(rel_sensor_poses), scan_range_max, range_theta,
                     usable_range_min, usable_range_max,
                     normalized_score_threshold, fold(num_total_beams),
                     win_x, win_y, win_theta_max, cost_type, greedy_params,
                     score_gate)
    return matchers.MatchSummary(*(
        x.reshape((m, k) + tuple(x.shape[1:])) for x in summary))


def _sweep(value_map, origin, resolution: float, map_idx, initial_poses,
           ranges, angles, valid, scan_min_range, scan_max_range,
           rel_sensor_poses, scan_range_max, range_theta, usable_range_min,
           usable_range_max, normalized_score_threshold, num_total_beams,
           win_x, win_y, win_theta_max, cost_type, greedy_params,
           score_gate) -> matchers.MatchSummary:
    """The sweep on ``value_map`` f32[H, W] with ``origin`` f32[2], or on
    a stack f32[M, H, W] with ``map_idx`` i32[Q] and ``origin`` f32[Q, 2].
    """
    if cost_type not in ("greedy_endpoint", "square_error"):
        raise ValueError(f"unknown cost type {cost_type!r}")
    dev = ranges.device
    q = ranges.shape[0]
    f32 = torch.float32

    sensor_poses = se2.compound(initial_poses, rel_sensor_poses)
    max_range = torch.clamp(
        torch.where(valid, ranges, torch.full_like(ranges, -torch.inf)
                    ).amax(dim=-1), max=scan_range_max)           # [Q]
    res = gridops.scalar(resolution, dev)
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

    ix, iy = hit_cells_at(origin.reshape(-1, 2), resolution, sensor_poses,
                          ranges, angles, step_t, win_theta_max)
    scores = correlate.window_scores(value_map, ix, iy, wgt, win_x, win_y,
                                     map_idx)
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
    if map_idx is None:
        c, cov = matchers._cost_and_covariance(
            cost_type, value_map,
            gridops.GridMap(None, None, origin, resolution),
            best_sensor_poses, ranges, angles, cost_mask, greedy_params)
    else:
        c, cov = greedy_cost.greedy_cost_cov(
            value_map, origin, best_sensor_poses, ranges, angles,
            cost_mask, resolution, map_idx=map_idx, **dict(greedy_params))

    return matchers.MatchSummary(
        pose_found=pose_found,
        normalized_cost=c / n_total,
        normalized_score=best_score / n_total,
        initial_pose=initial_poses,
        estimated_pose=se2.move_backward(best_sensor_poses, rel_sensor_poses),
        covariance=cov,
        frontier_overflow=torch.zeros((q,), dtype=torch.int64, device=dev),
    )


def pack_summary(summary: matchers.MatchSummary) -> torch.Tensor:
    """f32[Q, 16] (pose 0:3, covariance 3:12, score 12, cost 13, found 14,
    frontier overflow 15), so the host reads a match back in ONE transfer
    (``scan_matchers._pack_summary`` of the JAX package, whose column 15,
    an exactness flag, is always 1 where the port's count is 0)."""
    q = summary.estimated_pose.shape[0]
    return torch.cat([
        summary.estimated_pose,
        summary.covariance.reshape(q, 9),
        summary.normalized_score[:, None],
        summary.normalized_cost[:, None],
        summary.pose_found[:, None].to(torch.float32),
        summary.frontier_overflow[:, None].to(torch.float32),
    ], dim=1)
