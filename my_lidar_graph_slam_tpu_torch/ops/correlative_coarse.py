"""Two-stage (coarse -> fine) correlative matching for wide windows.

Counterpart of ``my_lidar_graph_slam_tpu/ops/correlative_coarse.py``. The
correlative loop detector searches a +-2.5 m x +-0.5 rad window
(launcher_settings_default.json:102-126), too many candidates to score
one by one. As the reference (scan_matcher_real_time_correlative.cpp:
88-116) and the JAX package do, it scores in two levels:

 1. every (theta, coarse block) candidate on the windowed-max coarse map,
    an upper bound of the fine scores inside the block;
 2. the fine candidates of the ``refine_blocks`` best blocks on the fine
    map; the first maximum over them, in the blocks' rank order, is the
    answer.

The result carries a certificate: it is the full-window argmax when the
best unrefined block's bound is strictly below the best refined score.
When a query's certificate fails the batch is refined again with four
times the blocks, at most ``max_escalations`` times.

Both stages are gathers from a map with a one-cell zero ring (off-map
reads land in the ring and read the Unknown value 0), chunked so that no
more than :data:`CHUNK_ELEMS` (query, theta or block, beam, cell) reads
are held at once: a naive index tensor for the coarse stage at full width
would take over a gigabyte. The blocks are ranked by a stable descending
sort (``matchers.top_k``), so equal bounds keep ascending index order, as
the JAX package's ``lax.top_k`` does; the coarse stage runs once per
batch and each escalation only refines more of the same ranking. The
greedy-endpoint cost and covariance at the best pose go through
``ops/cuda/greedy_cost.py`` (the K2 kernel on a CUDA tensor). The host
reads one packed [Q, 16] result per refinement: column 15 is the
certificate, which decides whether to escalate.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from my_lidar_graph_slam_tpu_torch.ops import grid as gridops
from my_lidar_graph_slam_tpu_torch.ops import matchers, matchers_sweep
from my_lidar_graph_slam_tpu_torch.ops import pyramid as pyrops
from my_lidar_graph_slam_tpu_torch.ops import scoring
from my_lidar_graph_slam_tpu_torch.utils import device as device_mod
from my_lidar_graph_slam_tpu_torch.utils import se2
from my_lidar_graph_slam_tpu_torch.utils.metrics import MetricManager

# Most (query, theta or block, beam, cell) map reads held at once.
CHUNK_ELEMS = 1 << 24


def coarse_map_for(builder, lm, low_resolution: int) -> torch.Tensor:
    """Windowed-max coarse map of a local map, cached on the LocalMap
    (``coarse_map_for`` of the JAX package; the single coarse-map
    precompute of loop_detector_real_time_correlative.cpp:51-63).

    Like the JAX cache it is keyed on ``low_resolution`` only, so unless
    the builder was made with ``refresh_coarse_maps`` it outlives a
    rebuild of the map; each call that returns a coarse map older than the
    grid adds one to the ``LoopDetectStaleCoarseMaps`` counter."""
    slot = lm.coarse
    if slot is None or slot[0] != low_resolution:
        coarse = pyrops.windowed_max(builder.values_for(lm), low_resolution)
        lm.coarse = slot = (low_resolution, coarse, lm.grid_version)
    elif slot[2] != lm.grid_version:
        MetricManager.instance().counters(
            "LoopDetectStaleCoarseMaps").increment()
    return slot[1]


class TwoStageResult(NamedTuple):
    """What :func:`two_stage_match_batch` returns."""

    summary: matchers.MatchSummary   # leading axis Q, on the map's device
    exact: np.ndarray                # bool[Q] certificate per query
    escalations: int                 # refinements after the first
    packed: np.ndarray               # f32[Q, 16], column 15 ``exact``


class _Coarse(NamedTuple):
    """The coarse stage of a batch, shared by every refinement."""

    sensor_poses: torch.Tensor   # f32[Q, 3]
    step_t: torch.Tensor         # f32[Q]
    ix: torch.Tensor             # i32[Q, NT, NB] hit cells per theta
    iy: torch.Tensor
    wgt: torch.Tensor            # f32[Q, NB] scoring beams
    ranked: torch.Tensor         # f32[Q, n_blocks] bounds, best first
    order: torch.Tensor          # i64[Q, n_blocks] their block indices


def _padded(value_map):
    """(flat, padded height, padded width) of ``value_map`` with a one-cell
    zero ring."""
    h, w = value_map.shape
    return torch.nn.functional.pad(value_map, (1, 1, 1, 1)).reshape(-1), \
        h + 2, w + 2


def _window_sums(flat, hp: int, wp: int, ix, iy, offs_x, offs_y, wgt):
    """f32[Q, T, X, Y]: for each (q, t), the ``wgt``-weighted sum over
    beams of the padded map at cell (ix + offs_x[a], iy + offs_y[b]);
    ``ix``/``iy`` [Q, T, NB], ``offs_x``/``offs_y`` i64 [Q, T, X] and
    [Q, T, Y] (or broadcastable)."""
    gx = (ix.long()[..., None] + offs_x[:, :, None, :] + 1).clamp(0, wp - 1)
    gy = (iy.long()[..., None] + offs_y[:, :, None, :] + 1).clamp(0, hp - 1)
    vals = flat[gx[..., :, None] + gy[..., None, :] * wp]   # [Q,T,NB,X,Y]
    return (vals * wgt[:, None, :, None, None]).sum(dim=2)


def _coarse_stage(coarse_map, grid: gridops.GridMap, initial_poses, ranges,
                  angles, valid, rel_sensor_poses, scan_range_max: float,
                  range_theta: float, low_resolution: int, win_x: int,
                  win_y: int, win_theta_max: int) -> _Coarse:
    """Stage 1 (``correlative_coarse.py:63-98`` of the JAX package) for Q
    queries at once, chunked over theta, and the block ranking."""
    dev = ranges.device
    q, nb = ranges.shape
    f32 = torch.float32
    sensor_poses = se2.compound(initial_poses, rel_sensor_poses)
    max_range = torch.clamp(
        torch.where(valid, ranges, torch.full_like(ranges, -torch.inf)
                    ).amax(dim=-1), max=scan_range_max)          # [Q]
    step_t = matchers.search_step_theta(
        gridops.scalar(grid.resolution, dev), max_range)
    # An all-invalid row has step 0: every theta stays live, as the
    # saturating conversion of the JAX package leaves it.
    win_act = torch.ceil(0.5 * gridops.scalar(range_theta, dev) / step_t
                         ).clamp(max=win_theta_max)
    wgt = (valid & (ranges < scan_range_max)).to(f32)

    nt = 2 * win_theta_max + 1
    t_idx = torch.arange(nt, device=dev) - win_theta_max
    theta = sensor_poses[:, 2, None] + t_idx.to(f32)[None, :] * \
        step_t[:, None]
    cand = torch.stack([sensor_poses[:, 0, None].expand(q, nt),
                        sensor_poses[:, 1, None].expand(q, nt), theta], -1)
    ix, iy = scoring.hit_cells(grid, cand, ranges[:, None, :],
                               angles[:, None, :])             # [Q, NT, NB]

    offs_x = torch.arange(-win_x, win_x + 1, low_resolution, device=dev)
    offs_y = torch.arange(-win_y, win_y + 1, low_resolution, device=dev)
    nxc, nyc = offs_x.numel(), offs_y.numel()
    flat, hp, wp = _padded(coarse_map)
    scores = torch.empty((q, nt, nxc, nyc), dtype=f32, device=dev)
    step = max(1, CHUNK_ELEMS // (q * nb * nxc * nyc))
    for t0 in range(0, nt, step):
        t1 = min(nt, t0 + step)
        scores[:, t0:t1] = _window_sums(
            flat, hp, wp, ix[:, t0:t1], iy[:, t0:t1], offs_x[None, None],
            offs_y[None, None], wgt)
    live = t_idx.abs()[None, :].to(f32) <= win_act[:, None]
    scores = torch.where(live[:, :, None, None], scores,
                         torch.full_like(scores, -torch.inf))
    flat = scores.reshape(q, -1)
    ranked, order = matchers.top_k(flat, flat.shape[1])
    return _Coarse(sensor_poses, step_t, ix, iy, wgt, ranked, order)


def _refine(cs: _Coarse, fine_flat, hp: int, wp: int, m: int,
            low_resolution: int, win_x: int, win_y: int, win_theta_max: int,
            resolution: float):
    """Stage 2 with the ``m`` best blocks (``correlative_coarse.py:
    100-163`` of the JAX package). Returns the best refined score f32[Q],
    the best sensor poses f32[Q, 3] and the certificate bool[Q]."""
    q, nb = cs.wgt.shape
    dev = cs.wgt.device
    f32 = torch.float32
    lr = low_resolution
    offs_x = torch.arange(-win_x, win_x + 1, lr, device=dev)
    offs_y = torch.arange(-win_y, win_y + 1, lr, device=dev)
    nxc, nyc = offs_x.numel(), offs_y.numel()

    top = cs.order[:, :m]                                         # [Q, M]
    unrefined_ub = cs.ranked[:, m]
    bt = top // (nxc * nyc)
    bx = offs_x[(top // nyc) % nxc]
    by = offs_y[top % nyc]
    alive = torch.isfinite(cs.ranked[:, :m])
    fine_d = torch.arange(lr, device=dev)

    scores = torch.empty((q, m, lr, lr), dtype=f32, device=dev)
    step = max(1, CHUNK_ELEMS // (q * nb * lr * lr))
    for b0 in range(0, m, step):
        b1 = min(m, b0 + step)
        rows = bt[:, b0:b1, None].expand(q, b1 - b0, nb)
        scores[:, b0:b1] = _window_sums(
            fine_flat, hp, wp, torch.gather(cs.ix, 1, rows),
            torch.gather(cs.iy, 1, rows), bx[:, b0:b1, None] + fine_d,
            by[:, b0:b1, None] + fine_d, cs.wgt)
    scores = torch.where(alive[:, :, None, None], scores,
                         torch.full_like(scores, -torch.inf))

    # First maximum in the blocks' rank order, then (dx, dy).
    flat = scores.reshape(q, -1)
    best = torch.argmax(flat, dim=1)
    score_max = torch.gather(flat, 1, best[:, None])[:, 0]
    bi = (best // (lr * lr))[:, None]
    best_t = torch.gather(bt, 1, bi)[:, 0] - win_theta_max
    best_x = torch.gather(bx, 1, bi)[:, 0] + (best // lr) % lr
    best_y = torch.gather(by, 1, bi)[:, 0] + best % lr
    res = gridops.scalar(resolution, dev)
    sp = cs.sensor_poses
    best_sensor_poses = torch.stack([
        sp[:, 0] + best_x.to(f32) * res,
        sp[:, 1] + best_y.to(f32) * res,
        sp[:, 2] + best_t.to(f32) * cs.step_t], dim=-1)
    # Exactness certificate: every unrefined block's bound strictly below
    # the best refined score (a tie could precede it in the reference's
    # scan order); -inf means nothing was left out.
    exact = ((score_max > unrefined_ub) | ~torch.isfinite(unrefined_ub)) & \
        torch.isfinite(score_max)
    return score_max, best_sensor_poses, exact


def _match(coarse_map, fine_map, grid: gridops.GridMap, initial_poses,
           ranges, angles, valid, scan_min_range, scan_max_range,
           rel_sensor_poses, n_total, *, low_resolution, range_x, range_y,
           range_theta, scan_range_max, usable_range_min, usable_range_max,
           score_threshold, refine_blocks, greedy_params,
           max_escalations, cost_type) -> TwoStageResult:
    """The escalation loop of ``two_stage_match_batch``
    (``correlative_coarse.py:247-284`` of the JAX package) on tensors on
    the map's device."""
    res = float(grid.resolution)
    win_x = int(np.ceil(0.5 * range_x / res))
    win_y = int(np.ceil(0.5 * range_y / res))
    win_t = matchers.static_max_theta_window(res, scan_range_max,
                                             range_theta)
    nxc = len(range(-win_x, win_x + 1, low_resolution))
    nyc = len(range(-win_y, win_y + 1, low_resolution))
    n_blocks = (2 * win_t + 1) * nxc * nyc

    cs = _coarse_stage(coarse_map, grid, initial_poses, ranges, angles,
                       valid, rel_sensor_poses, scan_range_max, range_theta,
                       low_resolution, win_x, win_y, win_t)
    cost_mask = matchers.range_gate(
        valid, ranges, usable_range_min, usable_range_max,
        scan_min_range[:, None], scan_max_range[:, None])
    fine_flat, hp, wp = _padded(fine_map)
    m = refine_blocks
    for attempt in range(max_escalations + 1):
        score, poses, exact = _refine(cs, fine_flat, hp, wp,
                                      min(m, n_blocks - 1), low_resolution,
                                      win_x, win_y, win_t, res)
        c, cov = matchers._cost_and_covariance(
            cost_type, fine_map, grid, poses, ranges, angles, cost_mask,
            greedy_params)
        summary = matchers._summary(score > score_threshold * n_total, c,
                                    score, n_total, initial_poses, poses,
                                    rel_sensor_poses, cov)
        packed = matchers_sweep.pack_summary(summary)
        packed[:, 15] = exact.to(torch.float32)
        host = device_mod.sync(packed, site="two_stage").numpy()
        exact_np = host[:, 15] > 0.5
        if exact_np.all() or m >= n_blocks - 1:
            return TwoStageResult(summary, exact_np | (m >= n_blocks - 1),
                                  attempt, host)
        m *= 4
    return TwoStageResult(summary, exact_np, max_escalations, host)


def _scan_rows(scan_store, ids, device):
    """The stored scans ``ids`` up to the store's beam bucket, on
    ``device``: ranges, angles, valid [Q, NB]; min and max range [Q];
    sensor offsets [Q, 3]. The JAX package reads every column of the
    store; the columns past the bucket are invalid and score 0."""
    nb = scan_store.beam_bucket()

    def up(arr):
        return device_mod.upload(arr, device, site="two_stage")

    return (up(scan_store.ranges[ids, :nb]), up(scan_store.angles[ids, :nb]),
            up(scan_store.valid[ids, :nb]), up(scan_store.min_range[ids]),
            up(scan_store.max_range[ids]),
            up(scan_store.rel_sensor_pose[ids]))


def two_stage_match_batch(coarse_map, fine_map, grid: gridops.GridMap,
                          initial_poses, *, low_resolution: int,
                          range_x: float, range_y: float,
                          range_theta: float, scan_range_max: float,
                          usable_range_min: float, usable_range_max: float,
                          score_threshold: float, refine_blocks: int,
                          greedy_params: tuple, scan_store, scan_ids,
                          num_total_beams=None, max_escalations: int = 2,
                          cost_type: str = "greedy_endpoint"
                          ) -> TwoStageResult:
    """Q two-stage matches of the stored scans ``scan_ids`` at
    ``initial_poses`` f32[Q, 3] (host) against ``fine_map`` f32[H, W] (the
    values of ``grid``) and its coarse map, with certificate escalation:
    while any query's certificate fails, the whole batch is refined again
    with four times the blocks, capped at ``n_blocks - 1`` and at
    ``max_escalations`` re-runs (``two_stage_match_batch`` of the JAX
    package). Beam totals per query are ``num_total_beams`` [Q] where
    given, else ``max(raw beams, 1)``."""
    ids = np.asarray(scan_ids)
    dev = fine_map.device
    ranges, angles, valid, rmin, rmax, rel = _scan_rows(scan_store, ids, dev)
    if num_total_beams is None:
        num_total_beams = np.maximum(scan_store.raw_beams[ids], 1)
    n_total = device_mod.upload(
        np.asarray(num_total_beams, np.float32).reshape(len(ids)), dev,
        site="two_stage")
    poses = device_mod.upload(
        np.asarray(initial_poses, np.float32).reshape(len(ids), 3), dev,
        site="two_stage")
    return _match(coarse_map, fine_map, grid, poses, ranges, angles, valid,
                  rmin, rmax, rel, n_total, low_resolution=low_resolution,
                  range_x=range_x, range_y=range_y, range_theta=range_theta,
                  scan_range_max=scan_range_max,
                  usable_range_min=usable_range_min,
                  usable_range_max=usable_range_max,
                  score_threshold=score_threshold,
                  refine_blocks=refine_blocks, greedy_params=greedy_params,
                  max_escalations=max_escalations, cost_type=cost_type)


def two_stage_match(coarse_map, fine_map, grid: gridops.GridMap,
                    initial_pose, *, num_total_beams, scan_id: int, **kw):
    """One query of :func:`two_stage_match_batch` with its beam total
    given (``two_stage_match`` of the JAX package); ``kw`` are the batch's
    keywords. Returns ``(MatchSummary of one query, exact: bool)``."""
    out = two_stage_match_batch(coarse_map, fine_map, grid, initial_pose,
                                scan_ids=[scan_id],
                                num_total_beams=[num_total_beams], **kw)
    return matchers.MatchSummary(*(x[0] for x in out.summary)), \
        bool(out.exact[0])
