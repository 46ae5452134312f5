"""Vectorized ray-cast scatter update of log-odds submaps.

Counterpart of ``my_lidar_graph_slam_tpu/ops/raycast.py``: all beams of a
scan are traced at once with a driving-axis DDA whose per-step cells match
Bresenham's (grid_map_builder.cpp:167-186, util.hpp:257-303), and all
(beam, step) contributions are applied as one masked scatter-add of
log-odds increments plus a scatter-max of ``observed``.

The map is clamped after EACH scan (approximating the reference's
per-update clamp, binary_bayes_grid_cell.hpp:90-99), so scan order
matters: :func:`integrate_scans` walks its scans in order and
never merges them into one scatter. :func:`integrate_scans_stacked` (and
through it :func:`integrate_scan` and :func:`integrate_scans`) runs this
plain PyTorch path on CPU tensors; CUDA tensors take the K3 kernel
(``ops/cuda/raycast.py``), one launch a call, which walks the same cells
and adds whole-number hit and miss counts, so its maps are the same bits
from run to run; any other device raises. :func:`integrate_scan_counting`
walks the same cells into a counting map; its whole-number counts are the
same bits on the card.
"""

from __future__ import annotations

import torch

from my_lidar_graph_slam_tpu_torch.ops import grid as gridops
from my_lidar_graph_slam_tpu_torch.ops.cuda import raycast as kernel
from my_lidar_graph_slam_tpu_torch.utils import device as device_mod
from my_lidar_graph_slam_tpu_torch.utils import se2
from my_lidar_graph_slam_tpu_torch.utils.metrics import MetricManager


def trace_cells(grid: gridops.GridMap, sensor_pose, ranges, angles, valid,
                usable_range_min, usable_range_max, max_steps: int):
    """Bresenham-equivalent cell walk for one scan.

    ``sensor_pose`` f32[3]; ``ranges``/``angles``/``valid`` [NB];
    the range bounds are floats or 0-d tensors. Returns
    ``(miss_flat, miss_ok, hit_flat, hit_ok)``: flattened int64 cell
    indices (clamped into the map) and in-map masks, as in
    ``raycast.trace_cells`` of the JAX package.
    """
    return trace_cells_batched(
        grid.shape, grid.origin[None], grid.resolution, sensor_pose[None],
        ranges[None], angles[None], valid[None],
        usable_range_min, usable_range_max, max_steps)


def trace_cells_batched(shape, origins, resolution, sensor_poses, ranges,
                        angles, valid, usable_range_min, usable_range_max,
                        max_steps: int):
    """:func:`trace_cells` for one scan on each of M maps at once.

    ``origins`` f32[M, 2], ``sensor_poses`` f32[M, 3], scan tensors
    [M, NB]; range bounds broadcast against [M]. Flat indices address a
    single map (add ``m * H * W`` to address map ``m`` of a stack).
    """
    h, w = shape
    dev = ranges.device
    rmin = torch.as_tensor(usable_range_min, dtype=torch.float32, device=dev)
    rmax = torch.as_tensor(usable_range_max, dtype=torch.float32, device=dev)
    use = valid & (ranges > rmin.reshape(-1, 1)) & \
        (ranges < rmax.reshape(-1, 1))                       # [M, NB]

    res = gridops.scalar(resolution, dev)
    world_angle = sensor_poses[:, 2:3] + angles
    hit_x = sensor_poses[:, 0:1] + ranges * torch.cos(world_angle)
    hit_y = sensor_poses[:, 1:2] + ranges * torch.sin(world_angle)
    hix = torch.floor((hit_x - origins[:, 0:1]) / res).to(torch.int32)
    hiy = torch.floor((hit_y - origins[:, 1:2]) / res).to(torch.int32)
    six = torch.floor((sensor_poses[:, 0:1] - origins[:, 0:1]) / res
                      ).to(torch.int32)                      # [M, 1]
    siy = torch.floor((sensor_poses[:, 1:2] - origins[:, 1:2]) / res
                      ).to(torch.int32)

    # Driving-axis DDA == Bresenham cell walk (util.hpp:257-303): n =
    # max(|dx|, |dy|) miss cells from the sensor cell, the hit cell popped.
    dx = hix - six
    dy = hiy - siy
    n_steps = torch.maximum(dx.abs(), dy.abs())              # [M, NB]
    n_safe = torch.clamp(n_steps, min=1)
    steps = torch.arange(max_steps, dtype=torch.int32, device=dev)
    frac = steps.to(torch.float32) / n_safe[..., None].to(torch.float32)
    miss_ix = six[..., None] + torch.round(
        frac * dx[..., None].to(torch.float32)).to(torch.int32)
    miss_iy = siy[..., None] + torch.round(
        frac * dy[..., None].to(torch.float32)).to(torch.int32)
    miss_mask = use[..., None] & (steps < n_steps[..., None])

    def flat_ok(ix, iy, mask):
        ok = mask & (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        flat = iy.clamp(0, h - 1).long() * w + ix.clamp(0, w - 1).long()
        m = ix.shape[0]
        return flat.reshape(m, -1), ok.reshape(m, -1)

    miss_flat, miss_ok = flat_ok(miss_ix, miss_iy, miss_mask)
    hit_flat, hit_ok = flat_ok(hix, hiy, use)
    return miss_flat, miss_ok, hit_flat, hit_ok


def _apply(log_odds_flat, observed_flat, flat, lo_miss, lo_hit):
    """Scatter one scan's traced cells into flat map storage, in place:
    misses then hits, then the per-scan clamp."""
    miss_flat, miss_ok, hit_flat, hit_ok = flat
    zero = torch.zeros((), dtype=torch.float32, device=log_odds_flat.device)
    log_odds_flat.index_put_((miss_flat,), torch.where(miss_ok, lo_miss, zero),
                             accumulate=True)
    log_odds_flat.index_put_((hit_flat,), torch.where(hit_ok, lo_hit, zero),
                             accumulate=True)
    obs = observed_flat.view(torch.uint8)
    obs.scatter_reduce_(0, miss_flat, miss_ok.to(torch.uint8), "amax")
    obs.scatter_reduce_(0, hit_flat, hit_ok.to(torch.uint8), "amax")
    log_odds_flat.clamp_(-gridops.LOG_ODDS_MAX, gridops.LOG_ODDS_MAX)


def integrate_scan(grid: gridops.GridMap, sensor_pose, ranges, angles, valid,
                   usable_range_min, usable_range_max, prob_hit=0.6,
                   prob_miss=0.45, max_steps: int = 448) -> gridops.GridMap:
    """Integrate one scan into the map (grid_map_builder.cpp:145-186).

    Returns a new map; ``grid`` is left unchanged. ``usable_range_min/max``
    are the effective range gate, already combined with the scan's own
    limits by the caller (grid_map_builder.cpp:357-361).
    """
    return integrate_scans(
        grid, sensor_pose[None], ranges[None], angles[None], valid[None],
        torch.zeros((1, 3), dtype=torch.float32, device=ranges.device),
        device_mod.upload([usable_range_min], ranges.device, torch.float32,
                          site="integrate_scan"),
        device_mod.upload([usable_range_max], ranges.device, torch.float32,
                          site="integrate_scan"),
        prob_hit=prob_hit, prob_miss=prob_miss, max_steps=max_steps)


def integrate_scan_counting(grid: gridops.CountingGridMap, sensor_pose,
                            ranges, angles, valid, usable_range_min,
                            usable_range_max, max_steps: int = 448
                            ) -> gridops.CountingGridMap:
    """Integrate one scan under the hit/miss-ratio cell policy
    (counting_grid_cell.hpp:15-85; ``integrate_scan_counting`` of the JAX
    package): hit cells get (hits + 1, counts + 1), miss cells counts + 1,
    through the same cell walk as :func:`integrate_scan`. Returns a new
    map. The counts are whole numbers, so the order of the card's atomic
    adds cannot change them."""
    miss_flat, miss_ok, hit_flat, hit_ok = trace_cells(
        grid, sensor_pose, ranges, angles, valid, usable_range_min,
        usable_range_max, max_steps)
    h, w = grid.shape
    counts = grid.counts.clone().reshape(-1)
    hits = grid.hits.clone().reshape(-1)
    counts.index_put_((miss_flat.reshape(-1),),
                      miss_ok.reshape(-1).to(torch.float32), accumulate=True)
    hit_one = hit_ok.reshape(-1).to(torch.float32)
    counts.index_put_((hit_flat.reshape(-1),), hit_one, accumulate=True)
    hits.index_put_((hit_flat.reshape(-1),), hit_one, accumulate=True)
    return grid._replace(hits=hits.reshape(h, w), counts=counts.reshape(h, w))


def integrate_scans(grid: gridops.GridMap, node_poses, scan_ranges,
                    scan_angles, scan_valid, rel_sensor_poses,
                    usable_range_min, usable_range_max, scan_active=None,
                    prob_hit=0.6, prob_miss=0.45,
                    max_steps: int = 448) -> gridops.GridMap:
    """Rebuild/extend a map from K scans, in node order
    (``ConstructMapFromScans``, grid_map_builder.cpp:227-332).

    ``node_poses`` f32[K, 3] robot poses; ``rel_sensor_poses`` f32[K, 3];
    ``usable_range_min/max`` f32[K]; ``scan_active`` bool[K] rows that hold
    scans. Returns a new map.
    """
    log_odds, observed = integrate_scans_stacked(
        grid.log_odds[None], grid.observed[None], grid.origin[None],
        grid.resolution, node_poses[None], scan_ranges[None],
        scan_angles[None], scan_valid[None], rel_sensor_poses[None],
        usable_range_min[None], usable_range_max[None],
        None if scan_active is None else scan_active[None],
        prob_hit=prob_hit, prob_miss=prob_miss, max_steps=max_steps)
    return grid._replace(log_odds=log_odds[0], observed=observed[0])


def integrate_scans_stacked(log_odds, observed, origins, resolution,
                            node_poses, scan_ranges, scan_angles, scan_valid,
                            rel_sensor_poses, usable_range_min,
                            usable_range_max, scan_active=None,
                            prob_hit=0.6, prob_miss=0.45,
                            max_steps: int = 448, donate: bool = False):
    """:func:`integrate_scans` on M same-size maps at once.

    ``log_odds``/``observed`` [M, H, W] (copied, not modified, unless
    ``donate``: then the caller gives them up and the kernel may write
    into them); scan tensors [M, K, ...]; ``origins`` f32[M, 2]. Step k
    integrates scan k of every map, so each map sees its own scans in
    order, exactly as M separate calls would. Returns ``(log_odds,
    observed)``. CPU tensors take :func:`integrate_scans_stacked_plain`;
    CUDA tensors launch the K3 kernel once (and raise if it cannot be
    built or launched), which clamps only the cells it touches: the same
    map for input maps within the clamp, as every map the port builds is.
    """
    dev = log_odds.device
    if dev.type == "cpu":
        return integrate_scans_stacked_plain(
            log_odds, observed, origins, resolution, node_poses, scan_ranges,
            scan_angles, scan_valid, rel_sensor_poses, usable_range_min,
            usable_range_max, scan_active, prob_hit, prob_miss, max_steps)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if donate:
        lo, ob = log_odds.contiguous(), observed.contiguous()
    else:
        lo = log_odds.clone(memory_format=torch.contiguous_format)
        ob = observed.clone(memory_format=torch.contiguous_format)
    sensor_poses = se2.compound(node_poses, rel_sensor_poses)  # [M, K, 3]
    kernel.integrate(
        lo, ob, origins.contiguous(), sensor_poses.contiguous(),
        scan_ranges.contiguous(), scan_angles.contiguous(),
        scan_valid.contiguous(),
        None if scan_active is None else scan_active.contiguous(),
        usable_range_min.contiguous(), usable_range_max.contiguous(),
        gridops.logit(gridops.scalar(prob_miss, dev)),
        gridops.logit(gridops.scalar(prob_hit, dev)),
        float(resolution), max_steps, gridops.LOG_ODDS_MAX)
    return lo, ob


def integrate_scans_stacked_plain(log_odds, observed, origins, resolution,
                                  node_poses, scan_ranges, scan_angles,
                                  scan_valid, rel_sensor_poses,
                                  usable_range_min, usable_range_max,
                                  scan_active=None, prob_hit=0.6,
                                  prob_miss=0.45, max_steps: int = 448):
    """:func:`integrate_scans_stacked` in plain PyTorch on any device: per
    scan, :func:`trace_cells_batched` and :func:`_apply`."""
    m, h, w = log_odds.shape
    k = node_poses.shape[1]
    dev = log_odds.device
    MetricManager.instance().counters("RaycastPlainScans").increment(m * k)
    lo = log_odds.clone().reshape(-1)
    ob = observed.clone().reshape(-1)
    if scan_active is None:
        scan_active = torch.ones((m, k), dtype=torch.bool, device=dev)
    sensor_poses = se2.compound(node_poses, rel_sensor_poses)  # [M, K, 3]
    lo_miss = gridops.logit(gridops.scalar(prob_miss, dev))
    lo_hit = gridops.logit(gridops.scalar(prob_hit, dev))
    offset = (torch.arange(m, device=dev, dtype=torch.int64) * (h * w)
              )[:, None]
    for step in range(k):
        miss_flat, miss_ok, hit_flat, hit_ok = trace_cells_batched(
            (h, w), origins, resolution, sensor_poses[:, step],
            scan_ranges[:, step], scan_angles[:, step],
            scan_valid[:, step] & scan_active[:, step, None],
            usable_range_min[:, step], usable_range_max[:, step], max_steps)
        _apply(lo, ob,
               ((miss_flat + offset).reshape(-1), miss_ok.reshape(-1),
                (hit_flat + offset).reshape(-1), hit_ok.reshape(-1)),
               lo_miss, lo_hit)
    return lo.reshape(m, h, w), ob.reshape(m, h, w)


def kernel_tolerance(log_odds, observed, origins, resolution, node_poses,
                     scan_ranges, scan_angles, scan_valid, rel_sensor_poses,
                     usable_range_min, usable_range_max, scan_active=None,
                     prob_hit=0.6, prob_miss=0.45,
                     max_steps: int = 448) -> float:
    """A bound on |K3 - plain| log-odds for one :func:`integrate_scans_stacked`
    call with these arguments, from the plain walk's counts. Per scan and
    cell the plain cast sums n equal increments x (in any order:
    |fl(sum) - n x| <= (n - 1) u n |x|, u the float32 unit roundoff), the
    kernel forms n x (one rounding); each side then rounds at most three
    times more (the two adds, the product) on values of at most
    L + n|x|, L = LOG_ODDS_MAX. The clamp does not widen a gap, so the
    per-scan bounds add up. ``observed`` is not read."""
    u = 2.0 ** -24
    m, h, w = log_odds.shape
    x_miss = abs(float(gridops.logit(torch.tensor(prob_miss))))
    x_hit = abs(float(gridops.logit(torch.tensor(prob_hit))))
    sensor = se2.compound(node_poses, rel_sensor_poses)
    tol = 0.0
    for k in range(sensor.shape[1]):
        valid = scan_valid[:, k]
        if scan_active is not None:
            valid = valid & scan_active[:, k, None]
        mf, mo, hf, ho = trace_cells_batched(
            (h, w), origins, resolution, sensor[:, k], scan_ranges[:, k],
            scan_angles[:, k], valid, usable_range_min[:, k],
            usable_range_max[:, k], max_steps)
        nm = int(torch.bincount(mf[mo]).max()) if mo.any() else 0
        nh = int(torch.bincount(hf[ho]).max()) if ho.any() else 0
        tol += u * (nm * nm * x_miss + nh * nh * x_hit +
                    6 * (gridops.LOG_ODDS_MAX + nm * x_miss + nh * x_hit))
    return tol
