"""The reference map builder: log-odds occupancy maps from scans at poses.

Plain PyTorch. Each scan's beams are walked from the sensor cell to the
hit cell (the driving-axis walk that equals Bresenham's,
grid_map_builder.cpp:167-186 and util.hpp:257-303): every cell before the
hit cell gets the miss increment, the hit cell the hit increment, and the
map is clamped to the reference's bounds after each scan
(binary_bayes_grid_cell.hpp:90-99), scans in order. The cell walk uses
the float32 operations of ``trace_cells_batched`` in
``my_lidar_graph_slam_tpu_torch/ops/raycast.py`` at commit 8e18ecb, so
that both sides pick the same cells; the increments accumulate in
``dtype`` (float64 for the reference, bfloat16 for the control).
"""

from __future__ import annotations

import math

import numpy as np
import torch

PROB_MIN = 1e-3
LOG_ODDS_MAX = math.log((1.0 - PROB_MIN) / PROB_MIN)


def logit(p: float) -> float:
    return math.log(p) - math.log1p(-p)


def compound32(start, diff):
    """SE(2) ``start (+) diff`` in float32 tensors."""
    s = torch.sin(start[..., 2])
    c = torch.cos(start[..., 2])
    x = c * diff[..., 0] - s * diff[..., 1] + start[..., 0]
    y = s * diff[..., 0] + c * diff[..., 1] + start[..., 1]
    return torch.stack([x, y, start[..., 2] + diff[..., 2]], dim=-1)


def origin_for(center, size: int, resolution: float) -> np.ndarray:
    """float32 origin of a ``size``-cell square map centred on
    ``center``."""
    center = np.asarray(center, np.float32)
    return center - 0.5 * resolution * np.array([size, size], np.float32)


def trace(shape, origin, resolution: float, sensor_pose, ranges, angles,
          use, max_steps: int):
    """Flat miss and hit cell indices and their in-map masks of one scan:
    ``origin`` f32[2], ``sensor_pose`` f32[3], ``ranges``/``angles`` f32
    and ``use`` bool [NB]."""
    h, w = shape
    dev = ranges.device
    res = torch.full((), resolution, dtype=torch.float32, device=dev)
    world_angle = sensor_pose[2] + angles
    hit_x = sensor_pose[0] + ranges * torch.cos(world_angle)
    hit_y = sensor_pose[1] + ranges * torch.sin(world_angle)
    hix = torch.floor((hit_x - origin[0]) / res).to(torch.int32)
    hiy = torch.floor((hit_y - origin[1]) / res).to(torch.int32)
    six = torch.floor((sensor_pose[0] - origin[0]) / res).to(torch.int32)
    siy = torch.floor((sensor_pose[1] - origin[1]) / res).to(torch.int32)
    dx = hix - six
    dy = hiy - siy
    n_steps = torch.maximum(dx.abs(), dy.abs())
    n_safe = torch.clamp(n_steps, min=1)
    steps = torch.arange(max_steps, dtype=torch.int32, device=dev)
    frac = steps.to(torch.float32) / n_safe[:, None].to(torch.float32)
    mix = six + torch.round(frac * dx[:, None].to(torch.float32)
                            ).to(torch.int32)
    miy = siy + torch.round(frac * dy[:, None].to(torch.float32)
                            ).to(torch.int32)
    miss_ok = use[:, None] & (steps[None, :] < n_steps[:, None]) & \
        (mix >= 0) & (mix < w) & (miy >= 0) & (miy < h)
    hit_ok = use & (hix >= 0) & (hix < w) & (hiy >= 0) & (hiy < h)
    miss = (miy.long() * w + mix.long())[miss_ok]
    hit = (hiy.long() * w + hix.long())[hit_ok]
    return miss, hit


def build(size: int, origin, resolution: float, rows, prob_hit: float,
          prob_miss: float, max_steps: int, device, dtype=torch.float64):
    """Log-odds ``dtype[size, size]`` and observed ``bool[size, size]`` of
    a map with ``origin`` (f32[2]) from ``rows``: (robot pose [3],
    rel sensor pose [3], ranges [N], angles [N], usable min, usable max)
    in integration order."""
    lo = torch.zeros(size * size, dtype=dtype, device=device)
    ob = torch.zeros(size * size, dtype=torch.bool, device=device)
    o = torch.as_tensor(np.asarray(origin, np.float32), device=device)
    lo_miss = torch.tensor(logit(prob_miss), dtype=dtype, device=device)
    lo_hit = torch.tensor(logit(prob_hit), dtype=dtype, device=device)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    for pose, rel, ranges, angles, rmin, rmax in rows:
        sensor = compound32(f32(pose), f32(rel))
        r = f32(ranges)
        use = (r > f32(rmin)) & (r < f32(rmax))
        miss, hit = trace((size, size), o, resolution, sensor, r,
                          f32(angles), use, max_steps)
        lo.index_add_(0, miss, lo_miss.expand(miss.shape[0]))
        lo.index_add_(0, hit, lo_hit.expand(hit.shape[0]))
        ob[miss] = True
        ob[hit] = True
        lo.clamp_(-LOG_ODDS_MAX, LOG_ODDS_MAX)
    return lo.reshape(size, size), ob.reshape(size, size)
