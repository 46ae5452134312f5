"""The reference scan matchers and the greedy-endpoint cost.

Plain PyTorch. The candidate lattice (the theta step from the cosine
law, scan_matcher_real_time_correlative.cpp:156-175; the window of
``SearchRange`` halves around the initial pose; hit cells by angle
addition) and the beam gates follow the reference C++ and are computed
with the float32 operations of ``my_lidar_graph_slam_tpu_torch/ops/
matchers.py``, ``matchers_sweep.py`` and ``scoring.py`` at commit 8e18ecb,
so that both sides score the same cells. The scores themselves are summed
in ``dtype``: float64 for the reference, bfloat16 for the control.

* :func:`sweep_scores` scores every (theta, dx, dy) of the window: the
  exhaustive search of ScanMatcherRealTimeCorrelative and of the
  BranchBound loop detector served by the sweep.
* :func:`branch_bound` is a frozen copy of the level-synchronous
  branch-and-bound of ``ops/matchers.py::branch_bound_match`` (its
  frontier quota included), over the reference's own pyramid.
* :func:`greedy_cost_cov` is a frozen copy of the plain greedy-endpoint
  cost and covariance of ``ops/cuda/greedy_cost.py``
  (``greedy_cost_cov_plain``; cost_function_greedy_endpoint.cpp).
"""

from __future__ import annotations

import math

import numpy as np
import torch

PROB_MIN = 1e-3
DIFF_ANG = 1e-2
_AXIS_POSES = {0: (0, 0), 1: (1, 0), 2: (0, 1), 4: (-1, 0), 5: (0, -1)}
_THETA_POSES = {3: 1, 6: 2}


def scalar(value: float, device) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=device)


def values(log_odds, observed, dtype=torch.float32):
    """Occupancy probability of each cell, 0 where never observed
    (grid_map.hpp:806), in ``dtype``."""
    prob = torch.clamp(1.0 / (1.0 + torch.exp(-log_odds.to(torch.float32))),
                       PROB_MIN, 1.0 - PROB_MIN)
    return torch.where(observed, prob, torch.zeros_like(prob)).to(dtype)


def search_step_theta(res, max_range):
    t = res / max_range
    return torch.arccos(1.0 - 0.5 * t * t)


def static_max_theta_window(resolution, scan_range_max, range_theta) -> int:
    t = resolution / scan_range_max
    return int(math.ceil(0.5 * range_theta / math.acos(1.0 - 0.5 * t * t)))


def beam_gate(valid, ranges, gate: str, scan_range_max: float,
              usable_min: float, usable_max: float, scan_min: float,
              scan_max: float):
    """Beams that score: ``"correlative"`` (the frontend's projection
    gate, scan_matcher_real_time_correlative.cpp:189-193),
    ``"pixel_accurate"`` (score_function_pixel_accurate.cpp:27-41, with
    the projection gate) or ``"range"`` (the usable and scan range gate
    alone, which branch-and-bound and the greedy cost apply)."""
    in_range = valid & (ranges > max(scan_min, usable_min)) & \
        (ranges < min(scan_max, usable_max))
    if gate == "range":
        return in_range
    if gate == "pixel_accurate":
        return in_range & (ranges < scan_range_max)
    if gate == "correlative":
        return valid & (ranges < scan_range_max)
    raise ValueError(f"unknown gate {gate!r}")


def sensor_and_step(pose, rel, ranges, valid, res: float,
                    scan_range_max: float):
    """float32 sensor pose [3] and theta step of one query."""
    from slambench.reference.maps import compound32
    sensor = compound32(pose, rel)
    max_range = torch.clamp(torch.where(valid, ranges, torch.full_like(
        ranges, -torch.inf)).amax(), max=scan_range_max)
    return sensor, search_step_theta(scalar(res, ranges.device), max_range)


def lattice_cells(origin, res: float, sensor, ranges, angles, step_t,
                  t_idx):
    """int32 (ix, iy) [T, NB] at the theta lattice ``t_idx`` i64[T]."""
    dev = ranges.device
    c0 = torch.cos(sensor[2] + angles)
    s0 = torch.sin(sensor[2] + angles)
    dt = t_idx.to(torch.float32) * step_t
    ct = torch.cos(dt)[:, None]
    st = torch.sin(dt)[:, None]
    cos_phi = c0[None, :] * ct - s0[None, :] * st
    sin_phi = s0[None, :] * ct + c0[None, :] * st
    hx = sensor[0] + ranges[None, :] * cos_phi
    hy = sensor[1] + ranges[None, :] * sin_phi
    r = scalar(res, dev)
    return (torch.floor((hx - origin[0]) / r).to(torch.int32),
            torch.floor((hy - origin[1]) / r).to(torch.int32))


def _gather(vmap, ix, iy):
    h, w = vmap.shape
    ok = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    v = vmap[iy.clamp(0, h - 1).long(), ix.clamp(0, w - 1).long()]
    return torch.where(ok, v, torch.zeros_like(v))


def sweep_scores(vmap, origin, res: float, sensor, step_t, ranges, angles,
                 weight, win_x: int, win_y: int, win_t: int,
                 range_theta: float):
    """Scores [2 win_t + 1, 2 win_x + 1, 2 win_y + 1] of every window
    candidate in ``vmap``'s dtype (-inf on thetas outside the live range),
    and the lattice of thetas."""
    dev = ranges.device
    t_idx = torch.arange(-win_t, win_t + 1, device=dev)
    ix, iy = lattice_cells(origin, res, sensor, ranges, angles, step_t,
                           t_idx)
    keep = weight > 0
    ix, iy = ix[:, keep], iy[:, keep]
    out = torch.empty((2 * win_t + 1, 2 * win_x + 1, 2 * win_y + 1),
                      dtype=vmap.dtype, device=dev)
    for a, dx in enumerate(range(-win_x, win_x + 1)):
        for b, dy in enumerate(range(-win_y, win_y + 1)):
            out[:, a, b] = _gather(vmap, ix + dx, iy + dy).sum(dim=1)
    act = torch.ceil(0.5 * scalar(range_theta, dev) / step_t).clamp(
        max=win_t)
    live = t_idx.abs().to(torch.float32) <= act
    out[~live] = -torch.inf
    return out


def first_max(scores):
    """Flat index of the first maximum in (theta, dx, dy) order and its
    value."""
    flat = scores.reshape(-1)
    best = int(torch.argmax(flat))
    return best, flat[best]


def score_at(vmap, origin, res: float, pose, ranges, angles, weight):
    """Pixel-accurate score (a sum in ``vmap``'s dtype) of one sensor pose
    f32[3] (score_function_pixel_accurate.cpp)."""
    dev = ranges.device
    wa = pose[2] + angles
    hx = pose[0] + ranges * torch.cos(wa)
    hy = pose[1] + ranges * torch.sin(wa)
    r = scalar(res, dev)
    ix = torch.floor((hx - origin[0]) / r).to(torch.int32)
    iy = torch.floor((hy - origin[1]) / r).to(torch.int32)
    return (_gather(vmap, ix, iy) * weight.to(vmap.dtype)).sum()


def build_pyramid(vmap, height_max: int):
    """[height_max + 1, H, W]: level h is the max of the 2^h x 2^h block
    beginning at each cell, zero past the far edges
    (grid_map_builder.cpp:471-536; ``ops/pyramid.py``)."""
    levels = [vmap]
    cur = vmap
    for h in range(1, height_max + 1):
        off = 1 << (h - 1)
        shifted_x = torch.nn.functional.pad(cur, (0, off))[:, off:]
        row = torch.maximum(cur, shifted_x)
        shifted_y = torch.nn.functional.pad(row, (0, 0, 0, off))[off:, :]
        cur = torch.maximum(row, shifted_y)
        levels.append(cur)
    return torch.stack(levels, dim=0)


def branch_bound(pyramid, origin, res: float, sensor, step_t, ranges,
                 angles, weight, threshold: float, node_height_max: int,
                 win_x: int, win_y: int, win_t: int, range_theta: float,
                 frontier_cap: int):
    """One query of ``branch_bound_match`` (scan_matcher_branch_bound.cpp:
    81-139 with the port's per-level frontier quota). Returns the best
    leaf (x, y, t) and whether it beat ``threshold``."""
    dev = ranges.device
    f32 = torch.float32
    dtype = pyramid.dtype
    act = torch.ceil(0.5 * scalar(range_theta, dev) / step_t)
    step = 1 << node_height_max
    gx, gy, gt = torch.meshgrid(
        torch.arange(-win_x, win_x + 1, step, device=dev),
        torch.arange(-win_y, win_y + 1, step, device=dev),
        torch.arange(-win_t, win_t + 1, device=dev), indexing="ij")
    fx, fy, ft = gx.reshape(-1), gy.reshape(-1), gt.reshape(-1)
    n0 = fx.numel()
    alive = ft.abs().to(f32) <= act
    cap = max(frontier_cap, n0)
    r = scalar(res, dev)
    keep_beam = weight > 0
    rr, aa = ranges[keep_beam], angles[keep_beam]

    def eval_level(level_map, mask):
        px = sensor[0] + fx.to(f32) * res
        py = sensor[1] + fy.to(f32) * res
        pt = sensor[2] + ft.to(f32) * step_t
        wa = pt[:, None] + aa[None, :]
        hx = px[:, None] + rr[None, :] * torch.cos(wa)
        hy = py[:, None] + rr[None, :] * torch.sin(wa)
        ix = torch.floor((hx - origin[0]) / r).to(torch.int32)
        iy = torch.floor((hy - origin[1]) / r).to(torch.int32)
        s = _gather(level_map, ix, iy).sum(dim=1)
        return torch.where(mask, s, torch.full_like(s, -torch.inf))

    thr = torch.tensor(threshold, dtype=dtype, device=dev)
    best_score = thr.clone()
    best = None
    for h in range(node_height_max, -1, -1):
        ub = eval_level(pyramid[h], alive)
        if h == 0:
            leaf = int(torch.argmax(ub))
            if bool(ub[leaf] > best_score):
                best = (int(fx[leaf]), int(fy[leaf]), int(ft[leaf]))
            break
        lb = eval_level(pyramid[0], alive)
        best_lb = torch.maximum(lb.amax(), thr)
        keep = alive & (ub > best_lb) & (ub > thr)
        size = fx.shape[0]
        kquota = min(size, cap // 4)
        idx = torch.nonzero(keep).reshape(-1)[:kquota]
        w = 1 << (h - 1)
        child = torch.arange(4, device=dev)
        fx = (fx[idx][:, None] + child % 2 * w).reshape(-1)
        fy = (fy[idx][:, None] + child // 2 * w).reshape(-1)
        ft = ft[idx][:, None].expand(-1, 4).reshape(-1)
        alive = torch.ones_like(fx, dtype=torch.bool)
    return best


def prepare_cells(origin, sensor, ranges, angles, res: float,
                  hit_and_missed_dist: float):
    """int32 [4, 3, NB]: hit x, hit y, missed x, missed y at the base,
    +theta and -theta angles."""
    dev = ranges.device
    r_ = scalar(res, dev)
    th = sensor[2]
    thetas = torch.stack([th, th + DIFF_ANG, th - DIFF_ANG])
    wa = thetas[:, None] + angles[None, :]
    cos_t, sin_t = torch.cos(wa), torch.sin(wa)
    r = ranges[None, :]
    rm = r - hit_and_missed_dist

    def cell(p, o):
        return torch.floor((p - o) / r_).to(torch.int32)

    return torch.stack([cell(sensor[0] + r * cos_t, origin[0]),
                        cell(sensor[1] + r * sin_t, origin[1]),
                        cell(sensor[0] + rm * cos_t, origin[0]),
                        cell(sensor[1] + rm * sin_t, origin[1])])


def greedy_cost_cov(vmap, origin, sensor, ranges, angles, mask, res: float,
                    hit_and_missed_dist: float, occupancy_threshold: float,
                    kernel_size: int, standard_deviation: float,
                    scaling_factor: float):
    """Cost and covariance [3, 3] at one sensor pose, in ``vmap``'s
    dtype: for each of the 7 poses (base, +x, +y, +theta, -x, -y,
    -theta) each masked beam takes the nearest usable cell of its
    (2k+1)^2 kernel (hit cell known and occupied, missed cell known and
    free) and adds exp(-d^2 / 2 sigma^2), d its distance; the covariance
    is the outer product of the central-difference gradient plus 0.01 I
    (cost_function_greedy_endpoint.cpp)."""
    dev = ranges.device
    dtype = vmap.dtype
    k = kernel_size
    thr = torch.tensor(float(np.float32(occupancy_threshold)),
                       dtype=dtype, device=dev)
    cells = prepare_cells(origin, sensor, ranges, angles, res,
                          hit_and_missed_dist)
    h, w = vmap.shape
    none = 2 * (k + 1) ** 2

    def patch(ix, iy, r):
        offs = torch.arange(-r, r + 1, device=dev)
        x = ix.long()[:, None, None] + offs[None, None, :]
        y = iy.long()[:, None, None] + offs[None, :, None]
        ok = (x >= 0) & (x < w) & (y >= 0) & (y < h)
        v = vmap[y.clamp(0, h - 1), x.clamp(0, w - 1)]
        return torch.where(ok, v, torch.zeros_like(v))

    def usable(a, r):
        hv = patch(cells[0, a], cells[1, a], r)
        mv = patch(cells[2, a], cells[3, a], r)
        return (hv != 0) & (mv != 0) & (hv >= thr) & (mv <= thr)

    offs = torch.arange(-k, k + 1, device=dev)
    cls = offs[None, :] ** 2 + offs[:, None] ** 2
    kk = 2 * k + 1

    def min_class(u):
        c = torch.where(u, cls.expand_as(u), torch.full_like(
            u, none, dtype=cls.dtype))
        return c.amin(dim=(-2, -1))

    ext = usable(0, k + 1)
    cmin = [None] * 7
    for p, (sx, sy) in _AXIS_POSES.items():
        cmin[p] = min_class(ext[:, sy + 1:sy + 1 + kk, sx + 1:sx + 1 + kk])
    for p, a in _THETA_POSES.items():
        cmin[p] = min_class(usable(a, k))
    cmin = torch.stack(cmin)                                   # [7, NB]
    r_ = scalar(res, dev)
    c = torch.arange(none + 1, dtype=torch.float32, device=dev)
    d2 = c * r_ * r_
    d2[-1] = 2.0 * ((k + 1) * r_) ** 2
    table = torch.exp(-0.5 * d2 / (standard_deviation * standard_deviation)
                      ).to(dtype)
    vals = torch.where(mask[None, :], table[cmin],
                       torch.zeros((), dtype=dtype, device=dev))
    costs = -vals.sum(dim=1) * scaling_factor                  # [7]
    steps = torch.stack([r_, r_, scalar(DIFF_ANG, dev)]).to(dtype)
    grad = 0.5 * (costs[1:4] - costs[4:7]) / steps
    cov = grad[:, None] * grad[None, :] + \
        0.01 * torch.eye(3, dtype=dtype, device=dev)
    return costs[0], cov


def lattice_index(value: float, start: float, step: float):
    """The whole number i with ``start + i * step == value`` to within a
    thousandth of a step, else None."""
    i = (value - start) / step
    j = round(i)
    return j if abs(i - j) < 1e-3 else None


def np32(a):
    return np.asarray(a, np.float32)
