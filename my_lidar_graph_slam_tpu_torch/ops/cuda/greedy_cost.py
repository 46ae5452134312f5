"""Greedy-endpoint cost + covariance: the K2 kernel's wrapper and plain
version.

Counterpart of ``my_lidar_graph_slam_tpu/ops/cost.py::
greedy_endpoint_cost_and_covariance_fused`` (the plain version, here
batched over Q queries with a per-query origin and an optional ``map_idx``
into stacked maps) and of the Pallas TPU kernel
``my_lidar_graph_slam_tpu/ops/pallas/greedy_cost_mxu.py::
greedy_cost_cov_mxu``, which the CUDA kernel in ``csrc/greedy_cost.cu``
replaces for every ``kernel_size``.

Reference semantics (cost_function_greedy_endpoint.cpp:32-171): per beam,
the nearest usable cell of a (2k+1)^2 kernel around the hit cell, where a
usable cell is known, occupied at the hit and free at the point
``hit_and_missed_dist`` short of it; the cost is
``-scaling * sum exp(-d^2 / 2 sigma^2)`` and the covariance is the outer
product of its central-difference gradient (steps res, res, 1e-2 rad)
plus 0.01 I.

The work splits in three: the cell preparation (cos/sin/floor, as
``greedy_cost_mxu.py:273-295``) and the epilogue (7 costs -> gradient ->
covariance) run in PyTorch for both versions; only the per-beam core
(:func:`greedy_cost_core`) is the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from my_lidar_graph_slam_tpu_torch.ops import grid as gridops
from my_lidar_graph_slam_tpu_torch.ops.cuda import loader

DIFF_ANG = 1e-2
# Axis poses as cell shifts (sx, sy) in the order of
# greedy_endpoint_covariance's deltas [base, +x, +y, +t, -x, -y, -t].
_AXIS_POSES = {0: (0, 0), 1: (1, 0), 2: (0, 1), 4: (-1, 0), 5: (0, -1)}
_THETA_POSES = {3: 1, 6: 2}   # pose -> angle row (+theta, -theta)


def prepare_cells(origin, sensor_poses, ranges, angles, resolution: float,
                  hit_and_missed_dist: float) -> torch.Tensor:
    """int32 [Q, 4, 3, NB]: (hit x, hit y, missed x, missed y) cells at the
    base, +theta and -theta angles. ``origin`` f32[2] or f32[Q, 2]."""
    q = sensor_poses.shape[0]
    dev = sensor_poses.device
    origin = origin.reshape(-1, 2).expand(q, 2)
    res = gridops.scalar(resolution, dev)
    th = sensor_poses[:, 2]
    thetas = torch.stack([th, th + DIFF_ANG, th - DIFF_ANG], dim=1)  # [Q, 3]
    wa = thetas[:, :, None] + angles[:, None, :]                    # [Q,3,NB]
    cos_t = torch.cos(wa)
    sin_t = torch.sin(wa)
    px = sensor_poses[:, 0, None, None]
    py = sensor_poses[:, 1, None, None]
    r = ranges[:, None, :]
    rm = r - hit_and_missed_dist
    ox = origin[:, 0, None, None]
    oy = origin[:, 1, None, None]

    def cell(p, o):
        return torch.floor((p - o) / res).to(torch.int32)

    return torch.stack([cell(px + r * cos_t, ox), cell(py + r * sin_t, oy),
                        cell(px + rm * cos_t, ox), cell(py + rm * sin_t, oy)],
                       dim=1)


def class_table(resolution: float, kernel_size: int,
                standard_deviation: float, device) -> torch.Tensor:
    """f32[2(k+1)^2 + 1]: ``exp(-d^2 / 2 sigma^2)`` for each squared cell
    distance class ``c = dx^2 + dy^2``, ``d^2 = c res^2``; the last entry
    is the no-usable-cell fallback ``d^2 = 2 ((k+1) res)^2``
    (cost.py:85-88 of the JAX package)."""
    k = kernel_size
    res = gridops.scalar(resolution, device)
    variance = standard_deviation * standard_deviation
    c = torch.arange(2 * (k + 1) ** 2 + 1, dtype=torch.float32,
                     device=device)
    d2 = c * res * res
    d2[-1] = 2.0 * ((k + 1) * res) ** 2
    return torch.exp(-0.5 * d2 / variance)


def _check_core(value_map, cells, mask, table, map_idx):
    if value_map.dtype != torch.float32 or value_map.dim() not in (2, 3):
        raise ValueError("value_map must be float32 [H, W] or [M, H, W]")
    if cells.dtype != torch.int32 or cells.dim() != 4 or \
            tuple(cells.shape[1:3]) != (4, 3):
        raise ValueError("cells must be int32 [Q, 4, 3, NB]")
    q, nb = cells.shape[0], cells.shape[3]
    if mask.dtype != torch.bool or tuple(mask.shape) != (q, nb):
        raise ValueError("mask must be bool [Q, NB]")
    if table.dtype != torch.float32 or table.dim() != 1:
        raise ValueError("table must be float32 [C]")
    if (value_map.dim() == 3) != (map_idx is not None):
        raise ValueError("a stacked [M, H, W] map needs map_idx, and "
                         "map_idx needs a stacked map")
    if map_idx is not None and (map_idx.dtype != torch.int32 or
                                tuple(map_idx.shape) != (q,)):
        raise ValueError("map_idx must be int32 [Q]")
    tensors = [value_map, cells, mask, table] + \
        ([] if map_idx is None else [map_idx])
    if len({t.device for t in tensors}) != 1:
        raise ValueError("all inputs must be on one device")


def greedy_cost_core_plain(value_map, cells, mask, table, kernel_size: int,
                           occupancy_threshold: float, map_idx=None
                           ) -> torch.Tensor:
    """Plain PyTorch version of the core: f32[Q, 7] sums of the per-pose
    class values over the masked beams (``mask`` bool[Q, NB]).

    Reads are deduplicated as ``cost.py:141-196`` of the JAX package (an
    extended (2k+3)^2 patch serves the five axis poses). The sum is formed
    from exact per-class beam counts, ``sum_c count_c * table[c]`` in class
    order, so it equals the kernel's bit for bit."""
    _check_core(value_map, cells, mask, table, map_idx)
    k = kernel_size
    thr = occupancy_threshold
    dev = cells.device
    maps = value_map if value_map.dim() == 3 else value_map[None]
    _, h, w = maps.shape
    flat = maps.reshape(-1)
    q = cells.shape[0]
    base = torch.zeros((q, 1, 1, 1), dtype=torch.int64, device=dev)
    if map_idx is not None:
        base = (map_idx.long() * (h * w)).reshape(q, 1, 1, 1)
    none = 2 * (k + 1) ** 2

    def patch(ix, iy, r):
        """Values [Q, NB, 2r+1, 2r+1] around cells [Q, NB] (row = y)."""
        offs = torch.arange(-r, r + 1, device=dev)
        x = ix.long()[..., None, None] + offs[None, :]
        y = iy.long()[..., None, None] + offs[:, None]
        ok = (x >= 0) & (x < w) & (y >= 0) & (y < h)
        idx = base + y.clamp(0, h - 1) * w + x.clamp(0, w - 1)
        vals = flat[idx]
        return torch.where(ok, vals, torch.zeros_like(vals))

    def usable(a, r):
        hv = patch(cells[:, 0, a], cells[:, 1, a], r)
        mv = patch(cells[:, 2, a], cells[:, 3, a], r)
        return (hv != gridops.UNKNOWN) & (mv != gridops.UNKNOWN) & \
            (hv >= thr) & (mv <= thr)

    offs = torch.arange(-k, k + 1, device=dev)
    cls = (offs[None, :] ** 2 + offs[:, None] ** 2)            # [K, K]
    kk = 2 * k + 1

    def min_class(u):
        c = torch.where(u, cls.expand_as(u), torch.full_like(u, none,
                                                             dtype=cls.dtype))
        return c.amin(dim=(-2, -1))                              # [Q, NB]

    usable_ext = usable(0, k + 1)
    cmin = [None] * 7
    for p, (sx, sy) in _AXIS_POSES.items():
        cmin[p] = min_class(
            usable_ext[..., sy + 1:sy + 1 + kk, sx + 1:sx + 1 + kk])
    for p, a in _THETA_POSES.items():
        cmin[p] = min_class(usable(a, k))
    cmin = torch.stack(cmin, dim=1)                             # [Q, 7, NB]
    counts = torch.zeros((q, 7, none + 1), dtype=torch.int64, device=dev)
    counts.scatter_add_(2, cmin, mask[:, None, :].expand_as(cmin).long())
    acc = torch.zeros((q, 7), dtype=torch.float32, device=dev)
    for c in range(none + 1):
        acc = acc + counts[..., c].to(torch.float32) * table[c]
    return acc


def greedy_cost_core(value_map, cells, mask, table, kernel_size: int,
                     occupancy_threshold: float, map_idx=None
                     ) -> torch.Tensor:
    """Per-pose sums f32[Q, 7] over the beams of ``mask`` (bool[Q, NB]) of
    the class values in ``table``. CPU tensors take
    :func:`greedy_cost_core_plain`; CUDA tensors launch the kernel in
    ``csrc/greedy_cost.cu`` (and raise if it cannot be built or
    launched)."""
    if cells.device.type == "cpu":
        return greedy_cost_core_plain(value_map, cells, mask, table,
                                      kernel_size, occupancy_threshold,
                                      map_idx)
    _check_core(value_map, cells, mask, table, map_idx)
    if cells.device.type != "cuda":
        raise ValueError(f"unsupported device {cells.device}")
    if table.shape[0] != 2 * (kernel_size + 1) ** 2 + 1:
        raise ValueError("table does not match kernel_size")
    value_map, cells, mask, table = (t.contiguous() for t in
                                     (value_map, cells, mask, table))
    if map_idx is not None:
        map_idx = map_idx.contiguous()
    q, nb = cells.shape[0], cells.shape[3]
    h, w = value_map.shape[-2:]
    if q > 65535:
        raise ValueError("Q must be at most 65535")
    raw = cells.new_empty((q, 7), dtype=torch.float32)
    if q == 0:
        return raw
    stream = loader.stream_handle(cells)
    # A ticket, then the [Q, 7, C] class counts.
    scratch = loader.zeroed_scratch("greedy_cost", cells.device, stream,
                                    1 + q * 7 * table.shape[0])
    lib = _lib()
    status = lib.greedy_cost_f32(
        value_map.data_ptr(), h, w, cells.data_ptr(), mask.data_ptr(),
        None if map_idx is None else map_idx.data_ptr(), table.data_ptr(),
        q, nb, kernel_size, occupancy_threshold, scratch.data_ptr(),
        raw.data_ptr(), stream)
    loader.check(status, "greedy_cost")
    greedy_cost_core.launches += 1
    return raw


greedy_cost_core.launches = 0

def _lib():
    lib = loader.library("greedy_cost")
    fn = lib.greedy_cost_f32
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.restype = ctypes.c_int
        fn.argtypes = [p, i, i, p, p, p, p, i, i, i, ctypes.c_float, p, p,
                       p]
    return lib


def _epilogue(raw, resolution: float, scaling_factor: float):
    costs = -raw * scaling_factor                               # [Q, 7]
    dev = raw.device
    steps = torch.stack([gridops.scalar(resolution, dev),
                         gridops.scalar(resolution, dev),
                         gridops.scalar(DIFF_ANG, dev)])
    grad = 0.5 * (costs[:, 1:4] - costs[:, 4:7]) / steps
    cov = grad[:, :, None] * grad[:, None, :] + \
        0.01 * torch.eye(3, dtype=torch.float32, device=dev)
    return costs[:, 0], cov


def _cost_cov(core, value_map, origin, sensor_poses, ranges, angles,
              beam_mask, resolution, hit_and_missed_dist,
              occupancy_threshold, kernel_size, standard_deviation,
              scaling_factor, map_idx):
    cells = prepare_cells(origin, sensor_poses, ranges, angles, resolution,
                          hit_and_missed_dist)
    table = class_table(resolution, kernel_size, standard_deviation,
                        cells.device)
    raw = core(value_map, cells, beam_mask != 0, table,
               kernel_size, occupancy_threshold, map_idx)
    return _epilogue(raw, resolution, scaling_factor)


def greedy_cost_cov(value_map, origin, sensor_poses, ranges, angles,
                    beam_mask, resolution: float,
                    hit_and_missed_dist: float = 0.075,
                    occupancy_threshold: float = 0.1, kernel_size: int = 1,
                    standard_deviation: float = 1.0,
                    scaling_factor: float = 0.05, map_idx=None):
    """Batched cost + covariance at sensor poses f32[Q, 3].

    ``value_map`` f32[H, W] (or [M, H, W] with ``map_idx`` i32[Q]);
    ``origin`` f32[2] or f32[Q, 2]; ``ranges``/``angles`` f32[Q, NB];
    ``beam_mask`` [Q, NB], boolean (any non-zero entry counts as 1).
    Returns ``(cost f32[Q], cov f32[Q, 3, 3])``.
    """
    return _cost_cov(greedy_cost_core, value_map, origin, sensor_poses,
                     ranges, angles, beam_mask, resolution,
                     hit_and_missed_dist, occupancy_threshold, kernel_size,
                     standard_deviation, scaling_factor, map_idx)


def greedy_cost_cov_plain(value_map, origin, sensor_poses, ranges, angles,
                          beam_mask, resolution: float,
                          hit_and_missed_dist: float = 0.075,
                          occupancy_threshold: float = 0.1,
                          kernel_size: int = 1,
                          standard_deviation: float = 1.0,
                          scaling_factor: float = 0.05, map_idx=None):
    """:func:`greedy_cost_cov` with the plain core on any device."""
    return _cost_cov(greedy_cost_core_plain, value_map, origin, sensor_poses,
                     ranges, angles, beam_mask, resolution,
                     hit_and_missed_dist, occupancy_threshold, kernel_size,
                     standard_deviation, scaling_factor, map_idx)
