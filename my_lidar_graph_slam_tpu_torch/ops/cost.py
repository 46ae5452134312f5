"""Match cost functions and Laplace-approximation covariances.

Counterpart of ``my_lidar_graph_slam_tpu/ops/cost.py:38-92,236-346``:

 * Greedy endpoint (cost_function_greedy_endpoint.cpp:32-171), unfused:
   :func:`greedy_endpoint_cost` evaluates any batch of poses (hill climbing
   calls it at six). The fused cost + 7-pose covariance of the JAX package
   (``greedy_endpoint_cost_and_covariance_fused``) is
   ``ops/cuda/greedy_cost.py::greedy_cost_cov``, the K2 kernel on the card
   and its plain version on the CPU, and is not repeated here.
 * Square error on a bicubic-smoothed map (cost_function_square_error.cpp:
   21-58, 276-346), with the reference's finite-difference map gradient
   (ComputeMapGradient, :172-229).

Covariances follow the reference: outer product of the cost gradient plus
a 0.01 diagonal ridge (cost_function_square_error.cpp:112-135). Every
function broadcasts over leading pose axes: ``ranges``, ``angles`` and the
beam mask are [..., NB] and broadcast against ``sensor_poses[..., :1]``.
"""

from __future__ import annotations

import torch

from my_lidar_graph_slam_tpu_torch.ops import grid as gridops


def greedy_endpoint_cost(value_map, grid: gridops.GridMap, sensor_poses,
                         ranges, angles, beam_mask,
                         hit_and_missed_dist=0.075,
                         occupancy_threshold=0.1,
                         kernel_size: int = 1,
                         standard_deviation=1.0,
                         scaling_factor=0.05):
    """Greedy-endpoint cost for sensor poses ``[..., 3]`` -> ``[...]``.

    ``beam_mask``: [..., NB], the usable-range gate
    (cost_function_greedy_endpoint.cpp:46-50).
    """
    variance = standard_deviation * standard_deviation
    res = grid.resolution
    dev = sensor_poses.device

    world_angle = sensor_poses[..., 2:3] + angles
    cos_t = torch.cos(world_angle)
    sin_t = torch.sin(world_angle)
    hx = sensor_poses[..., 0:1] + ranges * cos_t
    hy = sensor_poses[..., 1:2] + ranges * sin_t
    mx = sensor_poses[..., 0:1] + (ranges - hit_and_missed_dist) * cos_t
    my = sensor_poses[..., 1:2] + (ranges - hit_and_missed_dist) * sin_t

    hix, hiy = gridops.world_to_cell(grid, torch.stack([hx, hy], -1))
    mix, miy = gridops.world_to_cell(grid, torch.stack([mx, my], -1))

    k = kernel_size
    offs = torch.arange(-k, k + 1, device=dev)
    kx = offs[None, :]
    ky = offs[:, None]                                       # [K, K]

    def kernel_vals(ix, iy):
        # [..., NB] -> [..., NB, K, K]
        return gridops.lookup(value_map, ix[..., None, None] + kx,
                              iy[..., None, None] + ky)

    hit_vals = kernel_vals(hix, hiy)
    miss_vals = kernel_vals(mix, miy)

    known = (hit_vals != gridops.UNKNOWN) & (miss_vals != gridops.UNKNOWN)
    crossing = (hit_vals >= occupancy_threshold) & \
        (miss_vals <= occupancy_threshold)
    usable = known & crossing

    # Squared distance hitPointIdx -> kernel cell, in meters
    # (grid_map.hpp:895-902).
    d2 = (kx.to(torch.float32) ** 2 + ky.to(torch.float32) ** 2) * res * res
    d2_default = 2.0 * ((k + 1) * res) ** 2
    d2 = torch.where(usable, d2.expand(usable.shape),
                     torch.full_like(hit_vals, d2_default))
    min_d2 = d2.amin(dim=(-2, -1))                           # [..., NB]

    per_beam = -torch.exp(-0.5 * min_d2 / variance) * beam_mask
    return per_beam.sum(dim=-1) * scaling_factor


def _bicubic_kernel(t):
    """The reference's interpolation kernel h(t)
    (cost_function_square_error.cpp:281-295)."""
    at = torch.abs(t)
    near = at ** 3 - 2.0 * at ** 2 + 1.0
    far = -at ** 3 + 5.0 * at ** 2 - 8.0 * at + 4.0
    return torch.where(at <= 1.0, near,
                       torch.where(at <= 2.0, far, torch.zeros_like(at)))


def smoothed_value(value_map, fx, fy):
    """Bicubic-interpolated map value at fractional cell indices ``[...]``.

    Mirrors ComputeSmoothedValue (cost_function_square_error.cpp:276-346):
    sample the 4x4 integer neighborhood (floor-1 .. floor+2), clamp indices
    to the map edge (out-of-bounds reads repeat the border cell), unknown
    reads 0, result clamped to [0, 1].
    """
    h, w = value_map.shape
    floor_x = torch.floor(fx)
    floor_y = torch.floor(fy)
    tx = fx - floor_x
    ty = fy - floor_y

    # Kernel weights at distances (1+t, t, 1-t, 2-t).
    def weights(t):
        return torch.stack([
            _bicubic_kernel(1.0 + t),
            _bicubic_kernel(t),
            _bicubic_kernel(1.0 - t),
            _bicubic_kernel(2.0 - t),
        ], dim=-1)                                           # [..., 4]

    wx = weights(tx)
    wy = weights(ty)

    offs = torch.arange(-1, 3, device=fx.device)
    sample_x = (floor_x.to(torch.int64)[..., None] + offs).clamp(0, w - 1)
    sample_y = (floor_y.to(torch.int64)[..., None] + offs).clamp(0, h - 1)
    # [..., 4(x), 4(y)]
    vals = value_map.reshape(-1)[sample_y[..., None, :] * w +
                                 sample_x[..., :, None]]
    out = (wx[..., :, None] * vals * wy[..., None, :]).sum(dim=(-2, -1))
    return out.clamp(0.0, 1.0)


def square_error_cost(value_map, grid: gridops.GridMap, sensor_poses,
                      ranges, angles, beam_mask):
    """Sum of (1 - smoothed(hit))^2 (cost_function_square_error.cpp:21-58)."""
    world_angle = sensor_poses[..., 2:3] + angles
    hx = sensor_poses[..., 0:1] + ranges * torch.cos(world_angle)
    hy = sensor_poses[..., 1:2] + ranges * torch.sin(world_angle)
    fx, fy = gridops.world_to_cell_float(grid, torch.stack([hx, hy], -1))
    sm = smoothed_value(value_map, fx, fy)
    err = (1.0 - sm) ** 2 * beam_mask
    return err.sum(dim=-1)


def map_gradient(value_map, grid: gridops.GridMap, points):
    """Finite-difference gradient of the smoothed map wrt world position.

    Mirrors ComputeMapGradient (cost_function_square_error.cpp:172-199):
    central differences of half-step 0.05 cell on the fractional index.
    ``points``: f32[..., 2]. Returns f32[..., 2] (d/dx, d/dy).
    """
    delta_idx = 0.1
    fx, fy = gridops.world_to_cell_float(grid, points)
    half = delta_idx / 2.0
    gx = (smoothed_value(value_map, fx + half, fy)
          - smoothed_value(value_map, fx - half, fy))
    gy = (smoothed_value(value_map, fx, fy + half)
          - smoothed_value(value_map, fx, fy - half))
    delta_dist = grid.resolution * delta_idx
    return torch.stack([gx, gy], dim=-1) / delta_dist


def square_error_gradient(value_map, grid, sensor_pose, ranges, angles,
                          beam_mask):
    """Cost gradient wrt the sensor pose ``[..., 3]`` -> ``[..., 3]``
    (cost_function_square_error.cpp:61-108)."""
    world_angle = sensor_pose[..., 2:3] + angles
    cos_t = torch.cos(world_angle)
    sin_t = torch.sin(world_angle)
    hx = sensor_pose[..., 0:1] + ranges * cos_t
    hy = sensor_pose[..., 1:2] + ranges * sin_t
    pts = torch.stack([hx, hy], dim=-1)

    fx, fy = gridops.world_to_cell_float(grid, pts)
    sm = smoothed_value(value_map, fx, fy)
    err = (1.0 - sm) * beam_mask

    g = map_gradient(value_map, grid, pts)                   # [..., NB, 2]
    # Chain rule through the hit point (cost_function_square_error.cpp:
    # 203-229).
    g_theta = -ranges * sin_t * g[..., 0] + ranges * cos_t * g[..., 1]
    return torch.stack([
        (2.0 * err * -g[..., 0]).sum(-1),
        (2.0 * err * -g[..., 1]).sum(-1),
        (2.0 * err * -g_theta).sum(-1),
    ], dim=-1)


def square_error_covariance(value_map, grid, sensor_pose, ranges, angles,
                            beam_mask):
    """grad grad^T + 0.01 I per pose, ``[..., 3, 3]``
    (cost_function_square_error.cpp:112-135)."""
    grad = square_error_gradient(
        value_map, grid, sensor_pose, ranges, angles, beam_mask)
    eye = torch.eye(3, dtype=grad.dtype, device=grad.device)
    return grad[..., :, None] * grad[..., None, :] + 0.01 * eye
