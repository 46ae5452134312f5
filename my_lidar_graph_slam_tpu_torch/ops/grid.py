"""Occupancy grid map as a fixed-size dense log-odds tensor.

Counterpart of ``my_lidar_graph_slam_tpu/ops/grid.py`` (binary-Bayes maps
only; the counting-cell maps are not ported yet). The map is a dense
``f32[H, W]`` log-odds field plus an ``observed`` mask and a world-frame
origin, replacing the reference's patch-paged ``GridMap``
(grid_map.hpp:22-1019). Out-of-bounds reads return the Unknown sentinel 0,
like unallocated patches (grid_map_patch.hpp:181).

Cell indexing is ``[iy, ix]`` (row = y), with ``origin`` at the bottom-left
corner of cell ``(0, 0)`` (grid_map.hpp:779-790).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from my_lidar_graph_slam_tpu_torch.utils import device as device_mod

# logit(1 - 1e-3): the clamp bound from binary_bayes_grid_cell.hpp:50-52.
PROB_MIN = 1e-3
LOG_ODDS_MAX = float(np.log((1.0 - PROB_MIN) / PROB_MIN))
UNKNOWN = 0.0  # Unknown occupancy sentinel (grid_cell.hpp:33).


class GridMap(NamedTuple):
    """Dense occupancy submap.

    ``log_odds``: f32[H, W] accumulated log-odds (0 where unobserved).
    ``observed``: bool[H, W] whether the cell was ever updated.
    ``origin``:   f32[2] world (x, y) of the bottom-left corner of cell (0,0),
    on the map's device.
    ``resolution``: cell size in meters (rounded to float32 where used).
    """

    log_odds: torch.Tensor
    observed: torch.Tensor
    origin: torch.Tensor
    resolution: float

    @property
    def shape(self):
        return tuple(self.log_odds.shape)

    @property
    def device(self) -> torch.device:
        return self.log_odds.device


def origin_for(center, height: int, width: int,
               resolution: float) -> np.ndarray:
    """Float32 world origin of a map centered on ``center`` (host copy)."""
    center = np.asarray(center, np.float32)
    return center - 0.5 * resolution * np.array([width, height], np.float32)


def empty(height: int, width: int, resolution: float, center=None,
          device=None) -> GridMap:
    """Create an empty map centered on ``center`` (world frame), on
    ``device`` (``None`` means ``cuda``, see ``utils/device.py``)."""
    device = device_mod.resolve(device)
    if center is None:
        center = np.zeros((2,), np.float32)
    origin = origin_for(center, height, width, resolution)
    return GridMap(
        log_odds=torch.zeros((height, width), dtype=torch.float32,
                             device=device),
        observed=torch.zeros((height, width), dtype=torch.bool,
                             device=device),
        origin=torch.as_tensor(origin, dtype=torch.float32, device=device),
        resolution=float(resolution),
    )


def values(grid: GridMap) -> torch.Tensor:
    """Occupancy probabilities with Unknown=0 sentinel (grid_map.hpp:806)."""
    prob = torch.clamp(1.0 / (1.0 + torch.exp(-grid.log_odds)),
                       PROB_MIN, 1.0 - PROB_MIN)
    return torch.where(grid.observed, prob, torch.zeros_like(prob))


def logit(p: torch.Tensor) -> torch.Tensor:
    return torch.log(p) - torch.log1p(-p)


def world_to_cell(grid: GridMap, points: torch.Tensor):
    """World (x, y) -> integer cell (ix, iy) (grid_map.hpp:779-790).

    ``points``: f32[..., 2]. Returns int32 ``(ix, iy)`` tensors.
    """
    res = scalar(grid.resolution, points.device)
    idx = torch.floor((points - grid.origin) / res).to(torch.int32)
    return idx[..., 0], idx[..., 1]


def scalar(value: float, device) -> torch.Tensor:
    """0-d float32 tensor on ``device``. Dividing by it is a true division
    everywhere; dividing a CUDA tensor by a Python float multiplies by the
    reciprocal instead, which can move a floor across a cell boundary."""
    return torch.full((), value, dtype=torch.float32, device=device)


def in_bounds(grid: GridMap, ix, iy):
    h, w = grid.shape
    return (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)


def lookup(value_map: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor,
           default: float = UNKNOWN) -> torch.Tensor:
    """Masked map read: out-of-bounds returns ``default``
    (``GridMap::Value(idx, defaultVal)``,
    score_function_pixel_accurate.cpp:49)."""
    if value_map.dim() != 2:
        raise ValueError("lookup expects a single 2-D map")
    h, w = value_map.shape
    ok = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    flat = iy.clamp(0, h - 1).long() * w + ix.clamp(0, w - 1).long()
    vals = value_map.reshape(-1)[flat]
    return torch.where(ok, vals, torch.full_like(vals, default))
