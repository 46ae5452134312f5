"""Coarse map pyramids via windowed max.

Counterpart of ``my_lidar_graph_slam_tpu/ops/pyramid.py``: each pyramid
level ``h`` stores, at full resolution, the max of the ``2^h x 2^h`` block
of cells *beginning* at each cell (forward-looking window), with the
Unknown=0 sentinel taking part as the value 0 and zero padding past the
far edges — the semantics of ``PrecomputeGridMap``
(grid_map_builder.cpp:403-536, util.hpp:199-253).

:func:`windowed_max` is ``max_pool2d`` with stride 1 on a map zero-padded
at its far edges; :func:`build_pyramid` doubles the window per level with
two shifted maxima, as the JAX package does. Max is exact, so both equal
the JAX package's levels bit for bit. The branch-and-bound matchers read
them: the frontend's, and the mesh loop detector's through
``GridMapBuilder.pyramid_for``; so does the launcher's
``--save-pyramid-maps``.
"""

from __future__ import annotations

import torch


def windowed_max(value_map: torch.Tensor, window: int) -> torch.Tensor:
    """Forward-looking ``window x window`` max at every cell (stride 1) of
    an f32[H, W] map; cells within ``window - 1`` of the far edges see
    zero padding (util.hpp:204-252)."""
    if window == 1:
        return value_map
    padded = torch.nn.functional.pad(value_map[None, None],
                                     (0, window - 1, 0, window - 1))
    return torch.nn.functional.max_pool2d(padded, window, stride=1)[0, 0]


def build_pyramid(value_map: torch.Tensor, height_max: int) -> torch.Tensor:
    """f32[height_max + 1, H, W]: level h is the windowed max of ``2^h``
    (``PrecomputeGridMaps``, grid_map_builder.cpp:471-495), each level from
    the previous one by a 2 x 2 max of cells ``2^(h-1)`` apart."""
    levels = [value_map]
    cur = value_map
    for h in range(1, height_max + 1):
        off = 1 << (h - 1)
        shifted_x = torch.nn.functional.pad(cur, (0, off))[:, off:]
        row = torch.maximum(cur, shifted_x)
        shifted_y = torch.nn.functional.pad(row, (0, 0, 0, off))[off:, :]
        cur = torch.maximum(row, shifted_y)
        levels.append(cur)
    return torch.stack(levels, dim=0)
