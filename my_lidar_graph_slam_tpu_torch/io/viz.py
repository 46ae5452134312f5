"""Pose-graph visualization into a NumPy raster.

Counterpart of ``my_lidar_graph_slam_tpu/io/viz.py``, the headless
equivalent of the reference's gnuplot live view (gnuplot_helper.cpp:
10-70): odometry edges black, loop-closing edges blue, nodes red, on a
white square canvas with equal axis scales, written by the port's PNG
encoder (``io/png.py``). The JAX package draws with matplotlib, which the
port does not depend on, so the two images are not pixel-equal: here
segments are rasterised with the Bresenham rule (each step along the
longer axis moves the shorter one by the rounded slope, ties toward the
start), nodes are 3 x 3 dots, and there are no axes and no title text.
"""

from __future__ import annotations

import numpy as np

from my_lidar_graph_slam_tpu_torch.io import png
from my_lidar_graph_slam_tpu_torch.models.pose_graph import PoseGraph

SIZE = 800
MARGIN = 20
BLACK = (0, 0, 0)
BLUE = (0, 0, 255)
RED = (255, 0, 0)


def segment_pixels(x0: int, y0: int, x1: int, y1: int):
    """Integer pixels of the segment (x0, y0) -> (x1, y1), both ends
    included, by the Bresenham rule: ``n = max(|dx|, |dy|)`` steps, the
    minor coordinate at step k is ``floor((2 k |d| + n - 1) / 2n)`` away
    from the start."""
    dx, dy = x1 - x0, y1 - y0
    n = max(abs(dx), abs(dy))
    k = np.arange(n + 1)
    if n == 0:
        return np.array([x0]), np.array([y0])

    def minor(d):
        return np.sign(d) * ((2 * k * abs(d) + n - 1) // (2 * n))

    return x0 + minor(dx), y0 + minor(dy)


def render_pose_graph(graph: PoseGraph, size: int = SIZE) -> np.ndarray:
    """uint8 [size, size, 3] image of the graph (row 0 = largest y)."""
    img = np.full((size, size, 3), 255, np.uint8)
    poses = graph.node_poses()
    if len(poses) == 0:
        return img
    lo = poses[:, :2].min(axis=0)
    span = max(float((poses[:, :2].max(axis=0) - lo).max()), 1e-9)
    scale = (size - 1 - 2 * MARGIN) / span
    px = np.round(MARGIN + (poses[:, 0] - lo[0]) * scale).astype(int)
    py = np.round(size - 1 - MARGIN - (poses[:, 1] - lo[1]) * scale
                  ).astype(int)

    # Odometry edges first, loop edges on top of them.
    for odom in (True, False):
        for e in range(graph.num_edges):
            if bool(graph.edge_is_odom[e]) != odom:
                continue
            i, j = int(graph.edge_i[e]), int(graph.edge_j[e])
            xs, ys = segment_pixels(px[i], py[i], px[j], py[j])
            img[ys, xs] = BLACK if odom else BLUE
    for x, y in zip(px, py):
        img[max(0, y - 1):y + 2, max(0, x - 1):x + 2] = RED
    return img


def draw_pose_graph(graph: PoseGraph, path: str):
    """Write the pose-graph PNG to ``path`` (gnuplot_helper.cpp:22-70
    colors)."""
    png.write_png(path, render_pose_graph(graph))
