"""Pixel-accurate scan-vs-map scoring of candidate poses.

Counterpart of ``my_lidar_graph_slam_tpu/ops/scoring.py:32-68``: every
(candidate pose, beam) pair is scored as one gather and reduce instead of
the reference's per-beam scalar loops
(score_function_pixel_accurate.cpp:37-59). The grid-search and
branch-and-bound matchers score with :func:`score_poses`; the window sweep
of the correlative matcher has its own kernel (``ops/cuda/correlate.py``,
the counterpart of ``window_scores``).

Score semantics (score_function_pixel_accurate.cpp:19-76): the score adds
the occupancy value at each hit cell; unknown and out-of-bounds cells
contribute 0 (the Unknown sentinel).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from my_lidar_graph_slam_tpu_torch.ops import grid as gridops


class ScoreSummary(NamedTuple):
    """Mirror of ScoreFunction::Summary (score_function.hpp:29-37)."""

    score: torch.Tensor             # [...] sum of occupancy values
    normalized_score: torch.Tensor  # [...] score / num_total_beams
    match_rate: torch.Tensor        # [...] known cells / num_total_beams


def hit_cells(grid: gridops.GridMap, sensor_poses, ranges, angles):
    """Cell indices of beam endpoints for candidate sensor poses.

    ``sensor_poses``: f32[..., 3]; ``ranges``/``angles``: f32[..., NB],
    broadcastable against ``sensor_poses[..., :1]``. Returns int32
    ``(ix, iy)`` of the broadcast shape [..., NB].
    """
    world_angle = sensor_poses[..., 2:3] + angles
    hx = sensor_poses[..., 0:1] + ranges * torch.cos(world_angle)
    hy = sensor_poses[..., 1:2] + ranges * torch.sin(world_angle)
    return gridops.world_to_cell(grid, torch.stack([hx, hy], dim=-1))


def score_poses(value_map, grid: gridops.GridMap, sensor_poses, ranges,
                angles, beam_mask, num_total_beams) -> ScoreSummary:
    """Pixel-accurate score for candidate poses ``[..., 3]`` on the 2-D
    ``value_map`` f32[H, W].

    ``beam_mask``: bool[..., NB] beams inside the usable range gate.
    ``num_total_beams``: normalization divisor (a number, or a tensor that
    broadcasts against the result) — the reference normalizes by the TOTAL
    beam count, not the valid count (score_function_pixel_accurate.cpp:
    62-63).
    """
    ix, iy = hit_cells(grid, sensor_poses, ranges, angles)
    vals = gridops.lookup(value_map, ix, iy) * beam_mask     # [..., NB]
    score = vals.sum(dim=-1)
    known = ((vals != gridops.UNKNOWN) & beam_mask).sum(dim=-1)
    denom = num_total_beams if torch.is_tensor(num_total_beams) else \
        gridops.scalar(float(num_total_beams), score.device)
    return ScoreSummary(score, score / denom,
                        known.to(torch.float32) / denom)
