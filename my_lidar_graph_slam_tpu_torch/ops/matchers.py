"""Scan-matcher result type and shared helpers.

Counterpart of ``my_lidar_graph_slam_tpu/ops/matchers.py:51-118``
(``MatchSummary``, ``search_step_theta``, ``static_max_theta_window``,
``_range_gate``). The matchers themselves live in ``matchers_sweep.py``;
the pruned, grid-search, branch-and-bound, hill-climbing and linear-solver
matchers are not ported yet.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class MatchSummary(NamedTuple):
    """Mirror of ScanMatchingSummary (scan_matcher.hpp:47-77): the
    estimated pose is the ROBOT pose in the world frame, the covariance is
    world-frame. Fields carry a leading query axis."""

    pose_found: torch.Tensor        # bool[Q]
    normalized_cost: torch.Tensor   # f32[Q]
    normalized_score: torch.Tensor  # f32[Q] best score / total beams
    initial_pose: torch.Tensor      # f32[Q, 3] robot pose
    estimated_pose: torch.Tensor    # f32[Q, 3] robot pose
    covariance: torch.Tensor        # f32[Q, 3, 3] world frame


def search_step_theta(resolution: torch.Tensor, max_range: torch.Tensor
                      ) -> torch.Tensor:
    """Angular step from the cosine law: acos(1 - res^2 / (2 r^2))
    (scan_matcher_real_time_correlative.cpp:156-175), in float32 with the
    JAX package's operation order: near 1 the argument's last bit moves
    the whole theta lattice."""
    t = resolution / max_range
    return torch.arccos(1.0 - 0.5 * t * t)


def static_max_theta_window(resolution: float, scan_range_max: float,
                            range_theta: float) -> int:
    """Static upper bound for the theta half-window: the step is smallest
    when the scan's max range equals ``scan_range_max``."""
    t = resolution / scan_range_max
    step = math.acos(1.0 - 0.5 * t * t)
    return int(math.ceil(0.5 * range_theta / step))


def range_gate(valid, ranges, usable_range_min, usable_range_max,
               scan_min_range, scan_max_range):
    """Combined usable-range/scan-range beam gate
    (score_function_pixel_accurate.cpp:27-41)."""
    min_r = torch.clamp(scan_min_range, min=usable_range_min)
    max_r = torch.clamp(scan_max_range, max=usable_range_max)
    return valid & (ranges > min_r) & (ranges < max_r)
