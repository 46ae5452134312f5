"""Frontend scan-matcher strategy wrappers.

Counterpart of ``my_lidar_graph_slam_tpu/models/scan_matchers.py:34-62,
104-582``: :class:`CorrelativeMatcher` (ScanMatcherRealTimeCorrelative
config, launcher_settings_default.json:42-50) on the exhaustive sweep path
(``ops/matchers_sweep.py``) or the pruned bound-and-refine path
(``ops/matchers.py``), and the BranchBound, GridSearch, HillClimbing and
LinearSolver strategies over ``ops/matchers.py``. Every strategy matches
through one pair of calls: ``match_async`` launches the match and starts
ONE host copy of a packed [1, 16] result without waiting, and
``resolve_async`` waits for it; the blocking frontend resolves at once.
The two are the ``frontend.match`` and ``frontend.resolve`` spans, and
every upload and wait in them goes through ``utils/device.py``'s helpers.

Default greedy-endpoint parameters replicate the launcher's *effective*
configuration, including the swapped (scale, sigma) constructor arguments
(slam_launcher.cpp:70-72).

Frontend score threshold: the reference passes the smallest POSITIVE
double as the normalized threshold (scan_matcher_real_time_correlative
.cpp:40-46) and asserts pose_found (lidar_graph_slam_frontend.cpp:109-110);
scores are sums of non-negative occupancies, so the equivalent is threshold
0.0 with strict ``>``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from my_lidar_graph_slam_tpu_torch.ops import grid as gridops
from my_lidar_graph_slam_tpu_torch.ops import matchers, matchers_sweep
from my_lidar_graph_slam_tpu_torch.ops import pyramid as pyrops
from my_lidar_graph_slam_tpu_torch.utils import device as device_mod
from my_lidar_graph_slam_tpu_torch.utils.metrics import MetricManager

DEFAULT_GREEDY_PARAMS = (
    ("hit_and_missed_dist", 0.075),
    ("occupancy_threshold", 0.1),
    ("kernel_size", 1),
    ("standard_deviation", 1.0),
    ("scaling_factor", 0.05),
)


def unpack_summary(packed: np.ndarray, initial_poses) -> matchers.MatchSummary:
    """Host MatchSummary (NumPy fields) from a packed [Q, 16] array."""
    return matchers.MatchSummary(
        pose_found=packed[:, 14] > 0.5,
        normalized_cost=packed[:, 13],
        normalized_score=packed[:, 12],
        initial_pose=np.asarray(initial_poses, np.float32),
        estimated_pose=packed[:, 0:3],
        covariance=packed[:, 3:12].reshape(-1, 3, 3),
        frontier_overflow=packed[:, 15].astype(np.int64),
    )


class PendingMatch(NamedTuple):
    """A match started by ``match_async``: its packed [1, 16] result in a
    host buffer that belongs to this match alone, the CUDA event after
    the copy into it (``None`` on the CPU, where the copy is done), and,
    for the pruned correlative path, the call that re-runs the match
    through the sweep when its certificate fails."""

    host: torch.Tensor
    event: Optional[object]
    retry: Optional[Callable[[], torch.Tensor]] = None


def scan_tensors(store, scan_ids, device) -> dict:
    """The stored scans ``scan_ids`` as the matchers' keyword arguments on
    ``device``: beams up to the store's bucket ([Q, NB]) and the per-scan
    ranges, sensor offsets and total beam counts ([Q], [Q, 3])."""
    ids = np.asarray(scan_ids)
    nb = store.beam_bucket()

    def up(arr):
        return device_mod.upload(arr, device, site="scan_tensors")

    return dict(ranges=up(store.ranges[ids][:, :nb]),
                angles=up(store.angles[ids][:, :nb]),
                valid=up(store.valid[ids][:, :nb]),
                scan_min_range=up(store.min_range[ids]),
                scan_max_range=up(store.max_range[ids]),
                rel_sensor_poses=up(store.rel_sensor_pose[ids]),
                num_total_beams=up(store.raw_beams[ids].astype(np.float32)))


class AsyncMatcher:
    """``match_async``/``resolve_async`` over a strategy's
    ``_match_packed(grid, store, scan_ids, poses)``, which returns the
    packed f32[Q, 16] device result of matching stored scans at ``poses``
    f32[Q, 3] against ``grid``. Each resolved match adds one to
    ``FrontendMatches``, and one to ``FrontendFrontierOverflowMatches``
    where its packed column 15 (branch-and-bound's frontier overflow) is
    above 0."""

    def match_async(self, grid: gridops.GridMap, store, scan_id: int,
                    initial_pose) -> PendingMatch:
        """Start a single-query match without waiting for it.

        The match is launched on the current stream, behind whatever is
        already queued there (the previous keyframe's map update), and its
        packed [1, 16] result is copied into a page-locked host buffer of
        its own with ``non_blocking=True``, followed by a CUDA event.
        :meth:`resolve_async` waits on that event. On the CPU the copy is
        a plain one."""
        with MetricManager.span("frontend.match"):
            return self._start(grid, store, scan_id, initial_pose)

    def resolve_async(self, pending: PendingMatch,
                      initial_pose) -> matchers.MatchSummary:
        """Wait for a :meth:`match_async` result and unpack it."""
        with MetricManager.span("frontend.resolve"):
            summary = self._finish(pending, initial_pose)
        counters = MetricManager.instance().counters
        counters("FrontendMatches").increment()
        if summary.frontier_overflow > 0:
            counters("FrontendFrontierOverflowMatches").increment()
        return summary

    def _start(self, grid: gridops.GridMap, store, scan_id: int,
               initial_pose) -> PendingMatch:
        packed = self._match_packed(
            grid, store, [scan_id],
            np.asarray(initial_pose, np.float32)[None, :])
        if packed.device.type != "cuda":
            return PendingMatch(packed.clone(), None)
        host = torch.empty(packed.shape, dtype=packed.dtype,
                           pin_memory=True)
        host.copy_(packed, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(packed.device))
        return PendingMatch(host, event)

    def _finish(self, pending: PendingMatch,
                initial_pose) -> matchers.MatchSummary:
        device_mod.sync(pending.event, site="resolve_async")
        out = unpack_summary(pending.host.numpy(),
                             np.asarray(initial_pose, np.float32)[None, :])
        return matchers.MatchSummary(*(leaf[0] for leaf in out))


def _poses(poses, device) -> torch.Tensor:
    return device_mod.upload(np.asarray(poses, np.float32), device,
                             site="poses")


# The pruned path's expansion budgets: those of the JAX package's
# single-query ``CorrelativeMatcher.match`` (scan_matchers.py:346).
PRUNED_TOP_GROUPS = 14
PRUNED_TOP_THETAS = 48


@dataclasses.dataclass
class CorrelativeMatcher(AsyncMatcher):
    """ScanMatcherRealTimeCorrelative config.

    ``use_sweep`` (the default) scores every (theta, dx, dy) candidate of
    the window with the exhaustive sweep, exact by construction. False
    takes the JAX package's ``use_mxu=False`` path: the pruned
    bound-and-refine search (``ops/matchers.py``) with its bound stack,
    whose packed result carries the exactness certificate in column 15;
    :meth:`resolve_async` re-runs a match whose certificate fails through
    the sweep (one more host read), so the result equals the sweep's
    always. ``last_exact_fraction`` is the certificate of the last
    resolved match. Each match adds one to ``FrontendMxuMatches`` (sweep)
    or ``FrontendPrunedMatches`` (pruned), and each re-run to
    ``FrontendPrunedReruns``. ``low_resolution`` is kept for config parity
    only.
    """

    low_resolution: int = 5
    range_x: float = 0.2
    range_y: float = 0.2
    range_theta: float = 0.5
    scan_range_max: float = 20.0
    usable_range_min: float = 0.01
    usable_range_max: float = 20.0
    cost_type: str = "greedy_endpoint"
    greedy_params: tuple = DEFAULT_GREEDY_PARAMS
    use_sweep: bool = True
    last_exact_fraction: float = 1.0

    def _window(self, res: float):
        win_x = int(np.ceil(0.5 * self.range_x / res))
        win_y = int(np.ceil(0.5 * self.range_y / res))
        win_t = matchers.static_max_theta_window(
            res, self.scan_range_max, self.range_theta)
        return win_x, win_y, win_t

    def _match_args(self, grid: gridops.GridMap, store, scan_ids, poses):
        scans = scan_tensors(store, scan_ids, grid.device)
        return (_poses(poses, grid.device), scans["ranges"], scans["angles"],
                scans["valid"], scans["scan_min_range"],
                scans["scan_max_range"], scans["rel_sensor_poses"],
                self.scan_range_max, self.range_theta, self.usable_range_min,
                self.usable_range_max, 0.0, scans["num_total_beams"])

    def _sweep_packed(self, grid: gridops.GridMap, store, scan_ids,
                      poses: np.ndarray) -> torch.Tensor:
        win_x, win_y, win_t = self._window(grid.resolution)
        summary = matchers_sweep.correlative_match_sweep(
            gridops.values(grid), grid,
            *self._match_args(grid, store, scan_ids, poses), win_x=win_x,
            win_y=win_y, win_theta_max=win_t, cost_type=self.cost_type,
            greedy_params=self.greedy_params, score_gate="correlative")
        MetricManager.instance().counters("FrontendMxuMatches").increment(
            len(scan_ids))
        return matchers_sweep.pack_summary(summary)

    def _pruned_packed(self, grid: gridops.GridMap, store, scan_ids,
                       poses: np.ndarray) -> torch.Tensor:
        """The pruned match, packed with the certificate in column 15
        (``_fused_pruned_match`` of the JAX package)."""
        win_x, win_y, win_t = self._window(grid.resolution)
        vals = gridops.values(grid)
        summary, exact = matchers.correlative_match_pruned_batch(
            vals, matchers.make_bound_stack(vals, win_x, win_y), grid,
            *self._match_args(grid, store, scan_ids, poses), win_x=win_x,
            win_y=win_y, win_theta_max=win_t, top_groups=PRUNED_TOP_GROUPS,
            top_thetas=PRUNED_TOP_THETAS, cost_type=self.cost_type,
            greedy_params=self.greedy_params)
        MetricManager.instance().counters("FrontendPrunedMatches").increment(
            len(scan_ids))
        packed = matchers_sweep.pack_summary(summary)
        packed[:, 15] = exact.to(torch.float32)
        return packed

    def _match_packed(self, grid: gridops.GridMap, store, scan_ids,
                      poses: np.ndarray) -> torch.Tensor:
        if self.use_sweep:
            return self._sweep_packed(grid, store, scan_ids, poses)
        return self._pruned_packed(grid, store, scan_ids, poses)

    def _start(self, grid: gridops.GridMap, store, scan_id: int,
               initial_pose) -> PendingMatch:
        pending = super()._start(grid, store, scan_id, initial_pose)
        if self.use_sweep:
            return pending
        poses = np.asarray(initial_pose, np.float32)[None, :]
        return pending._replace(retry=lambda: self._sweep_packed(
            grid, store, [scan_id], poses))

    def _finish(self, pending: PendingMatch,
                initial_pose) -> matchers.MatchSummary:
        if pending.retry is None:
            return super()._finish(pending, initial_pose)
        device_mod.sync(pending.event, site="resolve_async")
        packed = pending.host.numpy()
        exact = bool(packed[0, 15] > 0.5)
        self.last_exact_fraction = 1.0 if exact else 0.0
        if exact:
            packed = packed.copy()
            packed[:, 15] = 0.0         # the sweep's frontier overflow
        else:
            MetricManager.instance().counters(
                "FrontendPrunedReruns").increment()
            packed = device_mod.sync(pending.retry(),
                                     site="pruned_retry").numpy()
        out = unpack_summary(packed,
                             np.asarray(initial_pose, np.float32)[None, :])
        return matchers.MatchSummary(*(leaf[0] for leaf in out))


@dataclasses.dataclass
class BranchBoundMatcher(AsyncMatcher):
    """ScanMatcherBranchBound config (launcher_settings_default.json:
    132-141). As a frontend matcher it builds the pyramid on every call,
    like ScanMatcherBranchBound::OptimizePose
    (scan_matcher_branch_bound.cpp:37-39)."""

    node_height_max: int = 6
    range_x: float = 2.0
    range_y: float = 2.0
    range_theta: float = 1.0
    scan_range_max: float = 20.0
    usable_range_min: float = 0.01
    usable_range_max: float = 20.0
    frontier_cap: int = 4096
    cost_type: str = "greedy_endpoint"
    greedy_params: tuple = DEFAULT_GREEDY_PARAMS

    def _match_packed(self, grid, store, scan_ids, poses) -> torch.Tensor:
        res = grid.resolution
        pyr = pyrops.build_pyramid(gridops.values(grid),
                                   self.node_height_max)
        summary = matchers.branch_bound_match(
            pyr, grid, _poses(poses, grid.device),
            **scan_tensors(store, scan_ids, grid.device),
            scan_range_max=self.scan_range_max,
            range_theta=self.range_theta,
            usable_range_min=self.usable_range_min,
            usable_range_max=self.usable_range_max,
            normalized_score_threshold=0.0,
            node_height_max=self.node_height_max,
            win_x=int(np.ceil(0.5 * self.range_x / res)),
            win_y=int(np.ceil(0.5 * self.range_y / res)),
            win_theta_max=matchers.static_max_theta_window(
                res, self.scan_range_max, self.range_theta),
            frontier_cap=self.frontier_cap, cost_type=self.cost_type,
            greedy_params=self.greedy_params)
        return matchers_sweep.pack_summary(summary)


@dataclasses.dataclass
class GridSearchMatcher(AsyncMatcher):
    """ScanMatcherGridSearch config
    (launcher_settings_default.json:71-82)."""

    range_x: float = 2.0
    range_y: float = 2.0
    range_theta: float = 0.5
    step_x: float = 0.05
    step_y: float = 0.05
    step_theta: float = 0.005
    usable_range_min: float = 0.01
    usable_range_max: float = 20.0
    cost_type: str = "greedy_endpoint"
    greedy_params: tuple = DEFAULT_GREEDY_PARAMS

    def _match_packed(self, grid, store, scan_ids, poses) -> torch.Tensor:
        summary = matchers.grid_search_match(
            gridops.values(grid), grid, _poses(poses, grid.device),
            **scan_tensors(store, scan_ids, grid.device),
            usable_range_min=self.usable_range_min,
            usable_range_max=self.usable_range_max,
            normalized_score_threshold=0.0, step_x=self.step_x,
            step_y=self.step_y, step_t=self.step_theta,
            nx=2 * int(np.floor(0.5 * self.range_x / self.step_x)) + 1,
            ny=2 * int(np.floor(0.5 * self.range_y / self.step_y)) + 1,
            nt=2 * int(np.floor(0.5 * self.range_theta /
                                self.step_theta)) + 1,
            cost_type=self.cost_type, greedy_params=self.greedy_params)
        return matchers_sweep.pack_summary(summary)


@dataclasses.dataclass
class HillClimbingMatcher(AsyncMatcher):
    """ScanMatcherHillClimbing config
    (launcher_settings_default.json:22-29)."""

    linear_step: float = 0.1
    angular_step: float = 0.1
    max_iterations: int = 100
    max_refinements: int = 5
    usable_range_min: float = 0.01
    usable_range_max: float = 20.0
    cost_type: str = "greedy_endpoint"
    greedy_params: tuple = DEFAULT_GREEDY_PARAMS

    def _match_packed(self, grid, store, scan_ids, poses) -> torch.Tensor:
        summary = matchers.hill_climbing_match(
            gridops.values(grid), grid, _poses(poses, grid.device),
            **scan_tensors(store, scan_ids, grid.device),
            usable_range_min=self.usable_range_min,
            usable_range_max=self.usable_range_max,
            linear_step=self.linear_step, angular_step=self.angular_step,
            max_iterations=self.max_iterations,
            max_refinements=self.max_refinements,
            cost_type=self.cost_type, greedy_params=self.greedy_params)
        return matchers_sweep.pack_summary(summary)


@dataclasses.dataclass
class LinearSolverMatcher(AsyncMatcher):
    """ScanMatcherLinearSolver config
    (launcher_settings_default.json:31-40)."""

    max_iterations: int = 100
    convergence_threshold: float = 1e-3
    usable_range_min: float = 0.01
    usable_range_max: float = 20.0
    translation_regularizer: float = 1e-3
    rotation_regularizer: float = 1e-3

    def _match_packed(self, grid, store, scan_ids, poses) -> torch.Tensor:
        summary = matchers.linear_solver_match(
            gridops.values(grid), grid, _poses(poses, grid.device),
            **scan_tensors(store, scan_ids, grid.device),
            usable_range_min=self.usable_range_min,
            usable_range_max=self.usable_range_max,
            translation_regularizer=self.translation_regularizer,
            rotation_regularizer=self.rotation_regularizer,
            convergence_threshold=self.convergence_threshold,
            max_iterations=self.max_iterations)
        return matchers_sweep.pack_summary(summary)
