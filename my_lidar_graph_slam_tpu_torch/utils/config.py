"""JSON configuration system with strategy composition.

Counterpart of ``my_lidar_graph_slam_tpu/utils/config.py:36-116,167-202,
234-350``. Reads the reference launcher's JSON schema verbatim
(launcher_settings_default.json, slam_launcher.cpp:54-876): every
component is selected by a ``<X>Type`` string plus a ``<X>ConfigGroup``
name pointing at its settings group. The ``Tpu`` group's keys (dense map
sizes, beam capacity, ray-step cap) are read as they are.

Ported strategies: the RealTimeCorrelative scan matcher with the
GreedyEndpoint cost, the Nearest loop searcher, the BranchBound and Empty
loop detectors, and the LM optimizer (host solver). Any other type raises
``NotImplementedError`` ("not ported yet").
"""

from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np

from my_lidar_graph_slam_tpu_torch.models import loop_closure as lc
from my_lidar_graph_slam_tpu_torch.models import map_builder as mb
from my_lidar_graph_slam_tpu_torch.models import (optimizer_host,
                                                  scan_matchers, slam)
from my_lidar_graph_slam_tpu_torch.models.pose_graph import PoseGraph
from my_lidar_graph_slam_tpu_torch.models.preprocess import (
    ScanAccumulator, ScanInterpolator)
from my_lidar_graph_slam_tpu_torch.utils import device as device_mod


class Config:
    """Dotted-path accessor over nested JSON (Boost ptree style)."""

    def __init__(self, tree: Dict[str, Any]):
        self.tree = tree

    def get(self, path: str, default=None):
        node: Any = self.tree
        for part in path.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def get_bool(self, path: str, default: bool) -> bool:
        v = self.get(path, default)
        if isinstance(v, str):
            return v.lower() == "true"
        return bool(v)

    def group(self, path: str) -> "Config":
        sub = self.get(path)
        if sub is None:
            raise KeyError(f"missing config group: {path}")
        return Config(sub)


def load(path: str) -> Config:
    with open(path) as f:
        return Config(json.load(f))


def _not_ported(kind: str, name: str):
    return NotImplementedError(f"{kind} {name!r} is not ported yet")


def _greedy_params(root: Config, group: str) -> tuple:
    """CostGreedyEndpoint settings (slam_launcher.cpp:54-76).

    The launcher swaps the last two constructor arguments (header order is
    scalingFactor, standardDeviation — cost_function_greedy_endpoint.hpp:
    20-27 — but the call site passes standardDeviation, scalingFactor), so
    the EFFECTIVE sigma is the JSON ScalingFactor and the effective scale
    is the JSON StandardDeviation. We replicate the behavior as configured.
    """
    g = root.group(group)
    return (
        ("hit_and_missed_dist", float(g.get("HitAndMissedDist", 0.075))),
        ("occupancy_threshold", float(g.get("OccupancyThreshold", 0.1))),
        ("kernel_size", int(g.get("KernelSize", 1))),
        ("standard_deviation", float(g.get("ScalingFactor", 1.0))),
        ("scaling_factor", float(g.get("StandardDeviation", 0.05))),
    )


def _cost_settings(root: Config, cost_type: str, group: str):
    """Returns (cost_type_str, greedy_params, usable_min, usable_max)."""
    if cost_type != "GreedyEndpoint":
        raise _not_ported("cost type", cost_type)
    g = root.group(group)
    return ("greedy_endpoint", _greedy_params(root, group),
            float(g.get("UsableRangeMin", 0.01)),
            float(g.get("UsableRangeMax", 50.0)))


def create_scan_matcher(root: Config, matcher_type: str, group: str):
    """CreateScanMatcher (slam_launcher.cpp:325-342)."""
    if matcher_type != "RealTimeCorrelative":
        raise _not_ported("scan matcher", matcher_type)
    g = root.group(group)
    cost_type, gp, umin, umax = _cost_settings(
        root, g.get("CostType", "GreedyEndpoint"),
        g.get("CostConfigGroup", "CostGreedyEndpoint"))
    return scan_matchers.CorrelativeMatcher(
        low_resolution=int(g.get("LowResolutionMapWinSize", 10)),
        range_x=float(g.get("SearchRangeX", 0.75)),
        range_y=float(g.get("SearchRangeY", 0.75)),
        range_theta=float(g.get("SearchRangeTheta", 0.5)),
        scan_range_max=float(g.get("ScanRangeMax", 20.0)),
        usable_range_min=umin, usable_range_max=umax,
        cost_type=cost_type, greedy_params=gp)


def create_loop_searcher(root: Config, searcher_type: str, group: str):
    """CreateLoopSearcher (slam_launcher.cpp:345-374)."""
    if searcher_type != "Nearest":
        raise ValueError(f"unknown loop searcher type: {searcher_type}")
    g = root.group(group)
    return lc.LoopSearcherNearest(
        travel_dist_threshold=float(g.get("TravelDistThreshold", 10.0)),
        node_dist_max=float(g.get("PoseGraphNodeDistMax", 2.0)),
        num_candidate_nodes=int(g.get("NumOfCandidateNodes", 1)),
        num_candidate_maps=int(g.get("NumOfCandidateMaps", 1)))


def create_loop_detector(root: Config, detector_type: str, group: str):
    """CreateLoopDetector (slam_launcher.cpp:482-497)."""
    if detector_type == "Empty":
        return lc.LoopDetectorEmpty()
    if detector_type != "BranchBound":
        raise _not_ported("loop detector", detector_type)
    g = root.group(group)
    sm_group = root.group(g.get("ScanMatcherConfigGroup"))
    _, gp, umin, umax = _cost_settings(
        root, sm_group.get("CostType", "GreedyEndpoint"),
        sm_group.get("CostConfigGroup", "CostGreedyEndpoint"))
    return lc.LoopDetectorBranchBound(
        score_threshold=float(g.get("ScoreThreshold", 0.8)),
        node_height_max=int(sm_group.get("NodeHeightMax", 6)),
        range_x=float(sm_group.get("SearchRangeX", 2.0)),
        range_y=float(sm_group.get("SearchRangeY", 2.0)),
        range_theta=float(sm_group.get("SearchRangeTheta", 1.0)),
        scan_range_max=float(sm_group.get("ScanRangeMax", 20.0)),
        usable_range_min=umin, usable_range_max=umax,
        frontier_cap=int(root.get("Tpu.BranchBoundFrontierCap", 4096)),
        greedy_params=gp)


def create_optimizer_config(root: Config, optimizer_type: str,
                            group: str) -> optimizer_host.LMConfig:
    """CreatePoseGraphOptimizerLM (slam_launcher.cpp:627-661)."""
    if optimizer_type != "LM":
        raise ValueError(f"unknown optimizer type: {optimizer_type}")
    g = root.group(group)
    solver_str = g.get("SolverType", "SparseCholesky")
    solver = "cg" if solver_str == "ConjugateGradient" else "dense"
    loss_type = g.get("LossFunctionType", "Huber")
    loss_group = g.get("LossFunctionConfigGroup", "LossHuber")
    loss_defaults = {
        "Squared": 1.0, "Huber": 1.345 * 1.345, "Cauchy": 1e-2,
        "Fair": 1.3998 * 1.3998, "GemanMcClure": 1.0,
        "Welsch": 2.9846 * 2.9846, "DCS": 1.0,
    }
    scale = float(root.get(loss_group + ".Scale",
                           loss_defaults.get(loss_type, 1.0)))
    return optimizer_host.LMConfig(
        solver=solver,
        max_iterations=int(g.get("NumOfIterationsMax", 10)),
        error_tolerance=float(g.get("ErrorTolerance", 1e-3)),
        initial_lambda=float(g.get("InitialLambda", 1e-4)),
        loss_name=loss_type,
        loss_scale=scale,
        cg_max_iterations=int(root.get("Tpu.CgMaxIterations", 256)),
        cg_tolerance=float(root.get("Tpu.CgTolerance", 1e-6)))


def create_slam(root: Config, device=None,
                threaded_backend: bool = False) -> slam.LidarGraphSlam:
    """CreateLidarGraphSlam (slam_launcher.cpp:846-876): the full object
    graph from one settings tree. Maps live on ``device``: ``cuda`` unless
    the caller asks for ``"cpu"``; without a card a CUDA device raises."""
    dev = device_mod.resolve(device)
    top = root.group("LidarGraphSlam") if root.get("LidarGraphSlam") \
        else Config({})

    # Grid map builder (slam_launcher.cpp:711-737).
    g = root.group(top.get("GridMapBuilderConfigGroup", "GridMapBuilder"))
    builder_cfg = mb.MapBuilderConfig(
        resolution=float(g.get("Map.Resolution", 0.05)),
        local_map_size=int(root.get("Tpu.LocalMapSize", 1536)),
        latest_map_size=int(root.get("Tpu.LatestMapSize", 1024)),
        num_scans_for_latest_map=int(g.get("Map.NumOfScansForLatestMap", 5)),
        travel_dist_threshold=float(
            g.get("Map.TravelDistThresholdForLocalMap", 20.0)),
        usable_range_min=float(g.get("UsableRangeMin", 0.01)),
        usable_range_max=float(g.get("UsableRangeMax", 50.0)),
        prob_hit=float(g.get("ProbabilityHit", 0.9)),
        prob_miss=float(g.get("ProbabilityMiss", 0.1)),
        max_ray_steps=int(root.get("Tpu.MaxRaySteps", 448)),
    )
    store = mb.ScanStore(
        beam_capacity=int(root.get("Tpu.BeamCapacity", 1024)))
    builder = mb.GridMapBuilder(builder_cfg, store, device=dev)

    # Frontend (slam_launcher.cpp:740-803).
    fe = root.group(top.get("FrontendConfigGroup", "Frontend"))
    accumulator = None
    if fe.get_bool("UseScanAccumulator", False):
        acc_group = root.group(
            fe.get("ScanAccumulatorConfigGroup", "ScanAccumulator"))
        accumulator = ScanAccumulator(
            num_accumulated_scans=int(
                acc_group.get("NumOfAccumulatedScans", 3)))
    interpolator = None
    if fe.get_bool("UseScanInterpolator", True):
        int_group = root.group(
            fe.get("ScanInterpolatorConfigGroup", "ScanInterpolator"))
        interpolator = ScanInterpolator(
            dist_scans=float(int_group.get("DistScans", 0.05)),
            dist_threshold_empty=float(
                int_group.get("DistThresholdEmpty", 0.25)))
    matcher = create_scan_matcher(
        root,
        fe.get("LocalSlam.ScanMatcherType", "HillClimbing"),
        fe.get("LocalSlam.ScanMatcherConfigGroup", "ScanMatcherHillClimbing"))
    fe_cfg = slam.FrontendConfig(
        initial_pose=np.array([
            float(fe.get("InitialPose.X", 0.0)),
            float(fe.get("InitialPose.Y", 0.0)),
            float(fe.get("InitialPose.Theta", 0.0))]),
        update_threshold_travel_dist=float(
            fe.get("UpdateThresholdTravelDist", 1.0)),
        update_threshold_angle=float(fe.get("UpdateThresholdAngle", 0.5)),
        update_threshold_time=float(fe.get("UpdateThresholdTime", 5.0)),
        loop_detection_interval=int(fe.get("LoopDetectionInterval", 10)))
    frontend = slam.Frontend(fe_cfg, matcher, interpolator=interpolator,
                             accumulator=accumulator)

    # Backend (slam_launcher.cpp:806-843).
    be = root.group(top.get("BackendConfigGroup", "Backend"))
    lm_cfg = create_optimizer_config(
        root,
        be.get("PoseGraphOptimizerType", "LM"),
        be.get("PoseGraphOptimizerConfigGroup", "PoseGraphOptimizerLM"))
    searcher = create_loop_searcher(
        root,
        be.get("LoopSearcherType", "Nearest"),
        be.get("LoopSearcherConfigGroup", "LoopSearcherNearest"))
    detector = create_loop_detector(
        root,
        be.get("LoopDetectorType", "GridSearch"),
        be.get("LoopDetectorConfigGroup", "LoopDetectorGridSearch"))
    backend = slam.Backend(searcher, detector, lm_cfg)

    return slam.LidarGraphSlam(frontend, backend, builder, PoseGraph(),
                               threaded_backend=threaded_backend)
