"""What the reference reads from a launcher settings file.

The reference reads the settings JSON itself, with the launcher's
defaults and its one quirk: ``slam_launcher.cpp:70-72`` passes the
greedy-endpoint cost's ``StandardDeviation`` and ``ScalingFactor`` in
each other's places, so the effective sigma is the JSON ``ScalingFactor``
and the effective scale the JSON ``StandardDeviation``. Defaults as
``utils/config.py`` of the port at commit 8e18ecb has them.
"""

from __future__ import annotations

from typing import Any


def get(tree: dict, path: str, default=None) -> Any:
    node: Any = tree
    for part in path.split("."):
        if not isinstance(node, dict) or part not in node:
            return default
        node = node[part]
    return node


def _bool(v) -> bool:
    return v.strip().lower() == "true" if isinstance(v, str) else bool(v)


def _cost(tree: dict, group: str) -> dict:
    g = get(tree, group, {})
    return dict(
        usable_min=float(g.get("UsableRangeMin", 0.01)),
        usable_max=float(g.get("UsableRangeMax", 50.0)),
        greedy=dict(
            hit_and_missed_dist=float(g.get("HitAndMissedDist", 0.075)),
            occupancy_threshold=float(g.get("OccupancyThreshold", 0.1)),
            kernel_size=int(g.get("KernelSize", 1)),
            standard_deviation=float(g.get("ScalingFactor", 1.0)),
            scaling_factor=float(g.get("StandardDeviation", 0.05))))


def _matcher(tree: dict, kind: str, group: str, defaults: dict) -> dict:
    g = get(tree, group, {})
    out = dict(kind=kind,
               range_x=float(g.get("SearchRangeX", defaults["range_x"])),
               range_y=float(g.get("SearchRangeY", defaults["range_y"])),
               range_theta=float(g.get("SearchRangeTheta",
                                       defaults["range_theta"])),
               scan_range_max=float(g.get("ScanRangeMax", 20.0)),
               node_height_max=int(g.get("NodeHeightMax", 6)),
               frontier_cap=int(get(tree, "Tpu.BranchBoundFrontierCap",
                                    4096)))
    out.update(_cost(tree, g.get("CostConfigGroup", "CostGreedyEndpoint")))
    return out


def read(tree: dict) -> dict:
    top = get(tree, "LidarGraphSlam", {})
    gm = get(tree, top.get("GridMapBuilderConfigGroup", "GridMapBuilder"),
             {})
    fe = get(tree, top.get("FrontendConfigGroup", "Frontend"), {})
    be = get(tree, top.get("BackendConfigGroup", "Backend"), {})
    interp = None
    if _bool(fe.get("UseScanInterpolator", True)):
        ig = get(tree, fe.get("ScanInterpolatorConfigGroup",
                              "ScanInterpolator"), {})
        interp = dict(dist_scans=float(ig.get("DistScans", 0.05)),
                      dist_threshold_empty=float(
                          ig.get("DistThresholdEmpty", 0.25)))
    if _bool(fe.get("UseScanAccumulator", False)):
        raise ValueError("the reference has no scan accumulator")
    fe_type = get(fe, "LocalSlam.ScanMatcherType", "HillClimbing")
    if fe_type not in ("RealTimeCorrelative", "BranchBound"):
        raise ValueError(f"no reference for frontend matcher {fe_type}")
    frontend = _matcher(
        tree, fe_type, get(fe, "LocalSlam.ScanMatcherConfigGroup"),
        dict(range_x=0.75, range_y=0.75, range_theta=0.5)
        if fe_type == "RealTimeCorrelative" else
        dict(range_x=2.0, range_y=2.0, range_theta=1.0))
    det_type = be.get("LoopDetectorType", "GridSearch")
    if det_type == "Empty":
        detector = dict(kind="Empty")
    elif det_type == "BranchBound":
        dg = get(tree, be.get("LoopDetectorConfigGroup",
                              "LoopDetectorGridSearch"), {})
        detector = _matcher(tree, det_type, dg.get("ScanMatcherConfigGroup"),
                            dict(range_x=2.0, range_y=2.0, range_theta=1.0))
        detector["score_threshold"] = float(dg.get("ScoreThreshold", 0.8))
    else:
        raise ValueError(f"no reference for loop detector {det_type}")
    og = get(tree, be.get("PoseGraphOptimizerConfigGroup",
                          "PoseGraphOptimizerLM"), {})
    loss_type = og.get("LossFunctionType", "Huber")
    loss_group = og.get("LossFunctionConfigGroup", "LossHuber")
    loss_defaults = {"Squared": 1.0, "Huber": 1.345 * 1.345, "Cauchy": 1e-2,
                     "Fair": 1.3998 * 1.3998, "GemanMcClure": 1.0,
                     "Welsch": 2.9846 * 2.9846, "DCS": 1.0}
    return dict(
        map=dict(resolution=float(get(gm, "Map.Resolution", 0.05)),
                 local_size=int(get(tree, "Tpu.LocalMapSize", 1536)),
                 latest_size=int(get(tree, "Tpu.LatestMapSize", 1024)),
                 latest_scans=int(get(gm, "Map.NumOfScansForLatestMap", 5)),
                 usable_min=float(gm.get("UsableRangeMin", 0.01)),
                 usable_max=float(gm.get("UsableRangeMax", 50.0)),
                 prob_hit=float(gm.get("ProbabilityHit", 0.9)),
                 prob_miss=float(gm.get("ProbabilityMiss", 0.1)),
                 max_ray_steps=int(get(tree, "Tpu.MaxRaySteps", 448))),
        interpolator=interp, frontend=frontend, detector=detector,
        lm=dict(loss_name=loss_type,
                loss_scale=float(get(tree, loss_group + ".Scale",
                                     loss_defaults.get(loss_type, 1.0))),
                max_iterations=int(og.get("NumOfIterationsMax", 10)),
                error_tolerance=float(og.get("ErrorTolerance", 1e-3)),
                initial_lambda=float(og.get("InitialLambda", 1e-4))))
