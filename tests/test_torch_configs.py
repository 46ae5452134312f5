"""The port's settings factories against the JAX package's, and the
BranchBound-frontend settings end to end, on the CPU.

For each settings file in ``configs/`` the port's ``create_slam`` builds
the components the JAX ``create_slam`` builds, with the same settings;
every matcher, cost and detector type that the JAX factories accept is
accepted. The end-to-end case runs both launchers on a small synthetic
log with ``configs/launcher_settings_bb_frontend.json`` cut to CI scale
(0.1 m cells, small maps, 8 m ranges); the JAX loop detector is put on its
Pallas sweep (interpret mode), the port's path, so both packages run the
same algorithm. Tolerances: poses 1e-3 m and ATE 0.02 m
(tests/test_torch_slice.py:35-36; largest pose error seen in a CPU run
1.8e-5 m).
"""

import copy
import dataclasses
import glob
import json
import os

import numpy as np
import pytest

from my_lidar_graph_slam_tpu import launcher as jlauncher
from my_lidar_graph_slam_tpu.io import map_io as jmap_io
from my_lidar_graph_slam_tpu.io import synth as jsynth
from my_lidar_graph_slam_tpu.utils import config as jconfig
from my_lidar_graph_slam_tpu.utils import metrics as jmetrics
from my_lidar_graph_slam_tpu_torch import launcher as tlauncher
from my_lidar_graph_slam_tpu_torch.io import map_io as tmap_io
from my_lidar_graph_slam_tpu_torch.utils import config as tconfig
from my_lidar_graph_slam_tpu_torch.utils import metrics as tmetrics
from tests.test_torch_matcher import one_torch_thread  # noqa: F401

CONFIGS = sorted(glob.glob("configs/*.json"))
BB_FRONTEND = "configs/launcher_settings_bb_frontend.json"


def _fields(obj):
    return dataclasses.asdict(obj) if dataclasses.is_dataclass(obj) else {}


def _same_component(t, j):
    """Same class name, and equal values in every field both have."""
    assert type(t).__name__ == type(j).__name__
    tf, jf = _fields(t), _fields(j)
    shared = tf.keys() & jf.keys()
    assert shared or not tf
    for k in shared:
        assert tf[k] == jf[k], (type(t).__name__, k)


@pytest.mark.parametrize("path", CONFIGS,
                         ids=[os.path.basename(p) for p in CONFIGS])
def test_create_slam_builds_the_jax_components(path):
    t = tconfig.create_slam(tconfig.load(path), device="cpu")
    j = jconfig.create_slam(jconfig.load(path))
    _same_component(t.frontend.matcher, j.frontend.matcher)
    _same_component(t.backend.detector, j.backend.detector)
    _same_component(t.backend.searcher, j.backend.searcher)
    assert vars(t.backend.lm_config) == vars(j.backend.lm_config)
    assert vars(t.builder.config) == vars(j.builder.config)
    assert vars(t.frontend.config).keys() == vars(j.frontend.config).keys()
    assert t.backend.host_solver_max_nodes == j.backend.host_solver_max_nodes
    assert str(t.backend.device) == "cpu"


def _tree_with(group, **keys):
    tree = json.load(open(BB_FRONTEND))
    tree.setdefault(group, {}).update(keys)
    return tree


MATCHER_GROUPS = {"RealTimeCorrelative": "ScanMatcherRealTimeCorrelative",
                  "BranchBound": "ScanMatcherBranchBound",
                  "GridSearch": "ScanMatcherGridSearch",
                  "HillClimbing": "ScanMatcherHillClimbing",
                  "LinearSolver": "ScanMatcherLinearSolver"}
COSTS = {"GreedyEndpoint": "CostGreedyEndpoint",
         "SquareError": "CostSquareError"}


@pytest.mark.parametrize("cost", sorted(COSTS))
@pytest.mark.parametrize("matcher", sorted(MATCHER_GROUPS))
def test_every_jax_matcher_and_cost_is_accepted(matcher, cost):
    group = MATCHER_GROUPS[matcher]
    tree = _tree_with(group, CostType=cost, CostConfigGroup=COSTS[cost])
    t = tconfig.create_scan_matcher(tconfig.Config(copy.deepcopy(tree)),
                                    matcher, group)
    j = jconfig.create_scan_matcher(jconfig.Config(tree), matcher, group)
    _same_component(t, j)


@pytest.mark.parametrize("detector", ["BranchBound", "GridSearch", "Empty",
                                      "RealTimeCorrelative"])
def test_every_ported_jax_detector_is_accepted(detector):
    group = f"LoopDetector{detector}"
    tree = _tree_with(group)
    if detector == "GridSearch":
        tree[group]["ScanMatcherConfigGroup"] = "LoopDetectorBranchBound." \
            "ScanMatcher"
    t = tconfig.create_loop_detector(tconfig.Config(copy.deepcopy(tree)),
                                     detector, group)
    j = jconfig.create_loop_detector(jconfig.Config(tree), detector, group)
    _same_component(t, j)


def test_correlative_loop_detector_builds_as_in_jax():
    """The RealTimeCorrelative loop detector, the last of the JAX
    factories' strategies to be ported, now builds as the JAX package's
    does, with ``Tpu.CorrelativeRefineBlocks``, and in a whole SLAM on the
    default settings."""
    group = "LoopDetectorRealTimeCorrelative"
    tree = json.load(open(BB_FRONTEND))
    tree.setdefault("Tpu", {})["CorrelativeRefineBlocks"] = 96
    j = jconfig.create_loop_detector(jconfig.Config(tree),
                                     "RealTimeCorrelative", group)
    t = tconfig.create_loop_detector(tconfig.Config(copy.deepcopy(tree)),
                                     "RealTimeCorrelative", group)
    _same_component(t, j)
    assert t.refine_blocks == 96
    tree = json.load(open("configs/launcher_settings_default.json"))
    tree["Backend"].update(LoopDetectorType="RealTimeCorrelative",
                           LoopDetectorConfigGroup=group)
    s = tconfig.create_slam(tconfig.Config(tree), device="cpu")
    assert type(s.backend.detector).__name__ == "LoopDetectorCorrelative"
    assert s.backend.detector.range_x == 5.0


def _small_bb_frontend_settings(path, gt0):
    """The bb_frontend settings at CI scale: 0.1 m cells, 256^2 local and
    192^2 latest maps, 8 m ranges, a +-1 m x +-1 m x 0.5 rad loop
    window (tests/test_torch_launcher.py's cuts)."""
    d = json.load(open(BB_FRONTEND))
    gm = d["GridMapBuilder"]
    gm["Map"].update(Resolution=0.1, NumOfScansForLatestMap=5,
                     TravelDistThresholdForLocalMap=6.0)
    gm["UsableRangeMax"] = 8.0
    d["Tpu"] = dict(LocalMapSize=256, LatestMapSize=192, BeamCapacity=256,
                    MaxRaySteps=128)
    fe = d["Frontend"]
    fe.update(UseScanInterpolator=False, UpdateThresholdAngle=0.3)
    fe["InitialPose"] = dict(X=float(gt0[0]), Y=float(gt0[1]),
                             Theta=float(gt0[2]))
    d["ScanMatcherBranchBound"]["ScanRangeMax"] = 8.0
    d["CostGreedyEndpoint"]["UsableRangeMax"] = 8.0
    bb = d["LoopDetectorBranchBound"]
    bb["ScoreThreshold"] = 0.5
    bb["ScanMatcher"].update(SearchRangeX=2.0, SearchRangeY=2.0,
                             SearchRangeTheta=0.5, ScanRangeMax=8.0,
                             NodeHeightMax=4)
    bb["CostGreedyEndpoint"]["UsableRangeMax"] = 8.0
    bb["ScorePixelAccurate"]["UsableRangeMax"] = 8.0
    d["LoopSearcherNearest"].update(TravelDistThreshold=5.0,
                                    PoseGraphNodeDistMax=3.0)
    with open(path, "w") as f:
        json.dump(d, f)


def test_bb_frontend_settings_end_to_end_match_jax(tmp_path, monkeypatch):
    scans, gt = jsynth.simulate(
        world=jsynth.mini_world(), waypoints=jsynth.mini_loop_waypoints(),
        config=jsynth.SimConfig(step=0.25, max_range=8.0, seed=4))
    log = str(tmp_path / "mini.clf")
    jsynth.write_carmen_log(log, scans, max_range=8.0)
    gt_path = str(tmp_path / "gt.npz")
    np.savez(gt_path, true_poses=gt,
             timestamps=np.array([s.timestamp for s in scans]))
    settings = str(tmp_path / "settings.json")
    _small_bb_frontend_settings(settings, gt[0])

    create = jconfig.create_slam

    def create_on_sweep(*a, **kw):
        s = create(*a, **kw)
        s.backend.detector.use_mxu = True
        s.backend.detector.mxu_interpret = True
        return s

    monkeypatch.setattr(jconfig, "create_slam", create_on_sweep)
    stats = {}
    for name, mod, metrics, kw in (
            ("torch", tlauncher, tmetrics, dict(platform="cpu")),
            ("jax", jlauncher, jmetrics, {})):
        metrics.MetricManager.reset_instance()
        stats[name] = mod.run(log, settings, str(tmp_path / name),
                              threaded_backend=False, gt_path=gt_path, **kw)
    t, j = stats["torch"], stats["jax"]
    for k in ("num_scans", "num_nodes", "num_edges", "num_loop_closures"):
        assert t[k] == j[k], k
    assert t["num_loop_closures"] >= 1
    assert abs(t["ate_rmse_m"] - j["ate_rmse_m"]) < 0.02
    tg, _ = tmap_io.load_checkpoint(str(tmp_path / "torch.ckpt.npz"), 256)
    jg, _ = jmap_io.load_checkpoint(str(tmp_path / "jax.ckpt.npz"), 256)
    np.testing.assert_allclose(tg.node_poses(), jg.node_poses(), rtol=0,
                               atol=1e-3)
