"""The port's whole online slice against the JAX package on the CPU, on
small synthetic runs like tests/test_e2e.py.

Each package simulates its own scans from the same world, route and seed.
The JAX frontend runs its default CPU matcher (the pruned path, certified
equal to brute force); its loop detector runs the Pallas sweep in
interpret mode. The port runs its plain versions.
"""

import numpy as np
import pytest

from my_lidar_graph_slam_tpu.io import synth as jsynth
from my_lidar_graph_slam_tpu.models import loop_closure as jlc
from my_lidar_graph_slam_tpu.models import map_builder as jmb
from my_lidar_graph_slam_tpu.models import optimizer_lm as jlm
from my_lidar_graph_slam_tpu.models import slam as jslam
from my_lidar_graph_slam_tpu.models.pose_graph import PoseGraph as JGraph
from my_lidar_graph_slam_tpu.models.preprocess import \
    ScanInterpolator as JInterp
from my_lidar_graph_slam_tpu.models.scan_matchers import \
    CorrelativeMatcher as JMatcher
from my_lidar_graph_slam_tpu_torch.io import synth as tsynth
from my_lidar_graph_slam_tpu_torch.models import loop_closure as tlc
from my_lidar_graph_slam_tpu_torch.models import map_builder as tmb
from my_lidar_graph_slam_tpu_torch.models import optimizer_host as tlm
from my_lidar_graph_slam_tpu_torch.models import slam as tslam
from my_lidar_graph_slam_tpu_torch.models.pose_graph import \
    PoseGraph as TGraph
from my_lidar_graph_slam_tpu_torch.models.preprocess import \
    ScanInterpolator as TInterp
from my_lidar_graph_slam_tpu_torch.models.scan_matchers import \
    CorrelativeMatcher as TMatcher
from tests.test_torch_matcher import one_torch_thread  # noqa: F401

POSE_ATOL = 1e-3
ATE_ATOL = 0.02


def _build(pkg, map_cfg, beam_capacity, matcher_kw, frontend_kw,
           interpolator_kw=None, detector_kw=None, searcher_kw=None):
    """The same SLAM object graph from either package."""
    if pkg == "jax":
        mb, slam, lc, graph = jmb, jslam, jlc, JGraph()
        matcher = JMatcher(**matcher_kw)
        interp = None if interpolator_kw is None else JInterp(
            **interpolator_kw)
        lm_cfg = jlm.LMConfig(max_iterations=10)
        builder = mb.GridMapBuilder(mb.MapBuilderConfig(**map_cfg),
                                    mb.ScanStore(beam_capacity))
    else:
        mb, slam, lc, graph = tmb, tslam, tlc, TGraph()
        matcher = TMatcher(**matcher_kw)
        interp = None if interpolator_kw is None else TInterp(
            **interpolator_kw)
        lm_cfg = tlm.LMConfig(max_iterations=10)
        builder = mb.GridMapBuilder(mb.MapBuilderConfig(**map_cfg),
                                    mb.ScanStore(beam_capacity),
                                    device="cpu")
    fe_cfg = slam.FrontendConfig(loop_detection_interval=5)
    for k, v in frontend_kw.items():
        setattr(fe_cfg, k, v)
    frontend = slam.Frontend(fe_cfg, matcher, interpolator=interp)
    backend = None
    if detector_kw is not None:
        det = lc.LoopDetectorBranchBound(**detector_kw)
        if pkg == "jax":
            det.use_mxu, det.mxu_interpret = True, True
        backend = slam.Backend(lc.LoopSearcherNearest(**searcher_kw), det,
                               lm_cfg)
    return slam.LidarGraphSlam(frontend, backend, builder, graph)


def _run(s, scans, gt):
    processed = []
    for scan, tp in zip(scans, gt):
        if s.process_scan(scan, scan.odom_pose):
            processed.append(tp)
    est = s.graph.node_poses()
    err = est[:, :2] - np.asarray(processed)[:, :2]
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))


def _simulate(world, wps, **cfg):
    js, jgt = jsynth.simulate(world=world, waypoints=wps,
                              config=jsynth.SimConfig(**cfg))
    ts, tgt = tsynth.simulate(world, wps, tsynth.SimConfig(**cfg))
    np.testing.assert_array_equal(tgt, jgt)
    return (js, jgt), (ts, tgt)


def test_odometry_only_corridor_matches_jax():
    """Frontend + map builder only (tests/test_e2e.py corridor_run)."""
    wps = jsynth.rotate_points(np.array([[-8.5, -5.0], [0.5, -5.0]]),
                               jsynth.WORLD_ROTATION)
    (js, jgt), (ts, tgt) = _simulate(jsynth.default_world(), wps, step=0.25,
                                     max_range=12.0, seed=1)
    kw = dict(
        map_cfg=dict(resolution=0.05, local_map_size=640, latest_map_size=512,
                     travel_dist_threshold=8.0, usable_range_max=12.0,
                     max_ray_steps=256),
        beam_capacity=512,
        matcher_kw=dict(scan_range_max=12.0, usable_range_max=12.0),
        frontend_kw=dict(initial_pose=np.asarray(jgt[0], np.float64)),
        interpolator_kw=dict(dist_scans=0.1, dist_threshold_empty=0.25))
    j = _build("jax", **kw)
    t = _build("torch", **kw)
    ate_j = _run(j, js, jgt)
    ate_t = _run(t, ts, tgt)
    assert t.graph.num_nodes == j.graph.num_nodes
    np.testing.assert_allclose(t.graph.node_poses(), j.graph.node_poses(),
                               rtol=0, atol=POSE_ATOL)
    assert abs(ate_t - ate_j) < ATE_ATOL
    assert len(t.builder.local_maps) == len(j.builder.local_maps)


MINI_WORLD = dict(step=0.25, max_range=8.0, seed=4)


def _mini_kw(gt0):
    return dict(
        map_cfg=dict(resolution=0.1, local_map_size=256, latest_map_size=192,
                     num_scans_for_latest_map=5, travel_dist_threshold=6.0,
                     usable_range_max=8.0, max_ray_steps=128),
        beam_capacity=256,
        matcher_kw=dict(scan_range_max=8.0, usable_range_max=8.0),
        frontend_kw=dict(initial_pose=np.asarray(gt0, np.float64),
                         update_threshold_angle=0.3),
        detector_kw=dict(score_threshold=0.5, node_height_max=4,
                         range_x=2.0, range_y=2.0, range_theta=0.5,
                         scan_range_max=8.0, usable_range_max=8.0),
        searcher_kw=dict(travel_dist_threshold=5.0, node_dist_max=3.0,
                         num_candidate_nodes=2))


@pytest.fixture(scope="module")
def loop_runs():
    """A mini-world lap plus a revisit (0.1 m maps, small enough for the
    JAX detector in interpret mode), with the loop detector."""
    (js, jgt), (ts, tgt) = _simulate(
        jsynth.mini_world(), jsynth.mini_loop_waypoints(), **MINI_WORLD)
    j = _build("jax", **_mini_kw(jgt[0]))
    t = _build("torch", **_mini_kw(tgt[0]))
    return (j, _run(j, js, jgt)), (t, _run(t, ts, tgt))


def test_loop_run_matches_jax(loop_runs):
    (j, ate_j), (t, ate_t) = loop_runs
    assert j.backend.num_loop_closures >= 1
    assert t.graph.num_nodes == j.graph.num_nodes
    loop_edges_j = j.graph.num_edges - (j.graph.num_nodes - 1)
    loop_edges_t = t.graph.num_edges - (t.graph.num_nodes - 1)
    assert loop_edges_t == loop_edges_j >= 1
    assert t.backend.num_loop_closures == j.backend.num_loop_closures
    assert abs(ate_t - ate_j) < ATE_ATOL


def test_loop_run_graph_is_consistent(loop_runs):
    _, (t, _) = loop_runs
    g = t.graph
    assert np.isfinite(g.node_poses()).all()
    e = g.num_edges
    odo = g.edge_is_odom[:e]
    assert odo.sum() == g.num_nodes - 1
    assert (g.edge_j[:e][odo] == g.edge_i[:e][odo] + 1).all()
    assert all(lm.finished for lm in t.builder.local_maps[:-1])


def test_threaded_backend_matches_synchronous(loop_runs):
    """The backend on a worker thread, stepped with wait_for_backend after
    every scan, lands each pass where the synchronous backend does; the
    stop-time drain pass then only adds to the graph."""
    _, (t_sync, _) = loop_runs
    scans, gt = tsynth.simulate(jsynth.mini_world(),
                                jsynth.mini_loop_waypoints(),
                                tsynth.SimConfig(**MINI_WORLD))
    s = _build("torch", **_mini_kw(gt[0]))
    s._threaded = True
    s.start_backend()
    for scan in scans:
        s.process_scan(scan, scan.odom_pose)
        s.wait_for_backend()
    n, e = s.graph.num_nodes, s.graph.num_edges
    poses = s.graph.node_poses().copy()
    s.stop_backend()
    assert s._backend_thread is None
    assert (n, e) == (t_sync.graph.num_nodes, t_sync.graph.num_edges)
    np.testing.assert_array_equal(poses, t_sync.graph.node_poses())
    assert s.graph.num_edges >= e
