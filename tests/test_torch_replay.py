"""The port's chunked replay frontend (``models/replay.py``) on the CPU:
against its own online frontend and against the JAX package's
``ReplayRunner`` (the cases of tests/test_replay.py).

Tolerances: chunk sizes and the online frontend within 1e-5 on poses and
1e-4 on the latest map's values (tests/test_replay.py:92-121); the JAX
runner, whose frontend runs its Pallas kernels in interpret mode, within
1e-3 on poses (tests/test_torch_slice.py:35).
"""

import numpy as np
import pytest
import torch

from my_lidar_graph_slam_tpu.io import synth as jsynth
from my_lidar_graph_slam_tpu.models import replay as jreplay
from my_lidar_graph_slam_tpu_torch.io import synth as tsynth
from my_lidar_graph_slam_tpu_torch.models import loop_closure as tlc
from my_lidar_graph_slam_tpu_torch.models import map_builder as tmb
from my_lidar_graph_slam_tpu_torch.models import optimizer_host as tlm
from my_lidar_graph_slam_tpu_torch.models import replay as treplay
from my_lidar_graph_slam_tpu_torch.models import slam as tslam
from my_lidar_graph_slam_tpu_torch.models.pose_graph import PoseGraph
from my_lidar_graph_slam_tpu_torch.models.scan_matchers import \
    CorrelativeMatcher
from my_lidar_graph_slam_tpu_torch.ops import grid as tgrid
from tests.test_replay import build_slam as jax_build_slam
from tests.test_torch_matcher import one_torch_thread  # noqa: F401

CORRIDOR = dict(step=0.3, max_range=10.0, seed=3)


def corridor_waypoints():
    return jsynth.rotate_points(np.array([[-8.5, -5.0], [-1.5, -5.0]]),
                                jsynth.WORLD_ROTATION)


def build_slam(initial_pose=None):
    """The port's counterpart of tests/test_replay.py::build_slam."""
    builder = tmb.GridMapBuilder(tmb.MapBuilderConfig(
        resolution=0.05, local_map_size=512, latest_map_size=256,
        num_scans_for_latest_map=5, travel_dist_threshold=6.0,
        usable_range_max=10.0, max_ray_steps=256),
        tmb.ScanStore(beam_capacity=256), device="cpu")
    matcher = CorrelativeMatcher(scan_range_max=10.0, usable_range_max=10.0)
    fe_cfg = tslam.FrontendConfig(loop_detection_interval=5)
    if initial_pose is not None:
        fe_cfg.initial_pose = np.asarray(initial_pose, np.float64)
    return tslam.LidarGraphSlam(tslam.Frontend(fe_cfg, matcher), None,
                                builder, PoseGraph())


def mini_slam(gt0):
    """tests/test_replay.py::_mini_slam on the port."""
    builder = tmb.GridMapBuilder(tmb.MapBuilderConfig(
        resolution=0.1, local_map_size=256, latest_map_size=192,
        num_scans_for_latest_map=5, travel_dist_threshold=6.0,
        usable_range_max=8.0, max_ray_steps=128),
        tmb.ScanStore(beam_capacity=256), device="cpu")
    matcher = CorrelativeMatcher(scan_range_max=8.0, usable_range_max=8.0)
    fe_cfg = tslam.FrontendConfig(loop_detection_interval=5)
    fe_cfg.initial_pose = np.asarray(gt0, np.float64)
    fe_cfg.update_threshold_angle = 0.3
    det = tlc.LoopDetectorBranchBound(
        score_threshold=0.5, node_height_max=4, range_x=2.0, range_y=2.0,
        range_theta=0.5, scan_range_max=8.0, usable_range_max=8.0)
    backend = tslam.Backend(
        tlc.LoopSearcherNearest(travel_dist_threshold=5.0,
                                node_dist_max=3.0, num_candidate_nodes=2),
        det, tlm.LMConfig(max_iterations=10))
    return tslam.LidarGraphSlam(tslam.Frontend(fe_cfg, matcher), backend,
                                builder, PoseGraph())


@pytest.fixture(scope="module")
def corridor():
    """The corridor log of tests/test_replay.py, simulated by each package
    from the same world, route and seed."""
    wps = corridor_waypoints()
    js, jgt = jsynth.simulate(waypoints=wps,
                              config=jsynth.SimConfig(**CORRIDOR))
    ts, tgt = tsynth.simulate(jsynth.default_world(), wps,
                              tsynth.SimConfig(**CORRIDOR))
    np.testing.assert_array_equal(tgt, jgt)
    return js, ts


def _run_replay(scans, chunk):
    s = build_slam()
    treplay.ReplayRunner(s, chunk=chunk).run(scans)
    return s


@pytest.fixture(scope="module")
def replay_runs(corridor):
    _, scans = corridor
    return _run_replay(scans, 1), _run_replay(scans, 4)


def test_precompute_keyframes_matches_jax(corridor):
    js, ts = corridor
    jcfg = jax_build_slam().frontend.config
    ref = jreplay.precompute_keyframes(js, jcfg)
    got = treplay.precompute_keyframes(ts, build_slam().frontend.config)
    assert len(got) == len(ref) > 5
    for a, b in zip(got, ref):
        assert a.notify == b.notify
        np.testing.assert_array_equal(a.odom_pose, b.odom_pose)
        np.testing.assert_array_equal(a.rel_from_update, b.rel_from_update)
        assert a.scan.timestamp == b.scan.timestamp
        np.testing.assert_array_equal(a.scan.ranges, b.scan.ranges)


def test_precompute_keyframes_matches_online_gate(corridor):
    _, scans = corridor
    s = build_slam()
    picked = [i for i, scan in enumerate(scans)
              if s.process_scan(scan, scan.odom_pose)]
    kfs = treplay.precompute_keyframes(scans, s.frontend.config)
    assert len(picked) == len(kfs)
    for i, kf in zip(picked, kfs):
        np.testing.assert_array_equal(kf.odom_pose, scans[i].odom_pose)


def test_replay_chunk_invariance(replay_runs):
    a, b = replay_runs
    assert a.graph.num_nodes == b.graph.num_nodes
    np.testing.assert_allclose(a.graph.node_poses(), b.graph.node_poses(),
                               rtol=0, atol=1e-5)
    assert [(m.node_idx_min, m.node_idx_max) for m in a.builder.local_maps] \
        == [(m.node_idx_min, m.node_idx_max) for m in b.builder.local_maps]


def test_replay_matches_online_frontend(corridor, replay_runs):
    _, scans = corridor
    online = build_slam()
    for scan in scans:
        online.process_scan(scan, scan.odom_pose)
    _, replay = replay_runs
    assert replay.graph.num_nodes == online.graph.num_nodes
    assert replay.graph.num_edges == online.graph.num_edges
    np.testing.assert_allclose(replay.graph.node_poses(),
                               online.graph.node_poses(), rtol=0, atol=1e-5)
    assert [(m.node_idx_min, m.node_idx_max)
            for m in replay.builder.local_maps] == \
        [(m.node_idx_min, m.node_idx_max) for m in online.builder.local_maps]
    np.testing.assert_allclose(
        tgrid.values(replay.builder.latest_map).numpy(),
        tgrid.values(online.builder.latest_map).numpy(), rtol=0, atol=1e-4)
    for lr, lo in zip(replay.builder.local_maps, online.builder.local_maps):
        np.testing.assert_allclose(lr.grid.log_odds.numpy(),
                                   lo.grid.log_odds.numpy(), atol=1e-4)


def test_replay_matches_jax_replay(corridor, replay_runs):
    js, _ = corridor
    j = jax_build_slam()
    jreplay.ReplayRunner(j, chunk=4).run(js)
    _, t = replay_runs
    assert t.graph.num_nodes == j.graph.num_nodes
    np.testing.assert_allclose(t.graph.node_poses(), j.graph.node_poses(),
                               rtol=0, atol=1e-3)
    assert len(t.builder.local_maps) == len(j.builder.local_maps)


def test_replay_chunk_reads_the_device_once(corridor, monkeypatch):
    """Nothing inside a chunk reads a device value on the host: no
    ``.item()``, ``.cpu()``, ``.numpy()``, ``.tolist()``, no Python
    branch on a tensor and no ``nonzero``; the runner then reads the
    chunk's packed result with exactly one ``.cpu()``."""
    _, scans = corridor
    s = build_slam()
    runner = treplay.ReplayRunner(s, chunk=4)
    names = ("cpu", "item", "numpy", "tolist", "nonzero", "__bool__",
             "__float__", "__int__", "__index__")
    calls = {n: 0 for n in names}
    for n in names:
        orig = getattr(torch.Tensor, n)

        def counted(self, *a, _n=n, _orig=orig, **kw):
            calls[_n] += 1
            return _orig(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, n, counted)

    inner = {}
    chunk_fn = treplay.replay_chunk

    def replay_chunk(*a, **kw):
        before = dict(calls)
        out = chunk_fn(*a, **kw)
        inner.update({n: calls[n] - before[n] for n in names})
        return out
    monkeypatch.setattr(treplay, "replay_chunk", replay_chunk)

    kfs = treplay.precompute_keyframes(scans, s.frontend.config)
    s.append_first_node(s.frontend.config.initial_pose, kfs[0].scan)
    s.update_grid_map()
    for n in names:
        calls[n] = 0
    runner._run_chunk(kfs[1:5])
    assert inner == {n: 0 for n in names}
    assert calls["cpu"] == 1
    assert sum(calls.values()) - calls["cpu"] - calls["numpy"] == 0


def test_replay_with_loop_closure():
    """Mini-world lap + revisit (tests/test_replay.py:148-177): replay's
    chunk-boundary passes with the window search close loops."""
    scans, gt = tsynth.simulate(
        jsynth.mini_world(), jsynth.mini_loop_waypoints(),
        tsynth.SimConfig(step=0.25, max_range=8.0, seed=4))
    s = mini_slam(gt[0])
    treplay.ReplayRunner(s, chunk=8).run(scans)
    assert s.backend.num_loop_closures >= 2
    assert s.graph.num_edges > s.graph.num_nodes - 1
    kfs = treplay.precompute_keyframes(scans, s.frontend.config)
    times = np.array([kf.scan.timestamp for kf in kfs])
    gt_times = np.array([sc.timestamp for sc in scans])
    idx = np.searchsorted(gt_times, times)
    err = s.graph.node_poses()[:, :2] - gt[idx][:, :2]
    assert float(np.sqrt((err ** 2).sum(axis=1).mean())) < 0.35
