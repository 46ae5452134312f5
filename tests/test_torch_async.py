"""The port's pipelined (async) online frontend on the CPU: against its
own blocking frontend (the tolerances of tests/test_async_frontend.py:
poses 1e-5, latest-map values 1e-4) and against the JAX package's async
frontend, whose matcher runs its Pallas kernels in interpret mode (poses
1e-3, as tests/test_torch_slice.py:35)."""

import numpy as np

from my_lidar_graph_slam_tpu.io import synth as jsynth
from my_lidar_graph_slam_tpu_torch.io import synth as tsynth
from my_lidar_graph_slam_tpu_torch.models import scan_matchers
from my_lidar_graph_slam_tpu_torch.ops import grid as tgrid
from tests.test_replay import build_slam as jax_build_slam
from tests.test_torch_matcher import one_torch_thread  # noqa: F401
from tests.test_torch_replay import (CORRIDOR, build_slam,
                                     corridor_waypoints, mini_slam)


def _drive(s, scans):
    for scan in scans:
        s.process_scan(scan, scan.odom_pose)
    s.frontend.flush(s)
    return s


def _async(s):
    s.frontend.async_pipeline = True
    return s


def test_async_matches_blocking_frontend():
    scans, _ = tsynth.simulate(jsynth.default_world(), corridor_waypoints(),
                               tsynth.SimConfig(**CORRIDOR))
    blocking = _drive(build_slam(), scans)
    pipelined = _drive(_async(build_slam()), scans)
    assert pipelined.graph.num_nodes == blocking.graph.num_nodes
    assert pipelined.graph.num_edges == blocking.graph.num_edges
    np.testing.assert_allclose(pipelined.graph.node_poses(),
                               blocking.graph.node_poses(), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(
        tgrid.values(pipelined.builder.latest_map).numpy(),
        tgrid.values(blocking.builder.latest_map).numpy(), rtol=0, atol=1e-4)


def test_async_matches_jax_async():
    wps = corridor_waypoints()
    js, _ = jsynth.simulate(waypoints=wps,
                            config=jsynth.SimConfig(**CORRIDOR))
    ts, _ = tsynth.simulate(jsynth.default_world(), wps,
                            tsynth.SimConfig(**CORRIDOR))
    j = _drive(_async(jax_build_slam()), js)
    t = _drive(_async(build_slam()), ts)
    assert t.graph.num_nodes == j.graph.num_nodes
    assert t.graph.num_edges == j.graph.num_edges
    np.testing.assert_allclose(t.graph.node_poses(), j.graph.node_poses(),
                               rtol=0, atol=1e-3)


def test_async_keeps_one_match_pending_and_flush_lands_it():
    """A keyframe's match stays pending until the next keyframe (the graph
    lags one node); ``stop_backend`` lands the last one."""
    scans, _ = tsynth.simulate(jsynth.default_world(), corridor_waypoints(),
                               tsynth.SimConfig(**CORRIDOR))
    s = _async(build_slam())
    for scan in scans:
        s.process_scan(scan, scan.odom_pose)
    assert isinstance(s.frontend._pending[1], scan_matchers.PendingMatch)
    assert s.graph.num_nodes == s.process_count - 1
    s.stop_backend()
    assert s.frontend._pending is None
    assert s.graph.num_nodes == s.process_count


def test_async_with_loop_closure_mini_world():
    """With a synchronous backend the async graph lags one keyframe at
    notify time; closures still fire (tests/test_async_frontend.py:45-73).
    """
    scans, gt = tsynth.simulate(
        jsynth.mini_world(), jsynth.mini_loop_waypoints(),
        tsynth.SimConfig(step=0.25, max_range=8.0, seed=4))

    def ate(s):
        times = s.scans.timestamps[s.graph.scan_ids[:s.graph.num_nodes]]
        idx = np.searchsorted(np.array([sc.timestamp for sc in scans]),
                              times)
        err = s.graph.node_poses()[:, :2] - gt[idx][:, :2]
        return float(np.sqrt((err ** 2).sum(axis=1).mean()))

    blocking = _drive(mini_slam(gt[0]), scans)
    s = _drive(_async(mini_slam(gt[0])), scans)
    assert s.backend.num_loop_closures >= 1
    assert ate(s) < max(1.3 * ate(blocking), 0.3)
