"""Parity of the port's sweep matcher and loop detector with the JAX
package's Pallas MXU paths (interpret mode), on the CPU.

The JAX side builds the map and the pose graph; ``interop.py`` hands them
to the port as NumPy arrays, so both compute on the same state.
Tolerances as tests/test_pallas_mxu.py:185-195: poses atol 1e-5, score
rtol 1e-5, covariance rtol 1e-3 / atol 1e-6.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from my_lidar_graph_slam_tpu.io import synth as jsynth
from my_lidar_graph_slam_tpu.models import loop_closure as jlc
from my_lidar_graph_slam_tpu.models import map_builder as jmb
from my_lidar_graph_slam_tpu.models.pose_graph import PoseGraph as JGraph
from my_lidar_graph_slam_tpu.ops import grid as jgrid
from my_lidar_graph_slam_tpu.ops import matchers as jmatchers
from my_lidar_graph_slam_tpu.ops import matchers_mxu, raycast as jraycast
from my_lidar_graph_slam_tpu.sensor.data import RawScan as JRawScan
from my_lidar_graph_slam_tpu_torch import interop
from my_lidar_graph_slam_tpu_torch.models import loop_closure as tlc
from my_lidar_graph_slam_tpu_torch.models import map_builder as tmb
from my_lidar_graph_slam_tpu_torch.ops import grid as tgrid
from my_lidar_graph_slam_tpu_torch.ops import matchers as tmatchers
from my_lidar_graph_slam_tpu_torch.ops import matchers_sweep

RES = 0.05


@pytest.fixture(scope="module")
def match_scene():
    """The scene of test_pallas_mxu.py::
    test_correlative_match_mxu_equals_brute_batch."""
    segs = jsynth.default_world()
    beam = np.linspace(-np.pi / 2, np.pi / 2, 181)
    nbcap = 192
    g = jgrid.empty(512, 512, RES, center=np.zeros(2))
    rng = np.random.default_rng(0)

    def scan_at(p):
        r = jsynth.raycast_segments(p[:2], p[2] + beam, segs, 12.0)
        ranges = np.zeros(nbcap, np.float32)
        angles = np.zeros(nbcap, np.float32)
        valid = np.zeros(nbcap, bool)
        ranges[:181] = r
        angles[:181] = beam
        valid[:181] = True
        return ranges, angles, valid

    for _ in range(3):
        p = np.concatenate([rng.uniform(-0.3, 0.3, 2),
                            rng.uniform(-0.2, 0.2, 1)])
        r, a, v = scan_at(p)
        g = jraycast.integrate_scan(
            g, jnp.asarray(p, jnp.float32), jnp.asarray(r), jnp.asarray(a),
            jnp.asarray(v), 0.01, 12.0, max_steps=256)
    qn = 4
    ips, rs, as_, vs = [], [], [], []
    for _ in range(qn):
        p = np.concatenate([rng.uniform(-0.15, 0.15, 2),
                            rng.uniform(-0.1, 0.1, 1)])
        r, a, v = scan_at(p)
        ips.append((p + rng.uniform(-0.05, 0.05, 3)).astype(np.float32))
        rs.append(r)
        as_.append(a)
        vs.append(v)
    return g, dict(ip=np.stack(ips), r=np.stack(rs), a=np.stack(as_),
                   v=np.stack(vs), qn=qn)


def _port_args(s):
    qn = s["qn"]
    return dict(
        ranges=torch.from_numpy(s["r"]), angles=torch.from_numpy(s["a"]),
        valid=torch.from_numpy(s["v"]),
        scan_min_range=torch.zeros(qn),
        scan_max_range=torch.full((qn,), 12.0),
        rel_sensor_poses=torch.zeros((qn, 3)))


def test_sweep_lattice_matches_jax(match_scene):
    """The float32 theta step (acos near 1) and the hit cells over the
    ordered lattice, before any score is compared.

    XLA's float32 acos is not torch's (nor is it stable between XLA's own
    eager and jitted programs): near 1 the two can differ in the last bit.
    So the step is held to 2 ulp and the hit cells to one cell, with at
    most 1e-4 of them moved; the matcher tests below then hold the scores
    and poses.
    """
    g, s = match_scene
    tg = interop.grid_from_numpy(g.log_odds, g.observed, g.origin, RES,
                                 "cpu")
    max_range = np.max(np.where(s["v"], s["r"], -np.inf), axis=-1)
    max_range = np.minimum(max_range, 12.0).astype(np.float32)
    step_j = np.asarray(jmatchers.search_step_theta(
        g.resolution, jnp.asarray(max_range)))
    step_t = tmatchers.search_step_theta(tgrid.scalar(RES, "cpu"),
                                         torch.from_numpy(max_range))
    np.testing.assert_allclose(step_t.numpy(), step_j, rtol=2.5e-7)

    win_t = jmatchers.static_max_theta_window(RES, 12.0, 0.3)
    sensor = torch.from_numpy(s["ip"])
    ix, iy = matchers_sweep.hit_cells(tg, sensor, torch.from_numpy(s["r"]),
                                      torch.from_numpy(s["a"]), step_t,
                                      win_t)
    # The JAX package's lattice (matchers_mxu.py:226-243).
    st_ = jnp.asarray(s["ip"][:, 2])
    t_idx = jnp.arange(2 * win_t + 1) - win_t
    c0 = jnp.cos(st_[:, None] + s["a"])
    s0 = jnp.sin(st_[:, None] + s["a"])
    dt = t_idx[None, :].astype(jnp.float32) * jnp.asarray(step_j)[:, None]
    ct, st2 = jnp.cos(dt)[:, :, None], jnp.sin(dt)[:, :, None]
    hx = s["ip"][:, 0, None, None] + s["r"][:, None, :] * (
        c0[:, None, :] * ct - s0[:, None, :] * st2)
    hy = s["ip"][:, 1, None, None] + s["r"][:, None, :] * (
        s0[:, None, :] * ct + c0[:, None, :] * st2)
    jix = np.asarray(jnp.floor((hx - g.origin[0]) / g.resolution)
                     ).astype(np.int32)
    jiy = np.asarray(jnp.floor((hy - g.origin[1]) / g.resolution)
                     ).astype(np.int32)
    for got, ref in ((ix.numpy(), jix), (iy.numpy(), jiy)):
        assert np.abs(got - ref).max() <= 1
        assert (got != ref).mean() <= 1e-4


@pytest.mark.parametrize("score_gate", ["correlative", "pixel_accurate"])
def test_sweep_matcher_matches_mxu_batch(match_scene, score_gate):
    g, s = match_scene
    qn = s["qn"]
    vals = jgrid.values(g)
    win = 2
    win_t = jmatchers.static_max_theta_window(RES, 12.0, 0.3)
    ref = matchers_mxu.correlative_match_mxu_batch(
        vals, matchers_mxu.make_tiles(vals), g, jnp.asarray(s["ip"]),
        jnp.asarray(s["r"]), jnp.asarray(s["a"]), jnp.asarray(s["v"]),
        jnp.zeros(qn, jnp.float32), jnp.full(qn, 12.0, jnp.float32),
        jnp.zeros((qn, 3), jnp.float32),
        jnp.asarray(12.0, jnp.float32), jnp.asarray(0.3, jnp.float32),
        jnp.asarray(0.01, jnp.float32), jnp.asarray(12.0, jnp.float32),
        jnp.asarray(0.0, jnp.float32), jnp.full(qn, 181.0, jnp.float32),
        win_x=win, win_y=win, win_theta_max=win_t, interpret=True,
        score_gate=score_gate)

    tg = interop.grid_from_numpy(g.log_odds, g.observed, g.origin, RES,
                                 "cpu")
    got = matchers_sweep.correlative_match_sweep(
        tgrid.values(tg), tg, torch.from_numpy(s["ip"]),
        **_port_args(s), scan_range_max=12.0, range_theta=0.3,
        usable_range_min=0.01, usable_range_max=12.0,
        normalized_score_threshold=0.0,
        num_total_beams=torch.full((qn,), 181.0),
        win_x=win, win_y=win, win_theta_max=win_t, score_gate=score_gate)

    np.testing.assert_array_equal(got.pose_found.numpy(),
                                  np.asarray(ref.pose_found))
    np.testing.assert_allclose(got.estimated_pose.numpy(),
                               np.asarray(ref.estimated_pose), atol=1e-5)
    np.testing.assert_allclose(got.normalized_score.numpy(),
                               np.asarray(ref.normalized_score), rtol=1e-5)
    np.testing.assert_allclose(got.normalized_cost.numpy(),
                               np.asarray(ref.normalized_cost), rtol=1e-5)
    np.testing.assert_allclose(got.covariance.numpy(),
                               np.asarray(ref.covariance),
                               rtol=1e-3, atol=1e-6)


# --------------------------------------------------------------------------
# Loop detector
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def loop_scene():
    """A finished JAX local map + a pose graph whose last nodes revisit it
    (tests/test_loop_detectors.py::loop_scene), and the same state handed
    to the port through ``interop``."""
    segs = jsynth.default_world()
    beam = np.linspace(-np.pi / 2, np.pi / 2, 181)
    store = jmb.ScanStore(beam_capacity=256)
    cfg = jmb.MapBuilderConfig(
        resolution=RES, local_map_size=640, latest_map_size=512,
        travel_dist_threshold=2.0, usable_range_max=12.0, max_ray_steps=256)
    builder = jmb.GridMapBuilder(cfg, store)
    graph = JGraph()
    base = jsynth.rotate_points(np.array([[-8.5, -5.0]]),
                                jsynth.WORLD_ROTATION)[0]
    heading = jsynth.WORLD_ROTATION

    def add(pose, ts):
        r = jsynth.raycast_segments(pose[:2], pose[2] + beam, segs, 12.0)
        sid = store.append(JRawScan(
            sensor_id="FLASER", timestamp=ts, odom_pose=pose.copy(),
            velocity=np.zeros(3), rel_sensor_pose=np.zeros(3),
            min_range=0.0, max_range=12.0, min_angle=float(beam[0]),
            max_angle=float(beam[-1]), angles=beam.copy(), ranges=r))
        graph.append_node(pose, sid)
        builder.append_scan(graph)

    t = 0.0
    for k in range(14):
        add(np.array([base[0] + 0.35 * k * np.cos(heading),
                      base[1] + 0.35 * k * np.sin(heading), heading]), t)
        t += 0.1
    for k in range(3):
        add(np.array([base[0] + (0.30 + 0.35 * k) * np.cos(heading),
                      base[1] + (0.30 + 0.35 * k) * np.sin(heading),
                      heading + 0.015]), t)
        t += 0.1
    assert builder.local_maps[0].finished

    n = store.count
    tstore = interop.scan_store_from_arrays(
        store.ranges[:n], store.angles[:n], store.valid[:n],
        store.min_range[:n], store.max_range[:n], store.rel_sensor_pose[:n],
        store.raw_beams[:n], store.timestamps[:n])
    tgraph = interop.pose_graph_from_arrays(
        graph.poses[:graph.num_nodes], graph.scan_ids[:graph.num_nodes],
        graph.edge_i[:graph.num_edges], graph.edge_j[:graph.num_edges],
        graph.edge_rel[:graph.num_edges], graph.edge_info[:graph.num_edges])
    tbuilder = tmb.GridMapBuilder(tmb.MapBuilderConfig(**vars(cfg)), tstore,
                                 device="cpu")
    interop.set_local_maps(tbuilder, [dict(
        log_odds=np.asarray(lm.grid.log_odds),
        observed=np.asarray(lm.grid.observed),
        origin=np.asarray(lm.grid.origin),
        node_idx_min=lm.node_idx_min, node_idx_max=lm.node_idx_max,
        finished=lm.finished, built_poses=lm.built_poses)
        for lm in builder.local_maps], builder.accum_travel_dist)
    return builder, graph, tbuilder, tgraph


@pytest.mark.parametrize("kw", [
    dict(score_threshold=0.45, range_x=1.0, range_y=1.0, range_theta=0.25,
         scan_range_max=12.0, usable_range_max=12.0),
    dict(score_threshold=0.3, range_x=1.0, range_y=1.0, range_theta=0.25,
         scan_range_max=12.0, usable_range_min=0.5, usable_range_max=9.0),
], ids=["default-gate", "usable-gate"])
def test_detector_matches_mxu_detector(loop_scene, kw):
    builder, graph, tbuilder, tgraph = loop_scene
    last = graph.num_nodes - 1
    cand = dict(node_indices=[last - 2, last - 1, last], local_map_idx=0,
                local_map_node_idx=1)
    ref = jlc.LoopDetectorBranchBound(
        node_height_max=5, use_mxu=True, mxu_interpret=True, **kw).detect(
        graph, builder, [jlc.LoopCandidate(**cand)])
    got = tlc.LoopDetectorBranchBound(node_height_max=5, **kw).detect(
        tgraph, tbuilder, [tlc.LoopCandidate(**cand)])
    assert len(ref) >= 1
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert (a.start_node_idx, a.end_node_idx) == \
            (b.start_node_idx, b.end_node_idx)
        np.testing.assert_allclose(a.relative_pose, b.relative_pose,
                                   atol=1e-5)
        np.testing.assert_allclose(a.covariance, b.covariance,
                                   rtol=1e-3, atol=1e-6)


def test_searcher_matches_jax(loop_scene):
    builder, graph, tbuilder, tgraph = loop_scene
    kw = dict(travel_dist_threshold=1.0, node_dist_max=3.0,
              num_candidate_nodes=2)
    ref = jlc.LoopSearcherNearest(**kw).search(graph, builder)
    got = tlc.LoopSearcherNearest(**kw).search(tgraph, tbuilder)
    assert len(ref) == len(got) >= 1
    for a, b in zip(got, ref):
        assert vars(a) == vars(b)


def test_detector_refuses_several_candidates(loop_scene):
    _, graph, tbuilder, tgraph = loop_scene
    last = graph.num_nodes - 1
    cand = tlc.LoopCandidate(node_indices=[last], local_map_idx=0,
                             local_map_node_idx=1)
    with pytest.raises(NotImplementedError):
        tlc.LoopDetectorBranchBound().detect(tgraph, tbuilder, [cand, cand])


def test_rebuild_matches_jax(loop_scene):
    """after_loop_closure's stacked rebuild of moved local maps, the latest
    map and the global map equal the JAX package's on the same moved
    poses."""
    builder, graph, tbuilder, tgraph = loop_scene
    jb, jg = copy.deepcopy(builder), copy.deepcopy(graph)
    tb, tg = copy.deepcopy(tbuilder), copy.deepcopy(tgraph)
    rng = np.random.default_rng(11)
    shift = rng.normal(0.0, 0.05, (graph.num_nodes, 3))
    jg.poses[:graph.num_nodes] += shift
    tg.poses[:graph.num_nodes] += shift
    jb.after_loop_closure(jg)
    tb.after_loop_closure(tg)
    for a, b in zip(tb.local_maps, jb.local_maps):
        np.testing.assert_array_equal(a.grid.origin.numpy(),
                                      np.asarray(b.grid.origin))
        np.testing.assert_allclose(a.grid.log_odds.numpy(),
                                   np.asarray(b.grid.log_odds), atol=1e-5)
        np.testing.assert_array_equal(a.grid.observed.numpy(),
                                      np.asarray(b.grid.observed))
    np.testing.assert_allclose(tb.latest_map.log_odds.numpy(),
                               np.asarray(jb.latest_map.log_odds), atol=1e-5)
    assert tb.accum_travel_dist == pytest.approx(jb.accum_travel_dist)

    jglob = jb.construct_global_map(jg)
    tglob = tb.construct_global_map(tg)
    np.testing.assert_array_equal(tglob.origin.numpy(),
                                  np.asarray(jglob.origin))
    np.testing.assert_allclose(tglob.log_odds.numpy(),
                               np.asarray(jglob.log_odds), atol=1e-5)
