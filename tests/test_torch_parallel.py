"""The port's parallel layer against the JAX package's, on the CPU.

JAX runs on the conftest's 8 faked CPU devices; the port on a mesh of 8
CPU shards in one process (``parallel/mesh.py::make_mesh(8,
device="cpu")``). Graphs and scenes are those of tests/test_parallel.py
and tests/test_e2e.py, built by the JAX package from its seeds and handed
to the port as the same NumPy arrays (``interop`` for maps and scans).

Tolerances are the JAX tests' own, with the largest error seen in a CPU
run in brackets:
- ``partition_graph_by_nodes``: every array equal, dtype and values;
- ``optimize_sharded`` against JAX's and the port's one-device solve:
  poses atol 2e-3 [2.4e-7 and 0], total error rtol 1e-2
  (tests/test_parallel.py:27-30);
- ``optimize_sharded_nodes`` against JAX's and the port's one-device
  solve: x and y atol 0.02 m [7.2e-7], both within 0.3 m of the ground
  truth (tests/test_parallel.py:145-147);
- ``branch_bound_fanout``: found flags equal, poses atol 1e-4, scores
  rtol 1e-5 (test_parallel.py:117-118 holds the fan-out to the single
  match at 1e-4);
- the fan-out detector on the JAX run's states: the same (start, end)
  keys and relative poses atol 1e-3 (tests/test_e2e.py:223-227).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from my_lidar_graph_slam_tpu.io import synth as jsynth
from my_lidar_graph_slam_tpu.models import loop_closure as jlc
from my_lidar_graph_slam_tpu.models import optimizer_lm as jlm
from my_lidar_graph_slam_tpu.ops import grid as jgrid
from my_lidar_graph_slam_tpu.ops import matchers as jmatchers
from my_lidar_graph_slam_tpu.ops import pyramid as jpyramid
from my_lidar_graph_slam_tpu.ops import raycast as jraycast
from my_lidar_graph_slam_tpu.parallel import distributed as jdist
from my_lidar_graph_slam_tpu.parallel import mesh as jmesh
from my_lidar_graph_slam_tpu_torch import interop
from my_lidar_graph_slam_tpu_torch.io import synth as tsynth
from my_lidar_graph_slam_tpu_torch.models import loop_closure as tlc
from my_lidar_graph_slam_tpu_torch.models import map_builder as tmb
from my_lidar_graph_slam_tpu_torch.models import optimizer_host as thost
from my_lidar_graph_slam_tpu_torch.models import optimizer_lm as tlm
from my_lidar_graph_slam_tpu_torch.models import slam as tslam
from my_lidar_graph_slam_tpu_torch.models.pose_graph import (
    GraphArrays as TArrays)
from my_lidar_graph_slam_tpu_torch.ops import grid as tgrid
from my_lidar_graph_slam_tpu_torch.ops import matchers as tmatchers
from my_lidar_graph_slam_tpu_torch.ops import pyramid as tpyramid
from my_lidar_graph_slam_tpu_torch.parallel import distributed as tdist
from my_lidar_graph_slam_tpu_torch.parallel import mesh as tmesh
from my_lidar_graph_slam_tpu_torch.parallel import multihost as tmh
from my_lidar_graph_slam_tpu_torch.utils.metrics import MetricManager
from tests.test_e2e import build_slam
from tests.test_optimizer import make_noisy_loop
from tests.test_torch_matcher import one_torch_thread  # noqa: F401


def _port(snap) -> TArrays:
    return TArrays(*(np.asarray(a) for a in snap))


def cpu_mesh(n=8):
    return tmesh.make_mesh(n, axis="shard", device="cpu")


# --------------------------------------------------------------------------
# The mesh
# --------------------------------------------------------------------------


def test_make_mesh_shapes_and_counts():
    m = cpu_mesh()
    assert m.shape == {"shard": 8}
    assert int(np.prod(list(m.shape.values()))) == 8
    assert m.devices == (torch.device("cpu"),) * 8
    assert list(m.local_shards) == list(range(8))
    assert m.group is None
    assert tmesh.make_mesh(device="cpu").num_shards == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tmesh.make_mesh(1)
    else:
        with pytest.raises(ValueError):
            tmesh.make_mesh(torch.cuda.device_count() + 1)
    parts = [torch.full((2,), float(s)) for s in range(8)]
    total = tmesh.psum(m, parts)
    assert len(total) == 8 and all(t.tolist() == [28.0, 28.0]
                                   for t in total)
    assert (m.psum_calls, m.psum_bytes) == (1, 8)


def test_host_arrays_place_and_fetch_back():
    m = cpu_mesh(4)
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    sharded = tmh.host_local_to_global(m, "shard", x)
    assert [s.shape[0] for s in sharded.shards] == [2] * 4
    np.testing.assert_array_equal(tmh.fetch_global(sharded), x)
    rep = tmh.replicate(m, (x, x[:1]))
    assert all(len(r.shards) == 4 for r in rep)
    np.testing.assert_array_equal(tmh.fetch_global(rep[1]), x[:1])
    graph, _ = make_noisy_loop(n=24)
    with pytest.raises(ValueError):
        tmh.shard_edges_global(cpu_mesh(5), "shard",
                               _port(graph.snapshot(edge_cap=64)))


# --------------------------------------------------------------------------
# Solvers
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ring96():
    """tests/test_parallel.py:122-151's graph: the 96-node noisy loop in
    a snapshot of 128 nodes and 128 edges."""
    graph, gt = make_noisy_loop(n=96, drift=0.02)
    return graph, gt, graph.snapshot(node_cap=128, edge_cap=128)


@pytest.mark.parametrize("graph_name,d", [("ring96", 8), ("synth_ring", 3)])
def test_partition_graph_by_nodes_matches_jax(ring96, graph_name, d):
    if graph_name == "ring96":
        snap = ring96[2]
    else:       # 4 loop edges, 3 blocks of a 256-node capacity
        snap, _ = tsynth.ring_graph(200, seed=0, n_loops=4)
        snap = snap.snapshot(node_cap=256, edge_cap=512)
    ref = jdist.partition_graph_by_nodes(snap, d)
    got = tdist.partition_graph_by_nodes(_port(snap), d)
    for field in ref._fields:
        a, b = np.asarray(getattr(ref, field)), getattr(got, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(b, a, err_msg=field)
    assert tdist.psum_bytes_per_cg_step(got) == \
        jdist.psum_bytes_per_cg_step(ref)


def test_pair_errors_and_jacobians_match_jax(ring96):
    snap = ring96[2]
    pi = snap.poses[snap.edge_i[:95]].astype(np.float32)
    pj = snap.poses[snap.edge_j[:95]].astype(np.float32)
    rel = snap.edge_rel[:95]
    np.testing.assert_allclose(
        tlm.pair_errors(*map(torch.from_numpy, (pi, pj, rel))).numpy(),
        np.asarray(jdist._pair_errors(pi, pj, rel)), rtol=0, atol=1e-5)
    for got, ref in zip(tlm.pair_jacobians(torch.from_numpy(pi),
                                           torch.from_numpy(pj)),
                        jdist._pair_jacobians(pi, pj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-5)


def test_optimize_sharded_matches_jax():
    """tests/test_parallel.py::test_sharded_optimizer_matches_single_
    device on both packages."""
    graph, _ = make_noisy_loop(n=24, drift=0.03, seed=0)
    arrays = graph.snapshot(edge_cap=64)   # 25 edges, 8 | 64
    cfg = jlm.LMConfig(solver="cg", max_iterations=15, loss_name="Squared")
    tcfg = tlm.LMConfig(**vars(cfg))
    ref = jdist.optimize_sharded(arrays, cfg, jmesh.make_mesh(8))
    mesh = cpu_mesh()
    got = tdist.optimize_sharded(_port(arrays), tcfg, mesh)
    single = tlm.optimize(_port(arrays), tcfg, device="cpu")
    n = graph.num_nodes
    poses = tmh.fetch_global(got.poses)
    for other in (np.asarray(ref.poses), single.poses.numpy()):
        np.testing.assert_allclose(poses[:n], other[:n], rtol=0, atol=2e-3)
    np.testing.assert_allclose(float(got.total_error),
                               float(ref.total_error), rtol=1e-2)
    assert got.iterations == int(ref.iterations)
    # Four psums per LM step (b, diagonal, chain, error), one per CG
    # step.
    assert mesh.psum_calls >= 4 * got.iterations + got.cg_iterations
    with pytest.raises(ValueError):      # 64 edges over 5 shards
        tdist.optimize_sharded(_port(arrays), tcfg, cpu_mesh(5))


def test_optimize_sharded_nodes_matches_jax(ring96):
    """tests/test_parallel.py::test_optimize_sharded_nodes_matches_single_
    device on both packages."""
    graph, gt, arrays = ring96
    cfg = jlm.LMConfig(solver="cg", max_iterations=10, cg_max_iterations=64,
                       preconditioner="chain")
    tcfg = tlm.LMConfig(**vars(cfg))
    ref = jdist.optimize_sharded_nodes(
        jdist.partition_graph_by_nodes(arrays, 8), cfg, jmesh.make_mesh(8))
    mesh = cpu_mesh()
    sharded = tdist.partition_graph_by_nodes(_port(arrays), 8)
    got = tdist.optimize_sharded_nodes(sharded, tcfg, mesh)
    single = tlm.optimize(_port(arrays), tcfg, device="cpu")
    n = graph.num_nodes
    poses = tmh.fetch_global(got.poses)
    assert poses.shape == (128, 3)
    for other in (np.asarray(ref.poses), single.poses.numpy()):
        np.testing.assert_allclose(poses[:n, :2], other[:n, :2], rtol=0,
                                   atol=0.02)
    assert np.linalg.norm(poses[:n, :2] - gt[:, :2], axis=1).max() < 0.3
    assert got.iterations == int(ref.iterations)
    # Per CG step: the [C, 2, 3] endpoint exchange and three scalars (the
    # JAX count's two and the stopping test's residual).
    c = sharded.c_bi.shape[0]
    per_lm = 24 * c + 4 + 4 + (24 * c + 4)  # cross terms, rz0, rr0, error
    assert mesh.psum_bytes >= got.iterations * per_lm + \
        got.cg_iterations * (tdist.psum_bytes_per_cg_step(sharded) + 4)
    with pytest.raises(ValueError):
        tdist.optimize_sharded_nodes(sharded, tcfg, cpu_mesh(4))


# --------------------------------------------------------------------------
# The fan-out
# --------------------------------------------------------------------------


K_ROWS, NB, BEAMS = 8, 128, 91
FAN = dict(node_height_max=3, win_x=8, win_y=8, frontier_cap=2048)


@pytest.fixture(scope="module")
def fan_scene():
    """tests/test_parallel.py:33-78's scene: a 256^2 map from four scans
    and eight candidate rows at slightly offset poses, built by the JAX
    package; the port reads the same map through ``interop``."""
    res = 0.05
    segs = jsynth.default_world()
    beam = np.linspace(-np.pi / 2, np.pi / 2, BEAMS)

    def scan_arrays(p):
        r = jsynth.raycast_segments(p[:2], p[2] + beam, segs, 12.0)
        out = (np.zeros(NB, np.float32), np.zeros(NB, np.float32),
               np.zeros(NB, bool))
        out[0][:BEAMS], out[1][:BEAMS], out[2][:BEAMS] = r, beam, True
        return out

    base = jsynth.rotate_points(np.array([[-7.0, -5.0]]),
                                jsynth.WORLD_ROTATION)[0]
    g = jgrid.empty(256, 256, res, center=base)
    for k in range(4):
        p = np.array([base[0] + 0.2 * k, base[1], jsynth.WORLD_ROTATION])
        r, a, v = scan_arrays(p)
        g = jraycast.integrate_scan(
            g, jnp.asarray(p, jnp.float32), jnp.asarray(r), jnp.asarray(a),
            jnp.asarray(v), 0.01, 12.0, max_steps=128)
    rows = dict(poses=np.zeros((K_ROWS, 3), np.float32),
                ranges=np.zeros((K_ROWS, NB), np.float32),
                angles=np.zeros((K_ROWS, NB), np.float32),
                valid=np.zeros((K_ROWS, NB), bool))
    for i in range(K_ROWS):
        p = np.array([base[0] + 0.1 * i, base[1] + 0.02 * i,
                      jsynth.WORLD_ROTATION])
        rows["poses"][i] = p
        rows["ranges"][i], rows["angles"][i], rows["valid"][i] = \
            scan_arrays(p)
    tg = interop.grid_from_numpy(g.log_odds, g.observed, g.origin, res,
                                 device="cpu")
    win_t = jmatchers.static_max_theta_window(res, 12.0, 0.25)
    return g, tg, rows, win_t


def _scalars(k):
    return (np.zeros(k, np.float32), np.full(k, 12.0, np.float32),
            np.zeros((k, 3), np.float32), np.full(k, float(BEAMS),
                                                  np.float32))


SCALARS = dict(scan_range_max=12.0, range_theta=0.25, usable_range_min=0.01,
               usable_range_max=12.0, normalized_score_threshold=0.2)


def _same_rows(got, ref, rows=slice(None)):
    np.testing.assert_array_equal(got.pose_found, np.asarray(
        ref.pose_found)[rows])
    np.testing.assert_allclose(got.estimated_pose, np.asarray(
        ref.estimated_pose)[rows], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.normalized_score, np.asarray(
        ref.normalized_score)[rows], rtol=1e-5)


def test_branch_bound_fanout_matches_jax(fan_scene):
    g, tg, rows, win_t = fan_scene
    jpyr = jpyramid.build_pyramid(jgrid.values(g), 3)
    ref = jdist.branch_bound_fanout(
        jpyr, g, jnp.asarray(rows["poses"]), jnp.asarray(rows["ranges"]),
        jnp.asarray(rows["angles"]), jnp.asarray(rows["valid"]),
        *map(jnp.asarray, _scalars(K_ROWS)), mesh=jmesh.make_mesh(8),
        axis="shard", win_theta_max=win_t, **SCALARS, **FAN)
    tpyr = tpyramid.build_pyramid(tgrid.values(tg), 3)
    mesh = cpu_mesh()
    out = tdist.branch_bound_fanout(
        tpyr, tg, rows["poses"], rows["ranges"], rows["angles"],
        rows["valid"], *_scalars(K_ROWS), mesh=mesh, win_theta_max=win_t,
        **SCALARS, **FAN)
    got = tmh.fetch_global(out)
    assert got.pose_found.shape == (K_ROWS,) and got.pose_found.any()
    _same_rows(got, ref)
    # The port's own matcher on row 0 alone.
    one = tmatchers.branch_bound_match(
        tpyr, tg, *(torch.from_numpy(x[:1]) for x in (
            rows["poses"], rows["ranges"], rows["angles"], rows["valid"],
            *_scalars(K_ROWS)[:3])), num_total_beams=torch.from_numpy(
            _scalars(K_ROWS)[3][:1]), win_theta_max=win_t, **SCALARS, **FAN)
    _same_rows(tmatchers.MatchSummary(*(x[:1] for x in got)),
               tmh.fetch_global(one))
    with pytest.raises(ValueError):    # 8 rows over 3 shards
        tdist.branch_bound_fanout(
            tpyr, tg, rows["poses"], rows["ranges"], rows["angles"],
            rows["valid"], *_scalars(K_ROWS), mesh=cpu_mesh(3),
            win_theta_max=win_t, **SCALARS, **FAN)


def test_branch_bound_fanout_multi_stacks_two_maps(fan_scene):
    """M = 2: the second candidate reads the same map with its rows in
    reverse; each candidate equals its own single fan-out, and a padded
    (all-invalid) row is never found."""
    _, tg, rows, win_t = fan_scene
    tpyr = tpyramid.build_pyramid(tgrid.values(tg), 3)
    mesh = cpu_mesh(4)
    stacked = {k: np.stack([v, v[::-1]]) for k, v in rows.items()}
    stacked["valid"][1, -1] = False
    scal = [np.stack([s, s]) for s in _scalars(K_ROWS)]
    out = tmh.fetch_global(tdist.branch_bound_fanout_multi(
        [tpyr, tpyr], [tg, tg], stacked["poses"], stacked["ranges"],
        stacked["angles"], stacked["valid"], *scal, mesh=mesh,
        win_theta_max=win_t, **SCALARS, **FAN))
    assert out.estimated_pose.shape == (2, K_ROWS, 3)
    assert not out.pose_found[1, -1]
    for c in range(2):
        single = tmh.fetch_global(tdist.branch_bound_fanout(
            tpyr, tg, stacked["poses"][c], stacked["ranges"][c],
            stacked["angles"][c], stacked["valid"][c], *(s[c] for s in scal),
            mesh=mesh, win_theta_max=win_t, **SCALARS, **FAN))
        for a, b in zip(out, single):
            np.testing.assert_array_equal(a[c], b)


# --------------------------------------------------------------------------
# The fan-out detector and the mesh backend on the JAX run's states
# --------------------------------------------------------------------------


DET = dict(score_threshold=0.6, node_height_max=4, range_x=2.0,
           range_y=2.0, range_theta=0.5, scan_range_max=12.0,
           usable_range_max=12.0, frontier_cap=4096)


def _port_state(s):
    """The port's graph and builder (on the CPU) holding the JAX SLAM
    ``s``'s state."""
    jg, jb = s.graph, s.builder
    st, n, e = jb.scans, jg.num_nodes, jg.num_edges
    store = interop.scan_store_from_arrays(
        st.ranges[:st.count], st.angles[:st.count], st.valid[:st.count],
        st.min_range[:st.count], st.max_range[:st.count],
        st.rel_sensor_pose[:st.count], st.raw_beams[:st.count],
        st.timestamps[:st.count])
    graph = interop.pose_graph_from_arrays(
        jg.poses[:n], jg.scan_ids[:n], jg.edge_i[:e], jg.edge_j[:e],
        jg.edge_rel[:e], jg.edge_info[:e])
    builder = tmb.GridMapBuilder(tmb.MapBuilderConfig(**vars(jb.config)),
                                 store, device="cpu")
    interop.set_local_maps(builder, [dict(
        log_odds=np.asarray(lm.grid.log_odds),
        observed=np.asarray(lm.grid.observed),
        origin=np.asarray(lm.grid.origin), node_idx_min=lm.node_idx_min,
        node_idx_max=lm.node_idx_max, finished=lm.finished,
        built_poses=lm.built_poses) for lm in jb.local_maps],
        jb.accum_travel_dist)
    return graph, builder


class _Enough(Exception):
    pass


def test_fanout_detector_and_mesh_backend_on_jax_states():
    """tests/test_e2e.py::test_mesh_backend_matches_sequential's run (2
    laps of ``loop_waypoints``, seed 4): at each detection pass, the
    port's fan-out detector on the JAX state against the JAX fan-out
    detector; at the first pass that closes a loop, a port
    ``Backend(mesh=...)`` pass on the same state, which must solve with
    the node-sharded LM. The run stops after three passes with loop
    edges."""
    wp1 = jsynth.loop_waypoints()
    scans, gt = jsynth.simulate(
        waypoints=np.concatenate([wp1, wp1[1:]], axis=0),
        config=jsynth.SimConfig(step=0.25, max_range=12.0, seed=4))
    det_seq = jlc.LoopDetectorBranchBound(**DET)
    det_fan = jlc.LoopDetectorBranchBound(**DET, mesh=jmesh.make_mesh(8))
    mesh = cpu_mesh()
    s = build_slam(detector=det_seq, travel_thresh=8.0, initial_pose=gt[0])
    s.frontend.config.update_threshold_angle = 0.3
    checked = {"passes": 0, "with_edges": 0, "backend": 0}
    solves = []

    def spy(graph, builder, candidates):
        ref = det_fan.detect(graph, builder, candidates)
        tgraph, tbuilder = _port_state(s)
        cands = [tlc.LoopCandidate(list(c.node_indices), c.local_map_idx,
                                   c.local_map_node_idx) for c in candidates]
        MetricManager.reset_instance()
        got = tlc.LoopDetectorBranchBound(**DET, mesh=mesh).detect(
            tgraph, tbuilder, cands)
        kr = {(r.start_node_idx, r.end_node_idx): r for r in ref}
        kg = {(r.start_node_idx, r.end_node_idx): r for r in got}
        assert set(kg) == set(kr)
        for key in kr:
            np.testing.assert_allclose(kg[key].relative_pose,
                                       kr[key].relative_pose, atol=1e-3)
        counters = MetricManager.instance().to_dict()["Counters"]
        k = -(-max(len(c.node_indices) for c in cands) // 8) * 8
        assert counters["LoopDetectMxuPaddedQueries"]["value"] == \
            len(cands) * k - sum(len(c.node_indices) for c in cands)
        assert "LoopDetectFrontierOverflow" in counters
        checked["passes"] += 1
        if ref and not checked["backend"]:
            _mesh_backend_pass(tgraph, tbuilder, len(ref), solves)
            checked["backend"] += 1
        checked["with_edges"] += bool(ref)
        if checked["with_edges"] >= 3:
            raise _Enough
        return det_seq.__class__.detect(det_seq, graph, builder, candidates)

    det_seq.detect = spy
    with pytest.raises(_Enough):
        for scan in scans:
            s.process_scan(scan, scan.odom_pose)
    assert checked["passes"] >= 3 and checked["backend"] == 1


def _mesh_backend_pass(graph, builder, n_edges, solves):
    """One port backend pass over a mesh of 8 CPU shards on this state:
    the same loop edges as the JAX fan-out, one node-sharded solve, its
    poses within 0.05 m of the host solver's on the same snapshot
    (tests/test_optimizer_solvers.py:100)."""
    mesh = cpu_mesh()
    backend = tslam.Backend(
        tlc.LoopSearcherNearest(travel_dist_threshold=6.0, node_dist_max=3.0,
                                num_candidate_nodes=2),
        tlc.LoopDetectorBranchBound(**DET), thost.LMConfig(max_iterations=10),
        device="cpu", mesh=mesh)
    assert backend.detector.mesh is mesh
    optimize = backend._optimize

    def recorded(snapshot):
        res = optimize(snapshot)
        solves.append((snapshot, res))
        return res

    backend._optimize = recorded
    slam = tslam.LidarGraphSlam(None, backend, builder, graph)
    assert backend.run_once(slam) == n_edges
    assert backend.num_sharded_solves == 1 and backend.num_device_solves == 0
    snapshot, res = solves[0]
    assert snapshot.edge_i.shape[0] % 8 == 0
    n = snapshot.num_nodes
    host = thost.optimize_host(snapshot, backend.lm_config).poses[:n]
    assert np.isfinite(res.poses).all()
    np.testing.assert_allclose(res.poses[:n, :2], host[:, :2], rtol=0,
                               atol=0.05)
