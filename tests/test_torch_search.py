"""The port's scoring, costs, search matchers, matcher strategies and
grid-search loop detector against the JAX package, on the CPU.

The scene is tests/test_matchers.py's (a 512^2 map at 0.05 m from five
simulated scans, 181 beams in a 256-wide scan); the JAX package builds it
and both packages read the same value map. JAX matchers run jitted on the
CPU, as the JAX package's own tests run them.

Tolerances, with the largest error seen in a CPU run in brackets:
- scores: rtol 1e-5 [1.9e-7]; greedy costs rtol 1e-5 [3.3e-7]; smoothed
  values atol 1e-6; map gradients atol 1e-3 [3.4e-5] (a central
  difference over 0.1 cell amplifies float32 rounding); square-error
  cost and gradient rtol 1e-5 / 1e-4, covariance rtol 1e-3 / atol 1e-6
  [1.2e-5 relative];
- matchers: poses atol 1e-5 [1.2e-7], scores rtol 1e-5, covariances rtol
  1e-3 / atol 1e-6 with the greedy-endpoint cost and rtol 1e-2 with the
  square-error cost [1.7e-3] (its gradient is a central difference of
  smoothed values over 0.1 cell, so the float32 rounding of each read
  becomes ~1e-3 of the sum), found flags and ``frontier_overflow`` equal;
- the port's chunked grid search equals its unchunked one bit for bit,
  and its Q-batched branch-and-bound its per-query runs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from my_lidar_graph_slam_tpu.models import loop_closure as jlc
from my_lidar_graph_slam_tpu.models import map_builder as jmb
from my_lidar_graph_slam_tpu.models import scan_matchers as jsm
from my_lidar_graph_slam_tpu.ops import cost as jcost
from my_lidar_graph_slam_tpu.ops import grid as jgrid
from my_lidar_graph_slam_tpu.ops import matchers as jmatchers
from my_lidar_graph_slam_tpu.ops import pyramid as jpyramid
from my_lidar_graph_slam_tpu.ops import scoring as jscoring
from my_lidar_graph_slam_tpu.io import synth as jsynth
from my_lidar_graph_slam_tpu.sensor.data import RawScan as JRawScan
from my_lidar_graph_slam_tpu_torch import interop
from my_lidar_graph_slam_tpu_torch.models import loop_closure as tlc
from my_lidar_graph_slam_tpu_torch.models import map_builder as tmb
from my_lidar_graph_slam_tpu_torch.models import scan_matchers as tsm
from my_lidar_graph_slam_tpu_torch.ops import cost as tcost
from my_lidar_graph_slam_tpu_torch.ops import matchers as tmatchers
from my_lidar_graph_slam_tpu_torch.ops import pyramid as tpyramid
from my_lidar_graph_slam_tpu_torch.ops import scoring as tscoring
from my_lidar_graph_slam_tpu_torch.sensor.data import RawScan as TRawScan
from my_lidar_graph_slam_tpu_torch.utils.metrics import MetricManager
from tests.test_matchers import COMMON, NB, RES, make_query, make_scene
from tests.test_torch_matcher import loop_scene  # noqa: F401
from tests.test_torch_matcher import one_torch_thread  # noqa: F401

INIT = np.array([0.0, 0.0, 0.3])


@pytest.fixture(scope="module")
def scene():
    g, segs, beam_angles = make_scene()
    vals = np.asarray(jgrid.values(g))
    tg = interop.grid_from_numpy(g.log_odds, g.observed, g.origin, RES,
                                 "cpu")
    return g, segs, beam_angles, vals, tg, torch.from_numpy(vals.copy())


def _queries(scene, true_poses):
    _, segs, beam_angles, *_ = scene
    return [make_query(segs, beam_angles, np.asarray(p)) for p in true_poses]


def _port_scans(queries, beams=181.0):
    n = len(queries)
    beams = np.broadcast_to(np.asarray(beams, np.float32), (n,))
    return dict(
        ranges=torch.from_numpy(np.stack([np.asarray(q[0]) for q in queries])),
        angles=torch.from_numpy(np.stack([np.asarray(q[1]) for q in queries])),
        valid=torch.from_numpy(np.stack([np.asarray(q[2]) for q in queries])),
        scan_min_range=torch.zeros(n), scan_max_range=torch.full((n,), 20.0),
        rel_sensor_poses=torch.zeros((n, 3)),
        num_total_beams=torch.from_numpy(beams.copy()))


def _poses(rows):
    return torch.tensor(np.asarray(rows), dtype=torch.float32).reshape(-1, 3)


def _same(got, ref, i=None, score=True, cov_rtol=1e-3):
    """Port summary row ``i`` (all rows if None) against a JAX summary."""
    sel = slice(None) if i is None else slice(i, i + 1)

    def r(x):
        x = np.asarray(x)
        return x if i is None else x[None]

    np.testing.assert_array_equal(got.pose_found[sel].numpy(),
                                  r(ref.pose_found))
    np.testing.assert_allclose(got.estimated_pose[sel].numpy(),
                               r(ref.estimated_pose), rtol=0, atol=1e-5)
    if score:
        np.testing.assert_allclose(got.normalized_score[sel].numpy(),
                                   r(ref.normalized_score), rtol=1e-5)
    np.testing.assert_allclose(got.normalized_cost[sel].numpy(),
                               r(ref.normalized_cost), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(got.covariance[sel].numpy(),
                               r(ref.covariance), rtol=cov_rtol, atol=1e-6)


# --------------------------------------------------------------------------
# Scoring and costs
# --------------------------------------------------------------------------


def test_score_poses_matches_jax(scene):
    g, _, _, vals, tg, tv = scene
    ranges, angles, valid = _queries(scene, [[0.1, -0.05, 0.33]])[0]
    rng = np.random.default_rng(5)
    poses = (INIT + rng.uniform(-0.2, 0.2, (7, 3))).astype(np.float32)
    mask = np.asarray(valid) & (np.asarray(ranges) > 0.01)
    ref = jscoring.score_poses(jnp.asarray(vals), g, jnp.asarray(poses),
                               ranges, angles, jnp.asarray(mask), 181)
    got = tscoring.score_poses(tv, tg, torch.from_numpy(poses),
                               torch.tensor(np.asarray(ranges)),
                               torch.tensor(np.asarray(angles)),
                               torch.from_numpy(mask), 181)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)


@pytest.mark.parametrize("kernel_size", [1, 2])
def test_greedy_endpoint_cost_matches_jax(scene, kernel_size):
    g, _, _, vals, tg, tv = scene
    ranges, angles, valid = _queries(scene, [[0.06, -0.04, 0.32]])[0]
    rng = np.random.default_rng(kernel_size)
    poses = (INIT + rng.uniform(-0.1, 0.1, (6, 3))).astype(np.float32)
    mask = np.asarray(valid, np.float32)
    kw = dict(kernel_size=kernel_size, standard_deviation=0.05,
              scaling_factor=1.0)
    ref = jcost.greedy_endpoint_cost(jnp.asarray(vals), g,
                                     jnp.asarray(poses), ranges, angles,
                                     jnp.asarray(mask), **kw)
    got = tcost.greedy_endpoint_cost(tv, tg, torch.from_numpy(poses),
                                     torch.tensor(np.asarray(ranges)),
                                     torch.tensor(np.asarray(angles)),
                                     torch.from_numpy(mask), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)


def test_smoothed_value_and_map_gradient_match_jax(scene):
    g, _, _, vals, tg, tv = scene
    rng = np.random.default_rng(9)
    f = rng.uniform(-3.0, 515.0, (2, 400)).astype(np.float32)
    ref = jcost.smoothed_value(jnp.asarray(vals), jnp.asarray(f[0]),
                               jnp.asarray(f[1]))
    got = tcost.smoothed_value(tv, torch.from_numpy(f[0]),
                               torch.from_numpy(f[1]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)
    pts = rng.uniform(-6.0, 6.0, (300, 2)).astype(np.float32)
    ref = jcost.map_gradient(jnp.asarray(vals), g, jnp.asarray(pts))
    got = tcost.map_gradient(tv, tg, torch.from_numpy(pts))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-3)


def test_square_error_cost_gradient_covariance_match_jax(scene):
    g, _, _, vals, tg, tv = scene
    ranges, angles, valid = _queries(scene, [[0.05, 0.03, 0.315]])[0]
    mask = np.asarray(valid, np.float32)
    pose = np.array([0.02, 0.01, 0.31], np.float32)
    jargs = (jnp.asarray(vals), g, jnp.asarray(pose), ranges, angles,
             jnp.asarray(mask))
    targs = (tv, tg, torch.from_numpy(pose)[None],
             torch.tensor(np.asarray(ranges))[None],
             torch.tensor(np.asarray(angles))[None],
             torch.from_numpy(mask)[None])
    for fn, rtol, atol in (("square_error_cost", 1e-5, 0.0),
                           ("square_error_gradient", 1e-4, 1e-4),
                           ("square_error_covariance", 1e-3, 1e-6)):
        np.testing.assert_allclose(
            getattr(tcost, fn)(*targs)[0].numpy(),
            np.asarray(getattr(jcost, fn)(*jargs)), rtol=rtol, atol=atol,
            err_msg=fn)


# --------------------------------------------------------------------------
# Branch-and-bound
# --------------------------------------------------------------------------


def _bb_jax(pyr, g, query, init, thr, height, win, win_t, cap,
            beams=181):
    ranges, angles, valid = query
    return jmatchers.branch_bound_match(
        pyr, g, jnp.asarray(init, jnp.float32), ranges, angles, valid,
        scan_range_max=jnp.asarray(20.0, jnp.float32),
        range_theta=jnp.asarray(0.25, jnp.float32),
        normalized_score_threshold=jnp.asarray(thr, jnp.float32),
        node_height_max=height, win_x=win, win_y=win, win_theta_max=win_t,
        frontier_cap=cap, num_total_beams=beams, **COMMON)


def _bb_port(pyr, tg, queries, inits, thr, height, win, win_t, cap,
             beams=181.0):
    return tmatchers.branch_bound_match(
        pyr, tg, _poses(inits), **_port_scans(queries, beams),
        scan_range_max=20.0, range_theta=0.25, usable_range_min=0.01,
        usable_range_max=20.0, normalized_score_threshold=thr,
        node_height_max=height, win_x=win, win_y=win, win_theta_max=win_t,
        frontier_cap=cap)


def test_branch_bound_matches_jax(scene):
    """tests/test_matchers.py::test_branch_bound_matches_exhaustive."""
    g, _, _, vals, tg, tv = scene
    query = _queries(scene, [[0.15, 0.1, 0.25]])[0]
    win_t = jmatchers.static_max_theta_window(RES, 20.0, 0.25)
    ref = _bb_jax(jpyramid.build_pyramid(jnp.asarray(vals), 4), g, query,
                  INIT, 0.1, 4, 8, win_t, 8192)
    got = _bb_port(tpyramid.build_pyramid(tv, 4), tg, [query], [INIT], 0.1,
                   4, 8, win_t, 8192)
    assert bool(ref.pose_found)
    _same(got, ref, 0)
    assert int(got.frontier_overflow[0]) == int(ref.frontier_overflow) == 0


@pytest.mark.parametrize("cap", [4, 65536])
def test_branch_bound_frontier_overflow_matches_jax(scene, cap):
    """tests/test_matchers.py::test_branch_bound_frontier_overflow_flag: on
    a random map the quota of a tiny cap binds and both packages count the
    same dropped nodes; a generous cap drops none."""
    g, _, _, vals, tg, _ = scene
    noisy = np.random.default_rng(7).uniform(0.0, 1.0, vals.shape).astype(
        np.float32)
    query = _queries(scene, [[0.15, 0.1, 0.25]])[0]
    win_t = jmatchers.static_max_theta_window(RES, 20.0, 0.25)
    init = [0.0, 0.0, 0.3]
    ref = _bb_jax(jpyramid.build_pyramid(jnp.asarray(noisy), 3), g, query,
                  init, 0.01, 3, 16, win_t, cap)
    got = _bb_port(tpyramid.build_pyramid(torch.from_numpy(noisy), 3), tg,
                   [query], [init], 0.01, 3, 16, win_t, cap)
    assert int(got.frontier_overflow[0]) == int(ref.frontier_overflow)
    assert (int(ref.frontier_overflow) > 0) == (cap == 4)
    _same(got, ref, 0)


def test_branch_bound_batch_matches_jax_and_per_query(scene):
    """The Q-batched form scales each query's threshold by its own beam
    count (``branch_bound_match_batch``) and equals per-query calls."""
    g, _, _, vals, tg, tv = scene
    trues = [[0.15, 0.1, 0.25], [-0.1, 0.05, 0.34], [0.05, -0.12, 0.28]]
    queries = _queries(scene, trues)
    inits = np.tile(INIT, (3, 1))
    beams = np.array([181.0, 150.0, 220.0], np.float32)
    win_t = jmatchers.static_max_theta_window(RES, 20.0, 0.25)
    pyr = tpyramid.build_pyramid(tv, 4)
    got = _bb_port(pyr, tg, queries, inits, 0.1, 4, 8, win_t, 4096, beams)
    stack = {k: jnp.stack([jnp.asarray(q[i]) for q in queries])
             for i, k in enumerate(("ranges", "angles", "valid"))}
    ref = jmatchers.branch_bound_match_batch(
        jpyramid.build_pyramid(jnp.asarray(vals), 4), g,
        jnp.asarray(inits, jnp.float32), **stack,
        scan_min_range=jnp.zeros(3, jnp.float32),
        scan_max_range=jnp.full(3, 20.0, jnp.float32),
        rel_sensor_poses=jnp.zeros((3, 3), jnp.float32),
        num_total_beams=jnp.asarray(beams),
        scan_range_max=jnp.asarray(20.0, jnp.float32),
        range_theta=jnp.asarray(0.25, jnp.float32),
        usable_range_min=jnp.asarray(0.01, jnp.float32),
        usable_range_max=jnp.asarray(20.0, jnp.float32),
        normalized_score_threshold=jnp.asarray(0.1, jnp.float32),
        node_height_max=4, win_x=8, win_y=8, win_theta_max=win_t,
        frontier_cap=4096)
    _same(got, ref)
    np.testing.assert_array_equal(got.frontier_overflow.numpy(),
                                  np.asarray(ref.frontier_overflow))
    for i in range(3):
        one = _bb_port(pyr, tg, [queries[i]], inits[i:i + 1], 0.1, 4, 8,
                       win_t, 4096, beams[i:i + 1])
        for a, b in zip(one, got):
            assert torch.equal(a[0], b[i])


# --------------------------------------------------------------------------
# Grid search
# --------------------------------------------------------------------------

GRID = dict(step_x=RES, step_y=RES, step_t=0.005, nx=9, ny=9, nt=17)


def _grid_port(vm, tg, queries, inits, beams=181.0, thr=0.0):
    return tmatchers.grid_search_match(
        vm, tg, _poses(inits), **_port_scans(queries, beams),
        usable_range_min=0.01, usable_range_max=20.0,
        normalized_score_threshold=thr, **GRID)


def test_grid_search_matches_jax(scene):
    """tests/test_matchers.py::test_grid_search_recovers_offset, then a
    batch of three with per-query beam counts
    (``grid_search_match_batch``)."""
    g, _, _, vals, tg, tv = scene
    trues = [[0.1, -0.05, 0.33], [-0.08, 0.06, 0.29], [0.03, 0.1, 0.31]]
    queries = _queries(scene, trues)
    jgrid_kw = {k: (jnp.asarray(v, jnp.float32) if k.startswith("step")
                    else v) for k, v in GRID.items()}
    ref = jmatchers.grid_search_match(
        jnp.asarray(vals), g, jnp.asarray(INIT, jnp.float32), *queries[0],
        normalized_score_threshold=jnp.asarray(0.0, jnp.float32),
        num_total_beams=181, **jgrid_kw, **COMMON)
    _same(_grid_port(tv, tg, queries[:1], [INIT]), ref, 0)

    beams = np.array([181.0, 160.0, 200.0], np.float32)
    ref = jmatchers.grid_search_match_batch(
        jnp.asarray(vals), g, jnp.asarray(np.tile(INIT, (3, 1)), jnp.float32),
        *(jnp.stack([jnp.asarray(q[i]) for q in queries]) for i in range(3)),
        jnp.zeros(3, jnp.float32), jnp.full(3, 20.0, jnp.float32),
        jnp.zeros((3, 3), jnp.float32),
        usable_range_min=jnp.asarray(0.01, jnp.float32),
        usable_range_max=jnp.asarray(20.0, jnp.float32),
        normalized_score_threshold=jnp.asarray(0.5, jnp.float32),
        num_total_beams=beams, **jgrid_kw)
    _same(_grid_port(tv, tg, queries, np.tile(INIT, (3, 1)), beams, 0.5),
          ref)


def test_grid_search_chunks_keep_the_first_maximum(scene, monkeypatch):
    """Scored one dy row at a time, the lattice gives the unchunked
    result bit for bit; on a flat map, where every candidate ties, both
    return the first lattice pose (dy, dx, dt all at their lowest)."""
    _, _, _, _, tg, tv = scene
    queries = _queries(scene, [[0.1, -0.05, 0.33], [-0.08, 0.06, 0.29]])
    inits = np.tile(INIT, (2, 1))
    flat = torch.full_like(tv, 0.5)
    whole = [_grid_port(vm, tg, queries, inits) for vm in (tv, flat)]
    monkeypatch.setattr(tmatchers, "GRID_CHUNK_ELEMS", 1)
    chunked = [_grid_port(vm, tg, queries, inits) for vm in (tv, flat)]
    for a, b in zip(whole, chunked):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    first = INIT + np.array([-4 * RES, -4 * RES, -8 * 0.005])
    np.testing.assert_allclose(chunked[1].estimated_pose.numpy(),
                               np.tile(first, (2, 1)), rtol=0, atol=1e-6)


# --------------------------------------------------------------------------
# Hill climbing and Gauss-Newton
# --------------------------------------------------------------------------


def _host_syncs():
    """The step flags' reads, counted outside any layer span."""
    return MetricManager.instance().counters("HostSyncs.other").value


@pytest.mark.parametrize("cost_type", ["greedy_endpoint", "square_error"])
def test_hill_climbing_matches_jax(scene, cost_type):
    g, _, _, vals, tg, tv = scene
    query = _queries(scene, [[0.06, -0.04, 0.32]])[0]
    ref = jmatchers.hill_climbing_match(
        jnp.asarray(vals), g, jnp.asarray(INIT, jnp.float32), *query,
        cost_type=cost_type, num_total_beams=181, **COMMON)
    syncs = _host_syncs()
    got = tmatchers.hill_climbing_match(
        tv, tg, _poses([INIT]), **_port_scans([query]),
        usable_range_min=0.01, usable_range_max=20.0, cost_type=cost_type)
    _same(got, ref, 0, cov_rtol=1e-2 if cost_type == "square_error" else 1e-3)
    assert _host_syncs() > syncs


def test_linear_solver_matches_jax(scene):
    g, _, _, vals, tg, tv = scene
    query = _queries(scene, [[0.05, 0.03, 0.315]])[0]
    ref = jmatchers.linear_solver_match(
        jnp.asarray(vals), g, jnp.asarray(INIT, jnp.float32), *query,
        num_total_beams=181, **COMMON)
    syncs = _host_syncs()
    got = tmatchers.linear_solver_match(
        tv, tg, _poses([INIT]), **_port_scans([query]),
        usable_range_min=0.01, usable_range_max=20.0)
    _same(got, ref, 0, cov_rtol=1e-2)
    assert _host_syncs() > syncs


# --------------------------------------------------------------------------
# The four strategies through match_async / resolve_async
# --------------------------------------------------------------------------

MATCHERS = {
    # The correlative sweep with the square-error cost tail, against the
    # JAX package's sweep (its Pallas kernel in interpret mode), which
    # builds the theta lattice as the port does.
    "Correlative": dict(range_x=0.2, range_y=0.2, range_theta=0.3,
                        cost_type="square_error"),
    "BranchBound": dict(node_height_max=3, range_x=0.8, range_y=0.8,
                        range_theta=0.25, frontier_cap=4096),
    "GridSearch": dict(range_x=0.3, range_y=0.3, range_theta=0.1,
                       step_theta=0.01),
    "HillClimbing": dict(cost_type="square_error"),
    "LinearSolver": dict(max_iterations=20),
}


@pytest.mark.parametrize("name", sorted(MATCHERS))
def test_matcher_strategies_match_jax(scene, name):
    g, segs, beam_angles, _, tg, _ = scene
    # Off the 0.05 m lattice: a pose on it puts beam endpoints on cell
    # edges, where a last-bit difference in cos/sin moves a hit cell.
    true = np.array([0.037, -0.028, 0.322])
    r = jsynth.raycast_segments(true[:2], true[2] + beam_angles, segs, 20.0)
    stores = {}
    for pkg, mb, raw in (("jax", jmb, JRawScan), ("torch", tmb, TRawScan)):
        stores[pkg] = mb.ScanStore(beam_capacity=NB)
        stores[pkg].append(raw(
            sensor_id="FLASER", timestamp=0.0, odom_pose=np.zeros(3),
            velocity=np.zeros(3), rel_sensor_pose=np.zeros(3, np.float32),
            min_range=0.0, max_range=20.0, min_angle=float(beam_angles[0]),
            max_angle=float(beam_angles[-1]),
            angles=beam_angles.astype(np.float32),
            ranges=r.astype(np.float32)))
    cls = f"{name}Matcher"
    sweep = dict(use_mxu=True, mxu_interpret=True) \
        if name == "Correlative" else {}
    ref = getattr(jsm, cls)(**MATCHERS[name], **sweep).match(
        g, stores["jax"], 0, INIT)
    m = getattr(tsm, cls)(**MATCHERS[name])
    got = m.resolve_async(m.match_async(tg, stores["torch"], 0, INIT), INIT)
    assert bool(got.pose_found) == bool(ref.pose_found)
    np.testing.assert_allclose(got.estimated_pose,
                               np.asarray(ref.estimated_pose), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got.normalized_score,
                               np.asarray(ref.normalized_score), rtol=1e-5)
    square = name == "LinearSolver" or \
        MATCHERS[name].get("cost_type") == "square_error"
    np.testing.assert_allclose(got.covariance, np.asarray(ref.covariance),
                               rtol=1e-2 if square else 1e-3, atol=1e-6)
    assert int(got.frontier_overflow) == int(ref.frontier_overflow)


# --------------------------------------------------------------------------
# The grid-search loop detector
# --------------------------------------------------------------------------


def test_grid_search_detector_matches_jax(loop_scene):  # noqa: F811
    builder, graph, tbuilder, tgraph = loop_scene
    last = graph.num_nodes - 1
    cand = dict(node_indices=[last - 2, last - 1, last], local_map_idx=0,
                local_map_node_idx=1)
    kw = dict(score_threshold=0.45, range_x=1.0, range_y=1.0,
              range_theta=0.1, step_theta=0.01, usable_range_max=12.0)
    ref = jlc.LoopDetectorGridSearch(**kw).detect(
        graph, builder, [jlc.LoopCandidate(**cand)])
    got = tlc.LoopDetectorGridSearch(**kw).detect(
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
