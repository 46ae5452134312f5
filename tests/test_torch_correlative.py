"""The port's two-stage correlative search, correlative loop detector,
pruned frontend matcher and coarse-map cache against the JAX package, on
the CPU.

Scenes: tests/test_loop_detectors.py's ``loop_scene`` (a finished 640^2
local map at 0.05 m and a pose graph whose last nodes revisit it, 181
beams; built by the JAX package and handed to the port through
``interop``) for the two-stage search and the detector, and
tests/test_matchers.py's 512^2 scene for the pruned matcher. Both
packages read the same scans and maps.

Tolerances, with the largest error seen in a CPU run in brackets:
- poses atol 1e-6 m and rad, i.e. the same lattice cell [0 for the
  two-stage search, 1.5e-8 for the pruned one]; found, exact flags and
  escalation counts equal;
- scores rtol 1e-5 (as K1 is held) [2.1e-7]; costs rtol 1e-4 / atol 1e-7;
  covariances rtol 1e-3 / atol 1e-6 [4.6e-6 absolute on entries ~1e-2];
- coarse maps atol 1e-6 [6.0e-8: the occupancy values' exp], bound stacks
  bit-equal (max is exact; both packages read one value array).
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from my_lidar_graph_slam_tpu import launcher as jlauncher
from my_lidar_graph_slam_tpu.io import map_io as jmap_io
from my_lidar_graph_slam_tpu.io import synth as jsynth
from my_lidar_graph_slam_tpu.models import loop_closure as jlc
from my_lidar_graph_slam_tpu.models import scan_matchers as jsm
from my_lidar_graph_slam_tpu.ops import correlative_coarse as jcc
from my_lidar_graph_slam_tpu.ops import grid as jgrid
from my_lidar_graph_slam_tpu.ops import matchers as jmatchers
from my_lidar_graph_slam_tpu.ops import pyramid as jpyramid
from my_lidar_graph_slam_tpu.utils import metrics as jmetrics
from my_lidar_graph_slam_tpu_torch import interop
from my_lidar_graph_slam_tpu_torch import launcher as tlauncher
from my_lidar_graph_slam_tpu_torch.io import map_io as tmap_io
from my_lidar_graph_slam_tpu_torch.models import loop_closure as tlc
from my_lidar_graph_slam_tpu_torch.models import scan_matchers as tsm
from my_lidar_graph_slam_tpu_torch.ops import correlative_coarse as tcc
from my_lidar_graph_slam_tpu_torch.ops import matchers as tmatchers
from my_lidar_graph_slam_tpu_torch.ops import pyramid as tpyramid
from my_lidar_graph_slam_tpu_torch.utils import config as tconfig
from my_lidar_graph_slam_tpu_torch.utils import metrics as tmetrics
from my_lidar_graph_slam_tpu_torch.utils.metrics import MetricManager
from tests.test_matchers import NB, RES, make_query, make_scene
from tests.test_torch_matcher import loop_scene  # noqa: F401
from tests.test_torch_matcher import one_torch_thread  # noqa: F401

DEFAULT = "configs/launcher_settings_default.json"
TWO_STAGE = dict(low_resolution=5, range_x=1.0, range_y=1.0,
                 range_theta=0.25, scan_range_max=12.0,
                 usable_range_min=0.01, usable_range_max=12.0,
                 score_threshold=0.1, greedy_params=())


def _counter(name):
    return MetricManager.instance().counters(name).value


def _same_summary(got, ref, rows=slice(None)):
    """Port MatchSummary (tensors) against a JAX one, on ``rows``."""
    def t(x):
        return x.numpy()[rows]

    def j(x):
        return np.asarray(x)[rows]

    np.testing.assert_array_equal(t(got.pose_found), j(ref.pose_found))
    np.testing.assert_allclose(t(got.estimated_pose), j(ref.estimated_pose),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(t(got.normalized_score),
                               j(ref.normalized_score), rtol=1e-5)
    np.testing.assert_allclose(t(got.normalized_cost),
                               j(ref.normalized_cost), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(t(got.covariance), j(ref.covariance),
                               rtol=1e-3, atol=1e-6)


class _Calls:
    """Counts the calls of a module function while installed."""

    def __init__(self, monkeypatch, module, name):
        self.n = 0
        fn = getattr(module, name)

        def counted(*args, **kwargs):
            self.n += 1
            return fn(*args, **kwargs)

        monkeypatch.setattr(module, name, counted)


def _batch(graph, nodes, pad_to):
    ids = [int(graph.scan_ids[n]) for n in nodes]
    ids = np.asarray(ids + [0] * (pad_to - len(ids)))
    poses = np.zeros((pad_to, 3), np.float32)
    poses[:len(nodes)] = graph.poses[nodes]
    return ids, poses


# --------------------------------------------------------------------------
# Two-stage search
# --------------------------------------------------------------------------


@pytest.mark.parametrize("refine_blocks", [512, 4, 1],
                         ids=["certified", "escalated", "exhausted"])
def test_two_stage_batch_matches_jax(loop_scene, monkeypatch,  # noqa: F811
                                     refine_blocks):
    """Poses, scores, found and exact flags and escalation counts of the
    batched two-stage search; 4 blocks escalate twice and certify all
    real rows, 1 block runs out of escalations uncertified."""
    builder, graph, tbuilder, tgraph = loop_scene
    last = graph.num_nodes - 1
    ids, poses = _batch(graph, [last - 2, last - 1, last], 4)
    lm, tlm = builder.local_maps[0], tbuilder.local_maps[0]
    coarse = jcc.coarse_map_for(builder, lm, 5)
    tcoarse = tcc.coarse_map_for(tbuilder, tlm, 5)
    np.testing.assert_allclose(tcoarse.numpy(), np.asarray(coarse),
                               rtol=0, atol=1e-6)

    calls = _Calls(monkeypatch, jcc, "_two_stage_core_batch")
    ref, ref_exact = jcc.two_stage_match_batch(
        coarse, jgrid.values(lm.grid), lm.grid, poses,
        refine_blocks=refine_blocks, num_total_beams=None,
        scan_store=builder.scans, scan_ids=ids, **TWO_STAGE)
    got = tcc.two_stage_match_batch(
        tcoarse, tbuilder.values_for(tlm), tlm.grid, poses,
        refine_blocks=refine_blocks, scan_store=tbuilder.scans, scan_ids=ids,
        **TWO_STAGE)
    _same_summary(got.summary, ref)
    np.testing.assert_array_equal(got.exact, np.asarray(ref_exact))
    assert got.escalations == calls.n - 1
    assert got.escalations == {512: 0, 4: 2, 1: 2}[refine_blocks]
    np.testing.assert_array_equal(got.packed[:, 15] > 0.5, got.exact)
    np.testing.assert_allclose(got.packed[:, 0:3],
                               got.summary.estimated_pose.numpy())


def test_two_stage_single_matches_jax(loop_scene):  # noqa: F811
    builder, graph, tbuilder, tgraph = loop_scene
    node = graph.num_nodes - 1
    sid = int(graph.scan_ids[node])
    lm, tlm = builder.local_maps[0], tbuilder.local_maps[0]
    kw = dict(TWO_STAGE, refine_blocks=512, num_total_beams=181)
    ref, ref_exact = jcc.two_stage_match(
        jcc.coarse_map_for(builder, lm, 5), jgrid.values(lm.grid), lm.grid,
        jnp.asarray(graph.poses[node], jnp.float32),
        scan_store=builder.scans, scan_id=sid, **kw)
    got, exact = tcc.two_stage_match(
        tcc.coarse_map_for(tbuilder, tlm, 5), tbuilder.values_for(tlm),
        tlm.grid, graph.poses[node], scan_store=tbuilder.scans, scan_id=sid,
        **kw)
    assert exact == bool(ref_exact) is True
    batched = type(got)(*(x[None] for x in got))
    _same_summary(batched, type(ref)(*(jnp.asarray(x)[None] for x in ref)))


def test_top_k_keeps_xla_tie_order():
    """Equal values in ascending index order and -inf last, as
    ``lax.top_k``; ``torch.topk`` promises no order among ties."""
    rng = np.random.default_rng(3)
    x = rng.integers(0, 4, (5, 300)).astype(np.float32)
    x[:, rng.integers(0, 300, 90)] = -np.inf
    for k in (1, 7, 120, 299):
        vals, idx = tmatchers.top_k(torch.from_numpy(x), k)
        jvals, jidx = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


def test_two_stage_ties_take_the_first_block(loop_scene):  # noqa: F811
    """A map of one constant value ties every coarse block and every fine
    candidate a beam reads inside the map: the winner is the first
    candidate of the first block in top-k order, in both packages, at
    refine budgets small enough that most tied blocks are cut."""
    builder, graph, tbuilder, tgraph = loop_scene
    lm, tlm = builder.local_maps[0], tbuilder.local_maps[0]
    const = np.full(lm.grid.log_odds.shape, 0.5, np.float32)
    last = graph.num_nodes - 1
    ids, poses = _batch(graph, [last - 1, last], 2)
    for blocks in (1, 40):
        kw = dict(TWO_STAGE, refine_blocks=blocks, max_escalations=0)
        ref, ref_exact = jcc.two_stage_match_batch(
            jpyramid.windowed_max(jnp.asarray(const), 5), jnp.asarray(const),
            lm.grid, poses, num_total_beams=None, scan_store=builder.scans,
            scan_ids=ids, **kw)
        tconst = torch.from_numpy(const)
        got = tcc.two_stage_match_batch(
            tpyramid.windowed_max(tconst, 5), tconst, tlm.grid, poses,
            scan_store=tbuilder.scans, scan_ids=ids, **kw)
        _same_summary(got.summary, ref)
        np.testing.assert_array_equal(got.exact, np.asarray(ref_exact))
        assert not got.exact.any()


# --------------------------------------------------------------------------
# The correlative loop detector and its coarse-map cache
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(score_threshold=0.45, refine_blocks=512),
    dict(score_threshold=0.45, refine_blocks=2),
], ids=["certified", "escalated"])
def test_correlative_detector_matches_jax(loop_scene, kw):  # noqa: F811
    """Loop edges, ``last_exact`` and the padded rows of the detector end
    to end: three candidate nodes pad to a batch of four with scan 0."""
    builder, graph, tbuilder, tgraph = loop_scene
    last = graph.num_nodes - 1
    cand = dict(node_indices=[last - 2, last - 1, last], local_map_idx=0,
                local_map_node_idx=1)
    common = dict(low_resolution=5, range_x=1.0, range_y=1.0,
                  range_theta=0.25, scan_range_max=12.0,
                  usable_range_max=12.0, **kw)
    jdet = jlc.LoopDetectorCorrelative(**common)
    ref = jdet.detect(graph, copy.deepcopy(builder),
                      [jlc.LoopCandidate(**cand)])
    tdet = tlc.LoopDetectorCorrelative(**common)
    padded = _counter("LoopDetectMxuPaddedQueries")
    escalations = _counter("LoopDetectCorrelativeEscalations")
    got = tdet.detect(tgraph, copy.deepcopy(tbuilder),
                      [tlc.LoopCandidate(**cand)])
    assert _counter("LoopDetectMxuPaddedQueries") == padded + 1
    assert (_counter("LoopDetectCorrelativeEscalations") > escalations) == \
        (kw["refine_blocks"] == 2)
    assert tdet.last_exact == jdet.last_exact
    assert len(ref) >= 1
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert (a.start_node_idx, a.end_node_idx) == \
            (b.start_node_idx, b.end_node_idx)
        np.testing.assert_allclose(a.relative_pose, b.relative_pose,
                                   atol=1e-5)
        np.testing.assert_allclose(a.start_node_pose, b.start_node_pose)
        np.testing.assert_allclose(a.covariance, b.covariance,
                                   rtol=1e-3, atol=1e-6)


def test_coarse_map_goes_stale_after_a_rebuild(loop_scene):  # noqa: F811
    """Both packages keep a local map's coarse map across the rebuild of
    ``after_loop_closure``, so it no longer bounds the new map; the port
    counts each detection that uses it, and ``refresh_coarse_maps``
    rebuilds it from the new map."""
    builder, graph, tbuilder, tgraph = loop_scene
    jb, jg = copy.deepcopy(builder), copy.deepcopy(graph)
    tb, tg = copy.deepcopy(tbuilder), copy.deepcopy(tgraph)
    fresh_tb = copy.deepcopy(tbuilder)
    fresh_tb.refresh_coarse_maps = True
    before = [np.asarray(jcc.coarse_map_for(jb, jb.local_maps[0], 5)),
              tcc.coarse_map_for(tb, tb.local_maps[0], 5).numpy(),
              tcc.coarse_map_for(fresh_tb, fresh_tb.local_maps[0], 5).numpy()]
    # Not a rigid shift: the map's origin follows its first node.
    shift = np.zeros((graph.num_nodes, 3))
    shift[:, 0] = 0.03 * np.arange(graph.num_nodes)
    shift[:, 2] = 0.04
    jg.poses[:graph.num_nodes] += shift
    tg.poses[:graph.num_nodes] += shift
    jb.after_loop_closure(jg)
    tb.after_loop_closure(tg)
    fresh_tb.after_loop_closure(tg)

    stale = _counter("LoopDetectStaleCoarseMaps")
    after = [np.asarray(jcc.coarse_map_for(jb, jb.local_maps[0], 5)),
             tcc.coarse_map_for(tb, tb.local_maps[0], 5).numpy(),
             tcc.coarse_map_for(fresh_tb, fresh_tb.local_maps[0], 5).numpy()]
    assert _counter("LoopDetectStaleCoarseMaps") == stale + 1
    rebuilt_j = np.asarray(jpyramid.windowed_max(
        jgrid.values(jb.local_maps[0].grid), 5))
    rebuilt_t = tpyramid.windowed_max(tb.values_for(tb.local_maps[0]),
                                      5).numpy()
    np.testing.assert_array_equal(after[0], before[0])
    np.testing.assert_array_equal(after[1], before[1])
    assert np.abs(after[0] - rebuilt_j).max() > 0.1
    assert np.abs(after[1] - rebuilt_t).max() > 0.1
    np.testing.assert_array_equal(after[2], rebuilt_t)
    np.testing.assert_allclose(after[1], after[0], rtol=0, atol=1e-6)


# --------------------------------------------------------------------------
# Pruned frontend matcher
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scene():
    g, segs, beam_angles = make_scene()
    vals = np.asarray(jgrid.values(g))
    tg = interop.grid_from_numpy(g.log_odds, g.observed, g.origin, RES,
                                 "cpu")
    return g, segs, beam_angles, vals, tg


def _queries(scene, q, seed):
    _, segs, beam_angles, *_ = scene
    init = np.array([0.0, 0.0, 0.3])
    rng = np.random.default_rng(seed)
    true = init + np.concatenate([rng.uniform(-0.1, 0.1, (q, 2)),
                                  rng.uniform(-0.06, 0.06, (q, 1))], axis=1)
    qs = [make_query(segs, beam_angles, p) for p in true]
    return (np.tile(init, (q, 1)).astype(np.float32),
            *(np.stack([np.asarray(x[i]) for x in qs]) for i in range(3)))


def test_bound_stack_matches_jax(scene):
    *_, vals, _ = scene
    for win in ((2, 2), (4, 3)):
        ref = np.asarray(jmatchers.make_bound_stack(jnp.asarray(vals), *win))
        got = tmatchers.make_bound_stack(torch.from_numpy(vals.copy()), *win)
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("win,groups,thetas", [
    (2, 14, 48), (4, 10, 28), (2, 1, 2)],
    ids=["frontend", "wider", "certificate-fails"])
def test_pruned_batch_matches_jax(scene, win, groups, thetas):
    g, _, _, vals, tg = scene
    q = 6
    poses, ranges, angles, valid = _queries(scene, q, 11)
    win_t = jmatchers.static_max_theta_window(RES, 20.0, 0.5)
    scal = (20.0, 0.5, 0.01, 20.0, 0.0)
    kw = dict(win_x=win, win_y=win, win_theta_max=win_t, top_groups=groups,
              top_thetas=thetas, greedy_params=jsm.DEFAULT_GREEDY_PARAMS)
    jv = jnp.asarray(vals)
    ref, ref_exact = jmatchers.correlative_match_pruned_batch(
        jv, jmatchers.make_bound_stack(jv, win, win), g, jnp.asarray(poses),
        jnp.asarray(ranges), jnp.asarray(angles), jnp.asarray(valid),
        jnp.zeros(q), jnp.full(q, 20.0), jnp.zeros((q, 3)),
        *(jnp.float32(x) for x in scal), jnp.full(q, 181.0), **kw)
    tv = torch.from_numpy(vals.copy())
    got, exact = tmatchers.correlative_match_pruned_batch(
        tv, tmatchers.make_bound_stack(tv, win, win), tg,
        torch.from_numpy(poses), torch.from_numpy(ranges),
        torch.from_numpy(angles), torch.from_numpy(valid), torch.zeros(q),
        torch.full((q,), 20.0), torch.zeros((q, 3)), *scal,
        torch.full((q,), 181.0), **kw)
    np.testing.assert_array_equal(exact.numpy(), np.asarray(ref_exact))
    assert exact.any() != (groups == 1)
    _same_summary(got, ref)


def test_pruned_frontend_reruns_through_the_sweep(scene, monkeypatch):
    """``CorrelativeMatcher(use_sweep=False)`` through ``match_async`` and
    ``resolve_async``: with the frontend's 14/48 budgets the certificate
    holds and the pruned answer stands; with budgets of 1/2 it fails and
    the sweep's re-run gives the JAX package's brute answer."""
    from my_lidar_graph_slam_tpu.models import map_builder as jmb
    from my_lidar_graph_slam_tpu.sensor.data import RawScan as JRawScan
    from my_lidar_graph_slam_tpu_torch.models import map_builder as tmb
    from my_lidar_graph_slam_tpu_torch.sensor.data import RawScan

    g, segs, beam_angles, vals, tg = scene
    poses, ranges, *_ = _queries(scene, 2, 13)
    stores = [jmb.ScanStore(beam_capacity=NB), tmb.ScanStore(beam_capacity=NB)]
    for i in range(2):
        for store, raw in zip(stores, (JRawScan, RawScan)):
            store.append(raw(
                sensor_id="FLASER", timestamp=float(i), odom_pose=np.zeros(3),
                velocity=np.zeros(3), rel_sensor_pose=np.zeros(3),
                min_range=0.0, max_range=20.0,
                min_angle=float(beam_angles[0]),
                max_angle=float(beam_angles[-1]),
                angles=beam_angles.astype(np.float32),
                ranges=ranges[i, :181].copy()))
    win_t = jmatchers.static_max_theta_window(RES, 20.0, 0.5)
    idx = np.arange(2)
    st = stores[0]
    brute = jmatchers.correlative_match_batch(
        jgrid.values(g), g, jnp.asarray(poses), jnp.asarray(st.ranges[idx]),
        jnp.asarray(st.angles[idx]), jnp.asarray(st.valid[idx]),
        jnp.asarray(st.min_range[idx]), jnp.asarray(st.max_range[idx]),
        jnp.asarray(st.rel_sensor_pose[idx]), jnp.float32(20.0),
        jnp.float32(0.5), jnp.float32(0.01), jnp.float32(20.0),
        jnp.float32(0.0), jnp.asarray(st.raw_beams[idx], jnp.float32),
        win_x=2, win_y=2, win_theta_max=win_t,
        greedy_params=jsm.DEFAULT_GREEDY_PARAMS)

    m = tsm.CorrelativeMatcher(use_sweep=False)
    for budgets, exact in (((14, 48), True), ((1, 2), False)):
        monkeypatch.setattr(tsm, "PRUNED_TOP_GROUPS", budgets[0])
        monkeypatch.setattr(tsm, "PRUNED_TOP_THETAS", budgets[1])
        pruned = _counter("FrontendPrunedMatches")
        reruns = _counter("FrontendPrunedReruns")
        for i in range(2):
            got = m.resolve_async(m.match_async(tg, stores[1], i, poses[i]),
                                  poses[i])
            assert m.last_exact_fraction == float(exact)
            assert bool(got.pose_found) == bool(brute.pose_found[i])
            np.testing.assert_allclose(got.estimated_pose,
                                       np.asarray(brute.estimated_pose[i]),
                                       rtol=0, atol=1e-6)
            np.testing.assert_allclose(got.normalized_score,
                                       float(brute.normalized_score[i]),
                                       rtol=1e-5)
            np.testing.assert_allclose(got.covariance,
                                       np.asarray(brute.covariance[i]),
                                       rtol=1e-3, atol=1e-6)
            assert int(got.frontier_overflow) == 0
        assert _counter("FrontendPrunedMatches") == pruned + 2
        assert _counter("FrontendPrunedReruns") == reruns + (0 if exact
                                                             else 2)


# --------------------------------------------------------------------------
# The launcher with the correlative loop detector
# --------------------------------------------------------------------------


def _small_correlative_settings(path, gt0):
    """The default settings with the RealTimeCorrelative loop detector, at
    CI scale (tests/test_torch_configs.py's cuts: 0.1 m cells, 256^2 local
    and 192^2 latest maps, 8 m ranges; a +-1 m x +-1 m x 0.5 rad loop
    window)."""
    d = json.load(open(DEFAULT))
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
    d["ScanMatcherRealTimeCorrelative"]["ScanRangeMax"] = 8.0
    d["CostGreedyEndpoint"]["UsableRangeMax"] = 8.0
    d["Backend"].update(
        LoopDetectorType="RealTimeCorrelative",
        LoopDetectorConfigGroup="LoopDetectorRealTimeCorrelative")
    rtc = d["LoopDetectorRealTimeCorrelative"]
    rtc["ScoreThreshold"] = 0.5
    rtc["ScanMatcher"].update(SearchRangeX=2.0, SearchRangeY=2.0,
                              SearchRangeTheta=0.5, ScanRangeMax=8.0)
    rtc["CostGreedyEndpoint"]["UsableRangeMax"] = 8.0
    d["LoopSearcherNearest"].update(TravelDistThreshold=5.0,
                                    PoseGraphNodeDistMax=3.0)
    with open(path, "w") as f:
        json.dump(d, f)


@pytest.fixture(scope="module")
def correlative_log(tmp_path_factory):
    """A mini-world log with its ground truth and CI-scale settings with
    the correlative loop detector, and the JAX launcher's run on them
    (stats and node poses)."""
    wd = tmp_path_factory.mktemp("correlative")
    scans, gt = jsynth.simulate(
        world=jsynth.mini_world(), waypoints=jsynth.mini_loop_waypoints(),
        config=jsynth.SimConfig(step=0.25, max_range=8.0, seed=4))
    log = str(wd / "mini.clf")
    jsynth.write_carmen_log(log, scans, max_range=8.0)
    gt_path = str(wd / "gt.npz")
    np.savez(gt_path, true_poses=gt,
             timestamps=np.array([s.timestamp for s in scans]))
    settings = str(wd / "settings.json")
    _small_correlative_settings(settings, gt[0])
    jmetrics.MetricManager.reset_instance()
    stats = jlauncher.run(log, settings, str(wd / "jax"),
                          threaded_backend=False, gt_path=gt_path)
    graph, _ = jmap_io.load_checkpoint(str(wd / "jax.ckpt.npz"), 256)
    return log, settings, gt_path, stats, graph.node_poses()


@pytest.mark.parametrize("frontend", ["sweep", "pruned"])
def test_correlative_settings_end_to_end_match_jax(tmp_path, monkeypatch,
                                                   correlative_log,
                                                   frontend):
    """Both launchers on a mini-world log with the correlative loop
    detector. The JAX frontend runs its CPU default, the pruned path with
    brute re-runs; the port's runs its sweep, or its pruned path with
    sweep re-runs. Tolerances as tests/test_torch_configs.py's: poses
    1e-3 m, ATE 0.02 m."""
    log, settings, gt_path, j, jposes = correlative_log
    create = tconfig.create_slam

    def create_with(*a, **kw):
        s = create(*a, **kw)
        s.frontend.matcher.use_sweep = frontend == "sweep"
        return s

    monkeypatch.setattr(tconfig, "create_slam", create_with)
    tmetrics.MetricManager.reset_instance()
    t = tlauncher.run(log, settings, str(tmp_path / "torch"),
                      threaded_backend=False, gt_path=gt_path,
                      platform="cpu")
    counters = tmetrics.MetricManager.instance().counters
    assert (counters("FrontendPrunedMatches").value > 0) == \
        (frontend == "pruned")
    for k in ("num_scans", "num_nodes", "num_edges", "num_loop_closures"):
        assert t[k] == j[k], k
    assert t["num_loop_closures"] >= 1
    assert abs(t["ate_rmse_m"] - j["ate_rmse_m"]) < 0.02
    tg, _ = tmap_io.load_checkpoint(str(tmp_path / "torch.ckpt.npz"), 256)
    np.testing.assert_allclose(tg.node_poses(), jposes, rtol=0, atol=1e-3)
