"""The port's multi-candidate loop detection against the JAX package on the
CPU: the folded multi-map sweep, the detector's several-candidate pass and
the replay window search.

The JAX side runs its Pallas kernels in interpret mode; the port runs its
plain versions. State is built by the JAX package and handed to the port
through ``interop`` (the fixtures of tests/test_torch_matcher.py).
Tolerances: poses atol 1e-5, scores rtol 1e-5, covariances rtol 1e-3 and
atol 1e-6, as tests/test_torch_matcher.py holds the single-candidate
detector. The JAX package's own multi-against-sequential test uses atol
1e-7 (tests/test_loop_detectors.py:204-210), but there both sides run the
same cost kernel; across the two packages the greedy cost is summed in a
different float32 order (the port sums exact per-class beam counts), and
the central difference behind the covariance magnifies that to ~2e-6.
Within the port the multi-candidate pass is held bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from my_lidar_graph_slam_tpu.models import loop_closure as jlc
from my_lidar_graph_slam_tpu.ops import grid as jgrid
from my_lidar_graph_slam_tpu.ops import matchers as jmatchers
from my_lidar_graph_slam_tpu.ops import matchers_mxu
from my_lidar_graph_slam_tpu_torch.models import loop_closure as tlc
from my_lidar_graph_slam_tpu_torch.ops import matchers_sweep
from tests.test_torch_matcher import (  # noqa: F401
    RES, loop_scene, match_scene, one_torch_thread)

DETECT_KW = dict(score_threshold=0.3, node_height_max=5, range_x=0.6,
                 range_y=0.6, range_theta=0.2, scan_range_max=12.0,
                 usable_range_max=12.0)


def _candidates(lc, builder, graph):
    """Two simultaneous candidates against different finished local maps
    (test_loop_detectors.py:188-195)."""
    last = graph.num_nodes - 1
    return [
        lc.LoopCandidate(node_indices=[last - 1, last], local_map_idx=0,
                         local_map_node_idx=1),
        lc.LoopCandidate(node_indices=[last - 2, last - 1, last],
                         local_map_idx=1,
                         local_map_node_idx=builder.local_maps[1]
                         .node_idx_min),
    ]


def _same(a, b, exact):
    assert (a.start_node_idx, a.end_node_idx) == \
        (b.start_node_idx, b.end_node_idx)
    if exact:
        np.testing.assert_array_equal(a.relative_pose, b.relative_pose)
        np.testing.assert_array_equal(a.covariance, b.covariance)
    else:
        np.testing.assert_allclose(a.relative_pose, b.relative_pose,
                                   atol=1e-5)
        np.testing.assert_allclose(a.covariance, b.covariance,
                                   rtol=1e-3, atol=1e-6)


def test_multi_candidate_equals_sequential_bit_for_bit(loop_scene):
    """One folded pass over two stacked maps gives the bits of one pass
    per candidate."""
    builder, graph, tbuilder, tgraph = loop_scene
    assert len([m for m in tbuilder.local_maps if m.finished]) >= 2
    cands = _candidates(tlc, tbuilder, tgraph)
    det = tlc.LoopDetectorBranchBound(**DETECT_KW)
    batch = det.detect(tgraph, tbuilder, cands)
    seq = [r for c in cands for r in det.detect(tgraph, tbuilder, [c])]
    assert len(batch) >= 2
    assert len(batch) == len(seq)
    for a, b in zip(seq, batch):
        _same(a, b, exact=True)


def test_multi_candidate_matches_jax(loop_scene):
    builder, graph, tbuilder, tgraph = loop_scene
    ref = jlc.LoopDetectorBranchBound(
        use_mxu=True, mxu_interpret=True, **DETECT_KW).detect(
        graph, builder, _candidates(jlc, builder, graph))
    got = tlc.LoopDetectorBranchBound(**DETECT_KW).detect(
        tgraph, tbuilder, _candidates(tlc, tbuilder, tgraph))
    assert len(ref) >= 2
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        _same(a, b, exact=False)


@pytest.mark.parametrize("kw", [
    dict(travel_dist_threshold=1.0, node_dist_max=3.0,
         num_candidate_nodes=2, num_candidate_maps=3),
    dict(travel_dist_threshold=0.5, node_dist_max=1.0,
         num_candidate_nodes=1, num_candidate_maps=1),
], ids=["three-maps", "one-map"])
def test_search_window_matches_jax(loop_scene, kw):
    builder, graph, tbuilder, tgraph = loop_scene
    n = graph.num_nodes
    for window in (range(n - 3, n), range(2, n), [n - 1, n + 4]):
        ref = jlc.LoopSearcherNearest(**kw).search_window(
            graph, builder, window)
        got = tlc.LoopSearcherNearest(**kw).search_window(
            tgraph, tbuilder, window)
        assert [vars(c) for c in got] == [vars(c) for c in ref]
    assert ref


def test_sweep_multi_matches_mxu_multi(match_scene):
    """Three maps and a fourth, a copy of the first with all-invalid rows
    (the JAX package's bucket of four), x two queries, the second query of
    the third map padded, against ``correlative_match_mxu_multi``."""
    g, s = match_scene
    vals = np.asarray(jgrid.values(g))
    origin = np.asarray(g.origin)
    maps = np.stack([vals, vals[::-1].copy(), np.roll(vals, 7, axis=1),
                     vals])
    origins = np.stack([origin, origin + [0.3, -0.2], origin + [0.05, 0.1],
                        origin]).astype(np.float32)
    m, k = 4, 2
    rows = np.array([[0, 1], [2, 3], [1, 0], [0, 0]])
    ip = s["ip"][rows].copy()
    ip[1] += [0.3, -0.2, 0.0]
    r, a, v = s["r"][rows], s["a"][rows], s["v"][rows].copy()
    v[2, 1] = False
    v[3] = False
    rmin = np.zeros((m, k), np.float32)
    rmax = np.full((m, k), 12.0, np.float32)
    rel = np.zeros((m, k, 3), np.float32)
    beams = np.full((m, k), 181.0, np.float32)
    win_t = jmatchers.static_max_theta_window(RES, 12.0, 0.3)
    tiles = jnp.stack([matchers_mxu.make_tiles(jnp.asarray(x)).tiles
                       for x in maps])
    ref = matchers_mxu.correlative_match_mxu_multi(
        jnp.asarray(maps), tiles, jnp.asarray(origins),
        jnp.asarray(RES, jnp.float32), jnp.asarray(ip), jnp.asarray(r),
        jnp.asarray(a), jnp.asarray(v), jnp.asarray(rmin),
        jnp.asarray(rmax), jnp.asarray(rel),
        jnp.asarray(12.0, jnp.float32), jnp.asarray(0.3, jnp.float32),
        jnp.asarray(0.01, jnp.float32), jnp.asarray(12.0, jnp.float32),
        jnp.asarray(0.3, jnp.float32), jnp.asarray(beams),
        win_x=3, win_y=2, win_theta_max=win_t, interpret=True)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x))

    got = matchers_sweep.correlative_match_sweep_multi(
        t(maps), t(origins), RES, t(ip), t(r), t(a), t(v), t(rmin),
        t(rmax), t(rel), scan_range_max=12.0, range_theta=0.3,
        usable_range_min=0.01, usable_range_max=12.0,
        normalized_score_threshold=0.3, num_total_beams=t(beams),
        win_x=3, win_y=2, win_theta_max=win_t)
    assert tuple(got.estimated_pose.shape) == (m, k, 3)
    found = np.asarray(ref.pose_found)
    np.testing.assert_array_equal(got.pose_found.numpy(), found)
    assert found[:3].sum() >= 3 and not found[2, 1] and not found[3].any()
    np.testing.assert_allclose(got.estimated_pose.numpy(),
                               np.asarray(ref.estimated_pose), atol=1e-5)
    np.testing.assert_allclose(got.normalized_score.numpy(),
                               np.asarray(ref.normalized_score), rtol=1e-5)
    live = np.asarray(v).any(-1)
    np.testing.assert_allclose(got.covariance.numpy()[live],
                               np.asarray(ref.covariance)[live],
                               rtol=1e-3, atol=1e-6)
