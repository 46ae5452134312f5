"""The port's CUDA kernels against their plain versions, on a card.

Marked ``cuda``: on a machine without a card (or without ``nvcc``) each
test skips from inside. Run on the card with
``python -m pytest --noconftest tests/test_torch_cuda.py`` (the suite's
conftest imports JAX, which that machine need not have).
"""

import os
import shutil

import numpy as np
import pytest
import torch

from my_lidar_graph_slam_tpu_torch.ops.cuda import correlate, greedy_cost

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if shutil.which("nvcc") is None and \
            not os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("no nvcc to build the kernels")
    return torch.device("cuda")


def _cells(gen, q, nt, nb, h, w):
    bx = torch.randint(8, w - 8, (q, 1, nb), generator=gen)
    by = torch.randint(8, h - 8, (q, 1, nb), generator=gen)
    ix = bx + torch.randint(-1, 2, (q, nt, nb), generator=gen).cumsum(1)
    iy = by + torch.randint(-1, 2, (q, nt, nb), generator=gen).cumsum(1)
    return ix.int(), iy.int()


@pytest.mark.parametrize("win", [1, 2, 7])
def test_window_scores_kernel_matches_plain(dev, win):
    gen = torch.Generator().manual_seed(win)
    h, w, q, nt, nb = 120, 140, 3, 17, 70
    vm = torch.rand((2, h, w), generator=gen)
    ix, iy = _cells(gen, q, nt, nb, h, w)
    ix[:, :, ::7] = 2_000_000_000          # far off, weight 0
    wgt = torch.rand((q, nb), generator=gen)
    wgt[:, ::7] = 0.0
    midx = torch.tensor([1, 0, 1], dtype=torch.int32)
    args = (vm, ix, iy, wgt, win, win, midx)
    ref = correlate.window_scores_plain(*args)
    before = correlate.window_scores.launches
    got = correlate.window_scores(*(a.to(dev) if torch.is_tensor(a) else a
                                    for a in args))
    torch.cuda.synchronize()
    assert correlate.window_scores.launches == before + 1
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("kernel_size", [1, 2])
def test_greedy_cost_kernel_matches_plain(dev, kernel_size):
    gen = torch.Generator().manual_seed(kernel_size)
    occ = (torch.rand((200, 200), generator=gen) < 0.2).float()
    vm = torch.where(occ > 0, torch.full_like(occ, 0.8),
                     torch.full_like(occ, 0.05))
    q, nb = 5, 90
    origin = torch.tensor([-5.0, -5.0])
    poses = torch.stack([torch.rand(q, generator=gen) * 4 - 2,
                         torch.rand(q, generator=gen) * 4 - 2,
                         torch.rand(q, generator=gen) * 6 - 3], 1)
    ranges = 0.3 + 6.0 * torch.rand((q, nb), generator=gen)
    angles = torch.linspace(-1.5, 1.5, nb).expand(q, nb).contiguous()
    mask = torch.rand((q, nb), generator=gen) < 0.9
    # Both versions on the card: the cell preparation (cos, sin, floor) is
    # shared PyTorch code, and the CPU's and the card's last bits differ.
    args = [a.to(dev) if torch.is_tensor(a) else a
            for a in (vm, origin, poses, ranges, angles, mask, 0.05)]
    ref = greedy_cost.greedy_cost_cov_plain(*args, kernel_size=kernel_size)
    before = greedy_cost.greedy_cost_core.launches
    got = greedy_cost.greedy_cost_cov(*args, kernel_size=kernel_size)
    torch.cuda.synchronize()
    assert greedy_cost.greedy_cost_core.launches == before + 1
    # Both versions sum exact per-class counts in one order: equal bits.
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=1e-4)
    torch.testing.assert_close(got[1], ref[1], rtol=1e-4, atol=1e-8)


# --------------------------------------------------------------------------
# Edge cases of the kernels' launch geometry (beam records staged in shared
# memory, beam splits, row groups, the last-block epilogue of K2).
# --------------------------------------------------------------------------

K1_RTOL, K1_ATOL = 1e-5, 1e-3


def _k1_case(case, gen):
    """(value_map, ix, iy, weight, win_x, win_y, map_idx) on the CPU."""
    h, w = 300, 340
    q, nt, nb, win_x, win_y, midx = 2, 17, 384, 2, 2, None
    if case == "nb1024_detection_window":
        q, nt, nb, win_x, win_y = 2, 9, 1024, 20, 20
    elif case == "nb1500_two_chunks":
        nb = 1500
    elif case == "nt_odd_201":
        q, nt = 1, 201
    elif case == "nt_1":
        nt = 1
    elif case == "non_square_window":
        win_x, win_y = 3, 10
    elif case == "wide_window_many_passes":
        q, nt, nb, win_x, win_y = 1, 3, 64, 40, 30
    elif case == "map_idx_two_maps":
        q = 4
        midx = torch.tensor([1, 0, 0, 1], dtype=torch.int32)
    elif case.endswith("detection_window"):
        # The default config's 41 x 41 loop-detection window.
        q, nt, win_x, win_y = 2, 9, 20, 20
        if case == "map_idx_detection_window":
            q = 4
            midx = torch.tensor([1, 0, 0, 1], dtype=torch.int32)
    vm = torch.rand((2, h, w) if midx is not None else (h, w), generator=gen)
    ix, iy = _cells(gen, q, nt, nb, h, w)
    # Interior windows, some touching an edge of the map.
    ix = ix.clamp(win_x, w - win_x - 1)
    iy = iy.clamp(win_y, h - win_y - 1)
    wgt = (torch.rand((q, nb), generator=gen) < 0.5).float() * \
        torch.rand((q, nb), generator=gen)
    if case == "all_weights_zero":
        wgt.zero_()
    elif case == "live_not_multiple_of_split":
        wgt.zero_()
        wgt[:, torch.randperm(nb, generator=gen)[:13]] = 1.0
    elif case.startswith(("all_border", "interior_and_border")):
        # Cells within the window of an edge: every window crosses it.
        edge = torch.tensor([-win_x, 0, w - 1, w - 1 + win_x])
        pick = torch.randint(0, 4, (q, nt, nb), generator=gen)
        bx = edge[pick]
        if case.startswith("interior_and_border"):
            half = torch.rand((q, 1, nb), generator=gen) < 0.5
            bx = torch.where(half.expand_as(bx), ix.long(), bx)
        ix = bx.int()
        # Some beams wholly off the map, alive: they must add nothing.
        ix[:, :, ::11] = w + win_x + 5
    return vm, ix, iy, wgt, win_x, win_y, midx


K1_CASES = ["nb384_frontend_window", "nb1024_detection_window",
            "nb1500_two_chunks", "nt_odd_201", "nt_1", "non_square_window",
            "wide_window_many_passes", "map_idx_two_maps",
            "all_weights_zero", "live_not_multiple_of_split", "all_border",
            "interior_and_border", "all_border_detection_window",
            "interior_and_border_detection_window",
            "map_idx_detection_window"]


@pytest.mark.parametrize("case", K1_CASES)
def test_window_scores_kernel_edge_cases(dev, case):
    gen = torch.Generator().manual_seed(K1_CASES.index(case))
    args = [a.to(dev) if torch.is_tensor(a) else a
            for a in _k1_case(case, gen)]
    ref = correlate.window_scores_plain(*args)
    got = correlate.window_scores(*args)
    again = correlate.window_scores(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again), "two launches differ"
    if case == "all_weights_zero":
        assert bool((got == 0).all())
    torch.testing.assert_close(got, ref, rtol=K1_RTOL, atol=K1_ATOL)
    # First-maximum argmax equal wherever the top two are separated.
    flat_g = got.reshape(got.shape[0] * got.shape[1], -1)
    flat_r = ref.reshape(flat_g.shape)
    if flat_r.shape[1] > 1:
        top2 = flat_r.topk(2, dim=1).values
        clear = (top2[:, 0] - top2[:, 1]) > K1_ATOL
        same = flat_g.argmax(1) == flat_r.argmax(1)
        assert bool((same | ~clear).all())


@pytest.mark.parametrize("kernel_size,q", [(1, 1), (1, 8), (2, 1), (2, 8),
                                           (3, 1), (3, 8)])
def test_greedy_cost_core_bit_equal_and_self_clearing(dev, kernel_size, q):
    """The core equals the plain version bit for bit at kernel_size 1 and 2
    (compile-time bodies) and 3 (the run-time body), and two calls in a
    row give the same bits, so the kernel's scratch clears itself."""
    gen = torch.Generator().manual_seed(10 * kernel_size + q)
    occ = (torch.rand((260, 260), generator=gen) < 0.2).float()
    vm = torch.where(occ > 0, torch.full_like(occ, 0.8),
                     torch.full_like(occ, 0.05)).to(dev)
    nb = 384
    origin = torch.tensor([-6.5, -6.5], device=dev)
    poses = torch.stack([torch.rand(q, generator=gen) * 4 - 2,
                         torch.rand(q, generator=gen) * 4 - 2,
                         torch.rand(q, generator=gen) * 6 - 3], 1).to(dev)
    ranges = (0.3 + 8.0 * torch.rand((q, nb), generator=gen)).to(dev)
    angles = torch.linspace(-1.6, 1.6, nb).expand(q, nb).contiguous().to(dev)
    mask = (torch.rand((q, nb), generator=gen) < 0.6).to(dev)
    cells = greedy_cost.prepare_cells(origin, poses, ranges, angles, 0.05,
                                      0.075)
    table = greedy_cost.class_table(0.05, kernel_size, 0.05, dev)
    args = (vm, cells, mask, table, kernel_size, 0.1)
    ref = greedy_cost.greedy_cost_core_plain(*args)
    got = greedy_cost.greedy_cost_core(*args)
    again = greedy_cost.greedy_cost_core(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert torch.equal(again, got)


# --------------------------------------------------------------------------
# The device pose-graph solver and the search matchers on the card.
# --------------------------------------------------------------------------


def test_device_solver_ring_8192_with_tf32_on(dev):
    """The 8192-node ring solved on the card with TF32 turned on for
    matmul: the solver multiplies and sums its 3x3 blocks itself, so its
    poses stay finite and within 0.05 m of the host solver's
    (tests/test_optimizer_solvers.py:100)."""
    from my_lidar_graph_slam_tpu_torch.io import synth
    from my_lidar_graph_slam_tpu_torch.models import (optimizer_host,
                                                      optimizer_lm)

    graph, _ = synth.ring_graph(8192, seed=0, n_loops=4)
    snap = graph.snapshot()
    cfg = optimizer_lm.LMConfig(loss_scale=0.01, error_tolerance=1e-4)
    host = optimizer_host.optimize_host(snap, cfg)
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        res = optimizer_lm.optimize(snap, cfg, dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before[0]
        torch.set_float32_matmul_precision(before[1])
    poses = res.poses.cpu().numpy()[:8192]
    assert poses.shape == (8192, 3) and bool(np.isfinite(poses).all())
    np.testing.assert_allclose(poses[:, :2], host.poses[:8192, :2],
                               rtol=0, atol=0.05)


def _search_scene():
    """A 0.05 m map of the synthetic intel world from three scans, and a
    scan taken 0.12 m and 0.05 rad away from the matchers' start pose, on
    the CPU."""
    from my_lidar_graph_slam_tpu_torch.io import synth
    from my_lidar_graph_slam_tpu_torch.ops import grid as gridops
    from my_lidar_graph_slam_tpu_torch.ops import raycast

    segs = synth.intel_world()
    beams = np.linspace(-np.pi / 2, np.pi / 2, 181)
    start = np.array([-14.0, -9.0, 0.3])
    g = gridops.empty(256, 256, 0.05, center=start[:2], device="cpu")
    for dp in ([0.0, 0.0, 0.0], [0.2, -0.1, 0.05], [-0.15, 0.1, -0.05]):
        p = start + np.asarray(dp)
        r = synth.raycast_segments(p[:2], p[2] + beams, segs, 12.0)
        g = raycast.integrate_scan(
            g, torch.tensor(p, dtype=torch.float32),
            torch.tensor(r, dtype=torch.float32),
            torch.tensor(beams, dtype=torch.float32),
            torch.ones(181, dtype=torch.bool), 0.01, 12.0, max_steps=256)
    true = start + np.array([0.12, -0.08, 0.05])
    r = synth.raycast_segments(true[:2], true[2] + beams, segs, 12.0)
    scan = dict(
        ranges=torch.tensor(r, dtype=torch.float32)[None],
        angles=torch.tensor(beams, dtype=torch.float32)[None],
        valid=torch.ones((1, 181), dtype=torch.bool),
        scan_min_range=torch.zeros(1), scan_max_range=torch.full((1,), 12.0),
        rel_sensor_poses=torch.zeros((1, 3)),
        num_total_beams=torch.full((1,), 181.0))
    return g, torch.tensor(start, dtype=torch.float32)[None], scan


def _to(x, dev):
    return x.to(dev) if torch.is_tensor(x) else x


@pytest.mark.parametrize("matcher", ["branch_bound", "grid_search"])
def test_search_matchers_on_the_card_match_the_cpu(dev, matcher):
    """Branch-and-bound and the grid search on the card against their run
    on the CPU on the same inputs; the cost tail launches K2 once."""
    from my_lidar_graph_slam_tpu_torch.ops import grid as gridops
    from my_lidar_graph_slam_tpu_torch.ops import matchers, pyramid

    g, poses, scan = _search_scene()
    common = dict(usable_range_min=0.01, usable_range_max=12.0,
                  greedy_params=(("standard_deviation", 0.05),
                                 ("scaling_factor", 1.0)))

    def run(d):
        gd = gridops.GridMap(*(_to(x, d) for x in g))
        vals = gridops.values(gd)
        args = {k: _to(v, d) for k, v in scan.items()}
        if matcher == "branch_bound":
            return matchers.branch_bound_match(
                pyramid.build_pyramid(vals, 4), gd, poses.to(d), **args,
                scan_range_max=12.0, range_theta=0.5,
                normalized_score_threshold=0.0, node_height_max=4,
                win_x=10, win_y=10,
                win_theta_max=matchers.static_max_theta_window(0.05, 12.0,
                                                               0.5),
                **common)
        return matchers.grid_search_match(
            vals, gd, poses.to(d), **args, normalized_score_threshold=0.0,
            step_x=0.05, step_y=0.05, step_t=0.01, nx=9, ny=9, nt=21,
            **common)

    ref = run(torch.device("cpu"))
    before = greedy_cost.greedy_cost_core.launches
    got = run(dev)
    torch.cuda.synchronize()
    assert greedy_cost.greedy_cost_core.launches == before + 1
    assert bool(got.pose_found.cpu()[0]) and bool(ref.pose_found[0])
    torch.testing.assert_close(got.estimated_pose.cpu(), ref.estimated_pose,
                               rtol=0, atol=1e-4)
    torch.testing.assert_close(got.normalized_score.cpu(),
                               ref.normalized_score, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(got.covariance.cpu(), ref.covariance,
                               rtol=1e-2, atol=1e-6)
    assert int(got.frontier_overflow.cpu()[0]) == \
        int(ref.frontier_overflow[0])


# --------------------------------------------------------------------------
# The correlative loop detector's search, the pruned frontend search and
# the counting cells on the card.
# --------------------------------------------------------------------------


def _scene_store(scan):
    """A port ScanStore holding the scene's scan as scan 0."""
    from my_lidar_graph_slam_tpu_torch.models import map_builder
    from my_lidar_graph_slam_tpu_torch.sensor.data import RawScan

    store = map_builder.ScanStore(beam_capacity=256)
    store.append(RawScan(
        sensor_id="FLASER", timestamp=0.0, odom_pose=np.zeros(3),
        velocity=np.zeros(3), rel_sensor_pose=np.zeros(3), min_range=0.0,
        max_range=12.0, min_angle=-np.pi / 2, max_angle=np.pi / 2,
        angles=scan["angles"][0].numpy().astype(np.float64),
        ranges=scan["ranges"][0].numpy().astype(np.float64)))
    return store


@pytest.mark.parametrize("refine_blocks", [512, 2])
def test_two_stage_search_on_the_card_matches_the_cpu(dev, refine_blocks):
    """The two-stage search (+-0.5 m, +-0.25 rad, low resolution 5) on the
    card against its CPU run on the same map and scan, padded to two rows
    with scan 0 at a zero pose as the detector pads: the same lattice
    cell, certificates and escalations; the cost tail launches K2 once per
    refinement."""
    from my_lidar_graph_slam_tpu_torch.ops import correlative_coarse
    from my_lidar_graph_slam_tpu_torch.ops import grid as gridops
    from my_lidar_graph_slam_tpu_torch.ops import pyramid

    g, poses, scan = _search_scene()
    store = _scene_store(scan)
    init = np.zeros((2, 3), np.float32)
    init[0] = poses[0].numpy()

    def run(d):
        gd = gridops.GridMap(*(_to(x, d) for x in g))
        vals = gridops.values(gd)
        return correlative_coarse.two_stage_match_batch(
            pyramid.windowed_max(vals, 5), vals, gd, init, low_resolution=5,
            range_x=1.0, range_y=1.0, range_theta=0.5, scan_range_max=12.0,
            usable_range_min=0.01, usable_range_max=12.0,
            score_threshold=0.1, refine_blocks=refine_blocks,
            greedy_params=(("standard_deviation", 0.05),
                           ("scaling_factor", 1.0)),
            scan_store=store, scan_ids=[0, 0])

    ref = run(torch.device("cpu"))
    before = greedy_cost.greedy_cost_core.launches
    got = run(dev)
    torch.cuda.synchronize()
    assert greedy_cost.greedy_cost_core.launches == \
        before + 1 + got.escalations
    assert got.escalations == ref.escalations
    np.testing.assert_array_equal(got.exact, ref.exact)
    assert bool(ref.packed[0, 14] > 0.5)
    np.testing.assert_allclose(got.packed[:, 0:3], ref.packed[:, 0:3],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.packed[:, 12], ref.packed[:, 12],
                               rtol=1e-5)
    np.testing.assert_allclose(got.packed[:, 3:12], ref.packed[:, 3:12],
                               rtol=1e-2, atol=1e-6)


def test_pruned_search_on_the_card_matches_the_cpu(dev):
    """The pruned search at the frontend's budgets (14 groups, 48 thetas,
    a 5 x 5 window) on the card against its CPU run: the same lattice
    cell and certificate; the cost tail launches K2 once."""
    from my_lidar_graph_slam_tpu_torch.ops import grid as gridops
    from my_lidar_graph_slam_tpu_torch.ops import matchers

    g, poses, scan = _search_scene()

    def run(d):
        gd = gridops.GridMap(*(_to(x, d) for x in g))
        vals = gridops.values(gd)
        return matchers.correlative_match_pruned_batch(
            vals, matchers.make_bound_stack(vals, 2, 2), gd, poses.to(d),
            **{k: _to(v, d) for k, v in scan.items()}, scan_range_max=12.0,
            range_theta=0.5, usable_range_min=0.01, usable_range_max=12.0,
            normalized_score_threshold=0.0, win_x=2, win_y=2,
            win_theta_max=matchers.static_max_theta_window(0.05, 12.0, 0.5),
            top_groups=14, top_thetas=48)

    ref, ref_exact = run(torch.device("cpu"))
    before = greedy_cost.greedy_cost_core.launches
    got, exact = run(dev)
    torch.cuda.synchronize()
    assert greedy_cost.greedy_cost_core.launches == before + 1
    assert bool(exact.cpu()[0]) == bool(ref_exact[0])
    torch.testing.assert_close(got.estimated_pose.cpu(), ref.estimated_pose,
                               rtol=0, atol=1e-4)
    torch.testing.assert_close(got.normalized_score.cpu(),
                               ref.normalized_score, rtol=1e-5, atol=0)


def test_pruned_frontend_reruns_through_the_sweep_on_the_card(
        dev, monkeypatch):
    """``CorrelativeMatcher(use_sweep=False)`` through ``match_async`` and
    ``resolve_async`` on the card. At the frontend's budgets (14 groups,
    48 thetas) the certificate holds: K2 launches once and nothing is
    re-run. At budgets of 1 group and 2 thetas it fails: the match is
    re-run through the sweep (K1 once more, K2 twice in all,
    ``FrontendPrunedReruns`` one more), which costs at least one more
    host synchronization, and the pose is the sweep's."""
    import warnings

    from my_lidar_graph_slam_tpu_torch.models import scan_matchers
    from my_lidar_graph_slam_tpu_torch.ops import grid as gridops
    from my_lidar_graph_slam_tpu_torch.utils.metrics import MetricManager

    g, poses, scan = _search_scene()
    store = _scene_store(scan)
    grid = gridops.GridMap(*(_to(x, dev) for x in g))
    init = poses[0].numpy()
    sweep = scan_matchers.CorrelativeMatcher()
    ref = sweep.resolve_async(sweep.match_async(grid, store, 0, init), init)
    pruned = scan_matchers.CorrelativeMatcher(use_sweep=False)
    reruns = MetricManager.instance().counters("FrontendPrunedReruns")
    syncs = {}
    for budgets, exact in (((14, 48), True), ((1, 2), False)):
        monkeypatch.setattr(scan_matchers, "PRUNED_TOP_GROUPS", budgets[0])
        monkeypatch.setattr(scan_matchers, "PRUNED_TOP_THETAS", budgets[1])
        torch.cuda.synchronize()
        k1, k2 = correlate.window_scores.launches, \
            greedy_cost.greedy_cost_core.launches
        n0 = reruns.value
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                got = pruned.resolve_async(
                    pruned.match_async(grid, store, 0, init), init)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs[exact] = len(caught)
        assert pruned.last_exact_fraction == float(exact)
        assert reruns.value == n0 + (0 if exact else 1)
        assert correlate.window_scores.launches == k1 + (0 if exact else 1)
        assert greedy_cost.greedy_cost_core.launches == \
            k2 + (1 if exact else 2)
        assert bool(got.pose_found) == bool(ref.pose_found)
        np.testing.assert_allclose(got.estimated_pose, ref.estimated_pose,
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(got.normalized_score,
                                   ref.normalized_score, rtol=1e-5)
    assert syncs[False] >= syncs[True] + 1


def test_greedy_cost_core_bit_equal_at_the_correlative_detector_shape(dev):
    """K2 at the shape the correlative detector gives it on the default
    settings (a 1536^2 local map, Q = 4, NB = 384, kernel_size 1, scale
    0.05): bit-equal to the plain core."""
    gen = torch.Generator().manual_seed(7)
    occ = (torch.rand((1536, 1536), generator=gen) < 0.1).float()
    vm = torch.where(occ > 0, torch.full_like(occ, 0.9),
                     torch.full_like(occ, 0.05)).to(dev)
    q, nb = 4, 384
    origin = torch.tensor([-38.4, -38.4], device=dev)
    poses = torch.stack([torch.rand(q, generator=gen) * 40 - 20,
                         torch.rand(q, generator=gen) * 40 - 20,
                         torch.rand(q, generator=gen) * 6 - 3], 1).to(dev)
    ranges = (0.3 + 19.0 * torch.rand((q, nb), generator=gen)).to(dev)
    angles = torch.linspace(-1.6, 1.6, nb).expand(q, nb).contiguous().to(dev)
    mask = (torch.rand((q, nb), generator=gen) < 0.5).to(dev)
    cells = greedy_cost.prepare_cells(origin, poses, ranges, angles, 0.05,
                                      0.075)
    table = greedy_cost.class_table(0.05, 1, 1.0, dev)
    args = (vm, cells, mask, table, 1, 0.1)
    assert torch.equal(greedy_cost.greedy_cost_core(*args),
                       greedy_cost.greedy_cost_core_plain(*args))


def test_counting_integration_on_the_card_is_bit_equal(dev):
    """Whole-number counts: the card's atomic adds give the CPU's bits."""
    from my_lidar_graph_slam_tpu_torch.io import synth
    from my_lidar_graph_slam_tpu_torch.ops import grid as gridops
    from my_lidar_graph_slam_tpu_torch.ops import raycast

    segs = synth.intel_world()
    beams = np.linspace(-np.pi / 2, np.pi / 2, 181)
    maps = [gridops.counting_empty(512, 512, 0.05, center=(-14.0, -9.0),
                                   device=d) for d in ("cpu", dev)]
    for k in range(5):
        p = np.array([-14.0 + 0.3 * k, -9.0, 0.3 + 0.1 * k])
        r = synth.raycast_segments(p[:2], p[2] + beams, segs, 12.0)
        args = [torch.tensor(a, dtype=torch.float32) for a in (p, r, beams)]
        args.append(torch.ones(181, dtype=torch.bool))
        maps = [raycast.integrate_scan_counting(
            m, *(a.to(m.device) for a in args), 0.01, 12.0, max_steps=256)
            for m in maps]
    cpu, card = maps
    assert torch.equal(card.hits.cpu(), cpu.hits)
    assert torch.equal(card.counts.cpu(), cpu.counts)
    assert float(cpu.hits.sum()) > 500


# --------------------------------------------------------------------------
# The parallel layer: two shards on the one card
# --------------------------------------------------------------------------


def _card_mesh(dev, n=2):
    from my_lidar_graph_slam_tpu_torch.parallel import mesh

    return mesh.Mesh(devices=[dev] * n)


@pytest.mark.parametrize("solver", ["edges", "nodes"])
def test_sharded_solvers_on_the_card_match_the_cpu(dev, solver):
    """The edge- and node-sharded LM over ``Mesh([cuda:0] * 2)`` against
    the same solve over two CPU shards (poses atol 1e-3: float atomics
    reorder the card's sums), on a 256-node ring with 4 loop edges."""
    from my_lidar_graph_slam_tpu_torch.io import synth
    from my_lidar_graph_slam_tpu_torch.models import optimizer_lm
    from my_lidar_graph_slam_tpu_torch.parallel import distributed, mesh
    from my_lidar_graph_slam_tpu_torch.parallel import multihost

    graph, _ = synth.ring_graph(256, seed=0, n_loops=4)
    snap = graph.snapshot(edge_cap=512)
    cfg = optimizer_lm.LMConfig(solver="cg", cg_max_iterations=64)

    def solve(m):
        if solver == "edges":
            return distributed.optimize_sharded(snap, cfg, m)
        return distributed.optimize_sharded_nodes(
            distributed.partition_graph_by_nodes(snap, 2), cfg, m)

    ref = solve(mesh.make_mesh(2, device="cpu"))
    card = _card_mesh(dev)
    got = solve(card)
    poses = multihost.fetch_global(got.poses)
    assert card.psum_calls > 0
    np.testing.assert_allclose(poses[:256], multihost.fetch_global(
        ref.poses)[:256], rtol=0, atol=1e-3)
    assert got.iterations == ref.iterations


def test_fanout_on_the_card_launches_k2_and_matches_the_cpu(dev):
    """The branch-and-bound fan-out of two rows (the search scene's scan
    and an all-invalid padded row) over two shards of the card: K2 once
    per shard, the same rows as over two CPU shards."""
    from my_lidar_graph_slam_tpu_torch.ops import grid as gridops
    from my_lidar_graph_slam_tpu_torch.ops import matchers, pyramid
    from my_lidar_graph_slam_tpu_torch.parallel import distributed, mesh
    from my_lidar_graph_slam_tpu_torch.parallel import multihost

    g, poses, scan = _search_scene()
    rows = {k: torch.cat([v, torch.zeros_like(v)]) for k, v in scan.items()}
    rows["num_total_beams"][1] = 1.0
    pyr = pyramid.build_pyramid(gridops.values(g), 4)

    def run(m, d):
        gd = gridops.GridMap(*(_to(x, d) for x in g))
        return multihost.fetch_global(distributed.branch_bound_fanout(
            pyr.to(d), gd, torch.cat([poses, poses]), rows["ranges"],
            rows["angles"], rows["valid"], rows["scan_min_range"],
            rows["scan_max_range"], rows["rel_sensor_poses"],
            rows["num_total_beams"], 12.0, 0.5, 0.01, 12.0, 0.3, mesh=m,
            node_height_max=4, win_x=10, win_y=10,
            win_theta_max=matchers.static_max_theta_window(0.05, 12.0, 0.5)))

    ref = run(mesh.make_mesh(2, device="cpu"), torch.device("cpu"))
    before = greedy_cost.greedy_cost_core.launches
    got = run(_card_mesh(dev), dev)
    assert greedy_cost.greedy_cost_core.launches == before + 2
    assert got.pose_found.tolist() == ref.pose_found.tolist() == [True,
                                                                  False]
    np.testing.assert_allclose(got.estimated_pose, ref.estimated_pose,
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.normalized_score, ref.normalized_score,
                               rtol=1e-3, atol=1e-4)


def test_host_syncs_are_counted_at_their_sites(dev):
    """Over 100 keyframes of the bb_frontend settings (synchronous
    backend) on the synthetic intel world, the ``HostSyncs.*`` counters
    equal the synchronizing operations that
    ``torch.cuda.set_sync_debug_mode("warn")`` reports, all of them from
    ``utils/device.py``'s two helpers, plus the one kind of site it does
    not report: each resolved match's CUDA event wait
    (``AsyncMatcher.resolve_async``, one per ``FrontendMatches``)."""
    import collections
    import warnings

    from my_lidar_graph_slam_tpu_torch import launcher
    from my_lidar_graph_slam_tpu_torch.io import synth
    from my_lidar_graph_slam_tpu_torch.utils import config
    from my_lidar_graph_slam_tpu_torch.utils import device as device_mod
    from my_lidar_graph_slam_tpu_torch.utils.metrics import MetricManager

    scans, _ = synth.simulate(synth.intel_world(),
                              synth.intel_waypoints(laps=1),
                              synth.SimConfig(step=0.08, seed=0))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = config.load(os.path.join(root, "configs",
                                   "launcher_settings_bb_frontend.json"))
    launcher.build_kernels(dev)
    slam = config.create_slam(cfg, device=dev, threaded_backend=False)
    MetricManager.reset_instance()
    torch.cuda.synchronize()
    keyframes = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for scan in scans:
                keyframes += slam.process_scan(scan, scan.odom_pose)
                if keyframes == 100:
                    break
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert keyframes == 100
    reported = [w for w in caught if "synchroniz" in str(w.message)]
    helpers = os.path.abspath(device_mod.__file__)
    elsewhere = collections.Counter(
        f"{w.filename}:{w.lineno}" for w in reported
        if os.path.abspath(w.filename) != helpers)
    assert not elsewhere, elsewhere
    counters = MetricManager.instance().to_dict()["Counters"]
    syncs = {k: v["value"] for k, v in counters.items()
             if k.startswith("HostSyncs.")}
    event_waits = counters["FrontendMatches"]["value"]
    assert event_waits == 99
    assert sum(syncs.values()) == len(reported) + event_waits, syncs
