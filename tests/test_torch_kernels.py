"""Parity of the port's two kernel plain versions with the JAX package's
Pallas kernels (interpret mode) and their oracles, on the CPU.

K1 (``ops/cuda/correlate.py``) against ``window_scores_mxu`` /
``window_scores_mxu_wide`` on the cases of tests/test_pallas_mxu.py:30-117;
K2 (``ops/cuda/greedy_cost.py``) against ``greedy_cost_cov_mxu`` and the
fused host oracle ``greedy_endpoint_cost_and_covariance_fused``.

Tolerances: K1 atol 1e-4 (float32 summation order); K2 cost atol 1e-4 and
covariance rtol 1e-4 / atol 1e-8, as tests/test_pallas_mxu.py:258-314.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from my_lidar_graph_slam_tpu.io import synth as jsynth
from my_lidar_graph_slam_tpu.ops import cost as jcost
from my_lidar_graph_slam_tpu.ops import grid as jgrid
from my_lidar_graph_slam_tpu.ops import matchers_mxu, raycast as jraycast
from my_lidar_graph_slam_tpu.ops.pallas import correlate_mxu as cm
from my_lidar_graph_slam_tpu.ops.pallas import greedy_cost_mxu as gc
from my_lidar_graph_slam_tpu_torch.ops.cuda import (correlate, greedy_cost,
                                                    loader)

K1_ATOL = 1e-4
K2_COST_ATOL = 1e-4
K2_COV_RTOL, K2_COV_ATOL = 1e-4, 1e-8


def _arc_indices(rng, q, nt, nb, h, w, margin):
    """Per-theta index lattices with |step| <= 1 cell drift."""
    base_ix = rng.integers(margin, w - margin, size=(q, 1, nb))
    base_iy = rng.integers(margin, h - margin, size=(q, 1, nb))
    ix = base_ix + np.cumsum(rng.integers(-1, 2, size=(q, nt, nb)), axis=1)
    iy = base_iy + np.cumsum(rng.integers(-1, 2, size=(q, nt, nb)), axis=1)
    return ix.astype(np.int32), iy.astype(np.int32)


def _k1(vm, ix, iy, wgt, win_x, win_y, map_idx=None):
    return correlate.window_scores(
        torch.from_numpy(np.array(vm, np.float32)), torch.from_numpy(ix),
        torch.from_numpy(iy), torch.from_numpy(np.array(wgt, np.float32)),
        win_x, win_y,
        None if map_idx is None else torch.from_numpy(map_idx)).numpy()


def _mxu(vm, ix, iy, wgt, win, **kw):
    return np.asarray(cm.window_scores_mxu(
        cm.make_mxu_tiles(jnp.asarray(vm)), jnp.asarray(ix),
        jnp.asarray(iy), jnp.asarray(wgt), win, win, interpret=True, **kw))


@pytest.mark.parametrize("win", [1, 2, 3])
def test_window_scores_matches_mxu(win):
    rng = np.random.default_rng(0)
    vm = rng.random((260, 300)).astype(np.float32)
    ix, iy = _arc_indices(rng, 3, 61, 23, 260, 300, margin=40)
    wgt = rng.random((3, 23)).astype(np.float32)
    np.testing.assert_allclose(_k1(vm, ix, iy, wgt, win, win),
                               _mxu(vm, ix, iy, wgt, win), rtol=0,
                               atol=K1_ATOL)


def test_window_scores_edge_reads_unknown_zero():
    rng = np.random.default_rng(1)
    h, w = 180, 150
    vm = (rng.random((h, w)) + 0.5).astype(np.float32)
    q, nt, nb = 2, 30, 8
    base = np.stack(np.meshgrid([-2, 1, h - 2, h + 3], [0, w - 1]),
                    axis=-1).reshape(-1, 2)[:nb]
    drift = np.cumsum(rng.integers(-1, 2, size=(q, nt, nb)), axis=1)
    iy = (np.broadcast_to(base[:, 0], (q, nt, nb)) + drift).astype(np.int32)
    ix = (np.broadcast_to(base[:, 1], (q, nt, nb)) + drift).astype(np.int32)
    wgt = np.ones((q, nb), np.float32)
    np.testing.assert_allclose(_k1(vm, ix, iy, wgt, 2, 2),
                               _mxu(vm, ix, iy, wgt, 2), rtol=0,
                               atol=K1_ATOL)


@pytest.mark.parametrize("nt", [1, 7, 56, 57, 111])
def test_window_scores_theta_chunk_boundaries(nt):
    rng = np.random.default_rng(2 + nt)
    vm = rng.random((200, 200)).astype(np.float32)
    ix, iy = _arc_indices(rng, 2, nt, 11, 200, 200, margin=30)
    wgt = rng.random((2, 11)).astype(np.float32)
    got = _k1(vm, ix, iy, wgt, 2, 2)
    assert got.shape == (2, nt, 5, 5)
    np.testing.assert_allclose(got, _mxu(vm, ix, iy, wgt, 2), rtol=0,
                               atol=K1_ATOL)


def test_window_scores_zero_weight_beams_do_not_contribute():
    rng = np.random.default_rng(3)
    vm = rng.random((160, 160)).astype(np.float32)
    ix, iy = _arc_indices(rng, 1, 20, 6, 160, 160, margin=20)
    wgt = np.ones((1, 6), np.float32)
    wgt[:, ::2] = 0.0
    # Zero-weight beams may lie anywhere, even far off the map.
    ix[:, :, ::2] = rng.integers(-2**30, 2**30, size=ix[:, :, ::2].shape)
    got = _k1(vm, ix, iy, wgt, 2, 2)
    ix_ok = ix.copy()
    ix_ok[:, :, ::2] = 0
    np.testing.assert_allclose(got, _mxu(vm, ix_ok, iy, wgt, 2), rtol=0,
                               atol=K1_ATOL)
    np.testing.assert_allclose(
        got, _k1(vm, ix[:, :, 1::2], iy[:, :, 1::2], wgt[:, 1::2], 2, 2),
        rtol=0, atol=K1_ATOL)


def test_window_scores_wide_window_matches_block_assembly():
    """K1 takes a 21x21 window directly; the JAX package assembles it
    from 7x7 kernel blocks."""
    rng = np.random.default_rng(5)
    vm = rng.random((220, 240)).astype(np.float32)
    ix, iy = _arc_indices(rng, 2, 25, 9, 220, 240, margin=45)
    wgt = rng.random((2, 9)).astype(np.float32)
    ref = np.asarray(matchers_mxu.window_scores_mxu_wide(
        cm.make_mxu_tiles(jnp.asarray(vm)), jnp.asarray(ix), jnp.asarray(iy),
        jnp.asarray(wgt), 10, 10, interpret=True))
    got = _k1(vm, ix, iy, wgt, 10, 10)
    assert got.shape == ref.shape == (2, 25, 21, 21)
    np.testing.assert_allclose(got, ref, rtol=0, atol=K1_ATOL)


def test_window_scores_map_idx_folding():
    rng = np.random.default_rng(6)
    maps = rng.random((2, 200, 220)).astype(np.float32)
    ix, iy = _arc_indices(rng, 4, 30, 10, 200, 220, margin=30)
    wgt = rng.random((4, 10)).astype(np.float32)
    map_idx = np.array([1, 0, 1, 1], np.int32)
    got = _k1(maps, ix, iy, wgt, 3, 3, map_idx)
    tiles = [cm.make_mxu_tiles(jnp.asarray(m)).tiles for m in maps]
    ref = np.asarray(cm.window_scores_mxu(
        cm.MxuTiles(jnp.concatenate(tiles, axis=0)), jnp.asarray(ix),
        jnp.asarray(iy), jnp.asarray(wgt), 3, 3, interpret=True,
        map_idx=jnp.asarray(map_idx), map_tile_rows=tiles[0].shape[0]))
    np.testing.assert_allclose(got, ref, rtol=0, atol=K1_ATOL)
    for q in range(4):
        np.testing.assert_allclose(
            got[q], _k1(maps[map_idx[q]], ix[q:q + 1], iy[q:q + 1],
                        wgt[q:q + 1], 3, 3)[0], rtol=0, atol=K1_ATOL)


# --------------------------------------------------------------------------
# K2
# --------------------------------------------------------------------------


def _cost_scene(n_scans, seed=0, nb=192):
    """A map of the default world and Q=4 query scans
    (tests/test_pallas_mxu.py:258-301)."""
    segs = jsynth.default_world()
    beam = np.linspace(-np.pi / 2, np.pi / 2, 181)
    g = jgrid.empty(512, 512, 0.05, center=np.array([0.0, 0.0]))
    rng = np.random.default_rng(seed)
    spread = 0.3 if n_scans <= 3 else 0.6
    for _ in range(n_scans):
        p = np.array([0.0, 0.0, 0.3]) + np.concatenate(
            [rng.uniform(-spread, spread, 2), rng.uniform(-0.2, 0.2, 1)])
        r = jsynth.raycast_segments(p[:2], p[2] + beam, segs, 20.0)
        ranges = np.zeros(nb, np.float32)
        angles = np.zeros(nb, np.float32)
        valid = np.zeros(nb, bool)
        ranges[:181] = r
        angles[:181] = beam
        valid[:181] = True
        g = jraycast.integrate_scan(
            g, jnp.asarray(p, jnp.float32), jnp.asarray(ranges),
            jnp.asarray(angles), jnp.asarray(valid), 0.01, 20.0,
            max_steps=448)
    q = 4
    poses = np.zeros((q, 3), np.float32)
    R = np.zeros((q, nb), np.float32)
    A = np.zeros((q, nb), np.float32)
    M = np.zeros((q, nb), np.float32)
    for qi in range(q):
        p = np.array([0.0, 0.0, 0.3]) + np.concatenate(
            [rng.uniform(-0.2, 0.2, 2), rng.uniform(-0.15, 0.15, 1)])
        r = jsynth.raycast_segments(p[:2], p[2] + beam, segs, 20.0)
        poses[qi] = p
        R[qi, :181] = r + rng.normal(0, 0.01, r.shape)
        A[qi, :181] = beam
        M[qi, :181] = (r > 0.05) & (r < 19.0)
    return g, np.array(jgrid.values(g)), poses, R, A, M


def _k2(vm, origin, poses, R, A, M, map_idx=None, **kw):
    c, cov = greedy_cost.greedy_cost_cov(
        torch.tensor(np.asarray(vm)), torch.tensor(np.asarray(origin,
                                                              np.float32)),
        torch.from_numpy(poses), torch.from_numpy(R), torch.from_numpy(A),
        torch.from_numpy(M), 0.05,
        map_idx=None if map_idx is None else torch.from_numpy(map_idx),
        **kw)
    return c.numpy(), cov.numpy()


def _fused(g, vals, poses, R, A, M, **kw):
    out = [jcost.greedy_endpoint_cost_and_covariance_fused(
        jnp.asarray(vals), g, jnp.asarray(poses[q]), jnp.asarray(R[q]),
        jnp.asarray(A[q]), jnp.asarray(M[q]), **kw)
        for q in range(poses.shape[0])]
    return (np.array([float(c) for c, _ in out]),
            np.stack([np.asarray(v) for _, v in out]))


def _assert_k2(got, ref, cov_atol=K2_COV_ATOL, cov_rtol=K2_COV_RTOL):
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=K2_COST_ATOL)
    np.testing.assert_allclose(got[1], ref[1], rtol=cov_rtol, atol=cov_atol)


def test_greedy_cost_matches_mxu_and_fused():
    g, vals, poses, R, A, M = _cost_scene(3)
    got = _k2(vals, np.asarray(g.origin), poses, R, A, M)
    c_k, cov_k = gc.greedy_cost_cov_mxu(
        gc.make_cost_tiles(jnp.asarray(vals)), g.origin, jnp.asarray(poses),
        jnp.asarray(R), jnp.asarray(A), jnp.asarray(M), resolution=0.05,
        interpret=True)
    _assert_k2(got, (np.asarray(c_k), np.asarray(cov_k)))
    _assert_k2(got, _fused(g, vals, poses, R, A, M, kernel_size=1))


def test_greedy_cost_per_query_origin_and_folding():
    """Two maps folded into one call through map_idx, each query with its
    own map's origin, against the folded Pallas kernel."""
    g, vals, poses, R, A, M = _cost_scene(3)
    vals2 = vals[::-1].copy()
    origins = np.stack([np.asarray(g.origin),
                        np.asarray(g.origin) + np.float32(0.35)])
    map_idx = np.array([0, 1, 1, 0], np.int32)
    got = _k2(np.stack([vals, vals2]), origins[map_idx], poses, R, A, M,
              map_idx=map_idx)
    tiles = [gc.make_cost_tiles(jnp.asarray(v)).tiles for v in (vals, vals2)]
    c_k, cov_k = gc.greedy_cost_cov_mxu(
        gc.CostTiles(jnp.concatenate(tiles, axis=0)),
        jnp.asarray(origins[map_idx]), jnp.asarray(poses), jnp.asarray(R),
        jnp.asarray(A), jnp.asarray(M), resolution=0.05, interpret=True,
        map_idx=jnp.asarray(map_idx), map_tile_rows=tiles[0].shape[0])
    _assert_k2(got, (np.asarray(c_k), np.asarray(cov_k)))
    for q in range(4):
        one = _k2([vals, vals2][map_idx[q]], origins[map_idx[q]],
                  poses[q:q + 1], R[q:q + 1], A[q:q + 1], M[q:q + 1])
        _assert_k2((got[0][q:q + 1], got[1][q:q + 1]), one)


@pytest.mark.parametrize("kernel_size", [1, 2])
def test_greedy_cost_informative_map_matches_fused(kernel_size):
    """A map built from 25 scans, where kernel cells are usable and the
    gradient is not zero. The cost is held at atol 1e-4. The covariance is
    g g^T + 0.01 I, and the two sides sum the cost's beams in different
    orders: one float32 ulp of the cost enters the theta gradient times
    1/(2 * 0.01), so its entries are held at rtol 1e-4 of the largest."""
    g, vals, poses, R, A, M = _cost_scene(25)
    kw = dict(kernel_size=kernel_size, standard_deviation=0.05)
    got = _k2(vals, np.asarray(g.origin), poses, R, A, M, **kw)
    ref = _fused(g, vals, poses, R, A, M, **kw)
    assert np.abs(ref[1] - 0.01 * np.eye(3)).max() > 1.0  # informative
    _assert_k2(got, ref, cov_atol=1e-4 * np.abs(ref[1]).max(), cov_rtol=0)


def test_greedy_cost_out_of_tpu_envelope_matches_fused():
    """usable_range_max = 40 m overflows the Pallas kernel's 17-row tile
    (greedy_cost_mxu.envelope_ok is False); the port has no envelope."""
    assert not gc.envelope_ok(0.05, 40.0, 0.075, 1)
    g, vals, poses, R, A, M = _cost_scene(3)
    R = np.where(M > 0, R * 2.0, R).astype(np.float32)  # beams to ~40 m
    M = (M > 0) & (R < 40.0)
    M = M.astype(np.float32)
    got = _k2(vals, np.asarray(g.origin), poses, R, A, M)
    _assert_k2(got, _fused(g, vals, poses, R, A, M, kernel_size=1))


# --------------------------------------------------------------------------
# K1 launch geometry (computed in Python, launched on the card)
# --------------------------------------------------------------------------

SHARED_LIMIT = 227 * 1024        # a block's shared memory on an H100
STATIC_SHARED_LIMIT = 48 * 1024  # without the opt-in attribute


@pytest.mark.parametrize("nb,win_x,win_y,q,nt", [
    (384, 2, 2, 1, 201),          # default config, frontend
    (384, 20, 20, 4, 401),        # default config, detection
    (1024, 2, 2, 1, 201),         # beam capacity, frontend
    (1024, 20, 20, 8, 401),       # beam capacity, detection
    (1500, 2, 2, 2, 17),          # two beam chunks
    (64, 40, 30, 1, 3),           # a wide window: several passes
    (384, 3, 10, 2, 17),          # non-square, several rows per thread
    (384, 0, 0, 1, 1),            # one cell
    (1, 1, 1, 1, 1),
    (4096, 100, 100, 1, 65536),
])
def test_window_scores_launch_geometry_fits_the_card(nb, win_x, win_y, q,
                                                     nt):
    g = correlate.launch_geometry(nb, win_x, win_y)
    wxn, wyn = 2 * win_x + 1, 2 * win_y + 1
    assert 1 <= g.rows <= 8 and g.slots % 32 == 0
    assert 32 <= g.threads == g.splits * g.slots <= 512
    # Every output has a slot in some pass.
    assert g.passes * g.slots >= wxn * -(-wyn // g.rows)
    assert 1 <= g.chunk <= max(nb, 1)
    assert g.shared_bytes <= STATIC_SHARED_LIMIT <= SHARED_LIMIT
    assert (g.rows, g.splits) == {(2, 2): (1, 8), (20, 20): (7, 1)}.get(
        (win_x, win_y), (g.rows, g.splits))


@pytest.mark.parametrize("map_shape,cells_shape", [
    ((46341, 46341), (1, 1, 4)),      # H * W = 2^31 + 1 cells
    ((2, 2), (2, 2 ** 30, 1)),        # Q * NT = 2^31 blocks
])
def test_window_scores_refuses_int32_overflow(map_shape, cells_shape):
    """The kernel addresses a map with int32 offsets and launches one block
    per (q, theta): the wrapper refuses larger inputs before any launch.
    Meta tensors carry the shapes without memory."""
    q, _, nb = cells_shape
    vm = torch.empty(map_shape, dtype=torch.float32, device="meta")
    ix = torch.empty(cells_shape, dtype=torch.int32, device="meta")
    w = torch.empty((q, nb), dtype=torch.float32, device="meta")
    before = correlate.window_scores.launches
    with pytest.raises(ValueError, match="below 2"):
        correlate.window_scores(vm, ix, ix, w, 1, 1)
    assert correlate.window_scores.launches == before


def test_library_name_follows_included_headers(tmp_path, monkeypatch):
    """A library is named by its source and every local header it
    includes, so editing a shared header rebuilds it."""
    (tmp_path / "a.cu").write_text('#include "h.cuh"\nint a;\n')
    (tmp_path / "h.cuh").write_text('#include "g.cuh"\nint h;\n')
    (tmp_path / "g.cuh").write_text("int g;\n")
    monkeypatch.setattr(loader, "CSRC", str(tmp_path))
    before = loader._target("a")
    assert loader._target("a") == before
    (tmp_path / "g.cuh").write_text("int g2;\n")
    after_g = loader._target("a")
    (tmp_path / "h.cuh").write_text('#include "g.cuh"\nint h2;\n')
    assert len({before, after_g, loader._target("a")}) == 3


# --------------------------------------------------------------------------
# K3, the ray-cast kernel's wrapper: what it refuses, on the CPU.
# --------------------------------------------------------------------------


def _k3_args(m=2, k=3, nb=5, size=16, device="cpu"):
    f = dict(dtype=torch.float32, device=device)
    return dict(
        log_odds=torch.zeros((m, size, size), **f),
        observed=torch.zeros((m, size, size), dtype=torch.bool,
                             device=device),
        origins=torch.zeros((m, 2), **f),
        sensor_poses=torch.zeros((m, k, 3), **f),
        ranges=torch.ones((m, k, nb), **f),
        angles=torch.zeros((m, k, nb), **f),
        valid=torch.ones((m, k, nb), dtype=torch.bool, device=device),
        active=torch.ones((m, k), dtype=torch.bool, device=device),
        range_min=torch.zeros((m, k), **f),
        range_max=torch.full((m, k), 10.0, **f),
        lo_miss=torch.tensor(-0.2, **f), lo_hit=torch.tensor(0.4, **f),
        resolution=0.05, max_steps=8, lo_max=6.9)


def _k3_bad(case):
    a = _k3_args()
    if case == "cpu":
        return a, "runs on CUDA, not cpu"
    if case == "meta":
        return _k3_args(device="meta"), "runs on CUDA, not meta"
    if case == "dtype":
        a["ranges"] = a["ranges"].double()
        return a, "ranges must be torch.float32"
    if case == "observed_dtype":
        a["observed"] = a["observed"].to(torch.uint8)
        return a, "observed must be torch.bool"
    if case == "shape":
        a["angles"] = a["angles"][:, :, :4]
        return a, r"angles must have shape \(2, 3, 5\)"
    if case == "map_shape":
        a["observed"] = a["observed"][:, :8]
        return a, r"observed must have shape \(2, 16, 16\)"
    if case == "non_contiguous":
        a["ranges"] = a["ranges"].transpose(1, 2).contiguous().transpose(1, 2)
        return a, "ranges must be contiguous"
    if case == "mixed_devices":
        a["lo_hit"] = a["lo_hit"].to("meta")
        return a, "one device"
    if case == "beams":
        a = _k3_args(nb=65536, size=2)
        return a, "at most 65535 beams"
    raise ValueError(case)


@pytest.mark.parametrize("case", ["cpu", "meta", "dtype", "observed_dtype",
                                  "shape", "map_shape", "non_contiguous",
                                  "mixed_devices", "beams"])
def test_raycast_wrapper_refuses_before_loading_the_library(case,
                                                            monkeypatch):
    """K3's wrapper takes contiguous float32/bool tensors of the documented
    shapes on one CUDA device and raises on anything else before it loads
    (or builds) the library."""
    from my_lidar_graph_slam_tpu_torch.ops.cuda import raycast as k3
    from my_lidar_graph_slam_tpu_torch.utils.metrics import MetricManager

    def no_library(name):
        raise AssertionError(f"library {name} loaded")

    monkeypatch.setattr(loader, "library", no_library)
    MetricManager.reset_instance()
    args, message = _k3_bad(case)
    with pytest.raises(ValueError, match=message):
        k3.integrate(**args)
    assert "RaycastKernelLaunches" not in \
        MetricManager.instance().to_dict()["Counters"]


def test_raycast_on_the_cpu_takes_the_plain_path(monkeypatch):
    """CPU tensors cast through the plain path (``RaycastPlainScans``
    counts every scan row, the kernel's counters stay absent) and never
    load the library; any device but the CPU and CUDA raises."""
    from my_lidar_graph_slam_tpu_torch.ops import grid as tgrid
    from my_lidar_graph_slam_tpu_torch.ops import raycast as traycast
    from my_lidar_graph_slam_tpu_torch.utils.metrics import MetricManager

    def no_library(name):
        raise AssertionError(f"library {name} loaded")

    monkeypatch.setattr(loader, "library", no_library)
    MetricManager.reset_instance()
    g = tgrid.empty(64, 64, 0.05, center=(0.0, 0.0), device="cpu")
    angles = torch.linspace(-1.5, 1.5, 31)
    g = traycast.integrate_scan(
        g, torch.tensor([0.1, -0.2, 0.3]), torch.full((31,), 1.2), angles,
        torch.ones(31, dtype=torch.bool), 0.1, 10.0, max_steps=64)
    assert int(g.observed.sum()) > 31
    a = _k3_args(m=2, k=3, nb=31, size=64)
    out = traycast.integrate_scans_stacked(
        a["log_odds"], a["observed"], a["origins"] - 1.6, 0.05,
        a["sensor_poses"], a["ranges"], angles.expand(2, 3, 31),
        a["valid"], a["sensor_poses"], a["range_min"], a["range_max"],
        a["active"], max_steps=64)
    assert int(out[1].sum()) > 31
    counters = MetricManager.instance().to_dict()["Counters"]
    assert counters["RaycastPlainScans"]["value"] == 1 + 2 * 3
    assert "RaycastKernelScans" not in counters
    assert "RaycastKernelLaunches" not in counters
    meta = _k3_args(device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        traycast.integrate_scans_stacked(
            meta["log_odds"], meta["observed"], meta["origins"], 0.05,
            meta["sensor_poses"], meta["ranges"], meta["angles"],
            meta["valid"], meta["sensor_poses"], meta["range_min"],
            meta["range_max"])
