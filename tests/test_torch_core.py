"""Parity of the PyTorch port's core modules with the JAX package on the CPU:
SE(2) algebra, grid maps, ray-cast integration, the synthetic log writer,
the CARMEN reader and the config factory.

Inputs are made with NumPy from a seed and handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from my_lidar_graph_slam_tpu.io import carmen as jcarmen
from my_lidar_graph_slam_tpu.io import synth as jsynth
from my_lidar_graph_slam_tpu.ops import grid as jgrid
from my_lidar_graph_slam_tpu.ops import raycast as jraycast
from my_lidar_graph_slam_tpu.utils import config as jconfig
from my_lidar_graph_slam_tpu.utils import se2 as jse2
from my_lidar_graph_slam_tpu_torch import interop
from my_lidar_graph_slam_tpu_torch.io import carmen as tcarmen
from my_lidar_graph_slam_tpu_torch.io import synth as tsynth
from my_lidar_graph_slam_tpu_torch.models import map_builder as tmb
from my_lidar_graph_slam_tpu_torch.ops import grid as tgrid
from my_lidar_graph_slam_tpu_torch.ops import raycast as traycast
from my_lidar_graph_slam_tpu_torch.utils import config as tconfig
from my_lidar_graph_slam_tpu_torch.utils import device as tdevice
from my_lidar_graph_slam_tpu_torch.utils import se2 as tse2

MAP_ATOL = 1e-5


def t32(a):
    return torch.as_tensor(np.asarray(a, np.float32))


# --------------------------------------------------------------------------
# SE(2) (the cases of tests/test_se2.py)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(5))
def test_se2_matches_jax(seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-5, 5, size=(16, 3))
    b = rng.uniform(-5, 5, size=(16, 3))
    for tfn, jfn in ((tse2.compound, jse2.compound),
                     (tse2.inverse_compound, jse2.inverse_compound),
                     (tse2.move_backward, jse2.move_backward)):
        got = tfn(t32(a), t32(b)).numpy()
        ref = np.asarray(jfn(jnp.asarray(a, jnp.float32),
                             jnp.asarray(b, jnp.float32)))
        np.testing.assert_allclose(got, ref, atol=1e-5)
    # Round trips, as tests/test_se2.py checks them.
    ab = tse2.compound(t32(a), t32(b))
    np.testing.assert_allclose(tse2.inverse_compound(t32(a), ab).numpy(),
                               b, atol=1e-4)
    np.testing.assert_allclose(tse2.move_backward(ab, t32(b)).numpy(), a,
                               atol=1e-4)


def test_normalize_angle_matches_jax():
    vals = np.array([0.0, np.pi + 0.1, -np.pi - 0.1, 7.0, -7.0, 2 * np.pi])
    got = tse2.normalize_angle(t32(vals)).numpy()
    ref = np.asarray(jse2.normalize_angle(jnp.asarray(vals, jnp.float32)))
    np.testing.assert_allclose(got, ref, atol=1e-6)
    assert np.all(got <= np.pi + 1e-6) and np.all(got >= -np.pi - 1e-6)


# --------------------------------------------------------------------------
# Grid
# --------------------------------------------------------------------------


def _random_grid(seed, h=96, w=80):
    rng = np.random.default_rng(seed)
    lo = rng.normal(0.0, 3.0, (h, w)).astype(np.float32)
    ob = rng.random((h, w)) < 0.7
    center = rng.uniform(-3, 3, 2)
    jg = jgrid.empty(h, w, 0.05, center=center)
    jg = jg._replace(log_odds=jnp.asarray(lo), observed=jnp.asarray(ob))
    tg = tgrid.empty(h, w, 0.05, center=center, device="cpu")
    tg = tg._replace(log_odds=torch.from_numpy(lo),
                     observed=torch.from_numpy(ob))
    return rng, jg, tg


def test_grid_values_world_to_cell_lookup():
    rng, jg, tg = _random_grid(0)
    np.testing.assert_array_equal(tg.origin.numpy(), np.asarray(jg.origin))
    np.testing.assert_allclose(tgrid.values(tg).numpy(),
                               np.asarray(jgrid.values(jg)), atol=1e-7)

    pts = rng.uniform(-6, 6, (500, 2)).astype(np.float32)
    tix, tiy = tgrid.world_to_cell(tg, torch.from_numpy(pts))
    jix, jiy = jgrid.world_to_cell(jg, jnp.asarray(pts))
    np.testing.assert_array_equal(tix.numpy(), np.asarray(jix))
    np.testing.assert_array_equal(tiy.numpy(), np.asarray(jiy))
    np.testing.assert_array_equal(
        tgrid.in_bounds(tg, tix, tiy).numpy(),
        np.asarray(jgrid.in_bounds(jg, jix, jiy)))

    vm = np.array(jgrid.values(jg))
    got = tgrid.lookup(torch.from_numpy(vm), tix, tiy).numpy()
    ref = np.asarray(jgrid.lookup(jnp.asarray(vm), jix, jiy))
    np.testing.assert_array_equal(got, ref)


# --------------------------------------------------------------------------
# Ray casting
# --------------------------------------------------------------------------


def _scans(seed, k, nb=192, n_real=181, max_range=12.0):
    """K scans of the default world from poses near the origin."""
    rng = np.random.default_rng(seed)
    segs = jsynth.default_world()
    beam = np.linspace(-np.pi / 2, np.pi / 2, n_real)
    poses = np.zeros((k, 3), np.float32)
    ranges = np.zeros((k, nb), np.float32)
    angles = np.zeros((k, nb), np.float32)
    valid = np.zeros((k, nb), bool)
    for i in range(k):
        p = np.concatenate([rng.uniform(-0.6, 0.6, 2),
                            rng.uniform(-0.5, 0.5, 1)])
        r = jsynth.raycast_segments(p[:2], p[2] + beam, segs, max_range)
        poses[i] = p
        ranges[i, :n_real] = r + rng.normal(0.0, 0.01, n_real)
        angles[i, :n_real] = beam
        valid[i, :n_real] = True
    return poses, ranges, angles, valid


def test_trace_cells_matches_jax():
    poses, ranges, angles, valid = _scans(1, 2)
    jg = jgrid.empty(256, 256, 0.05, center=np.array([0.3, -0.2]))
    tg = tgrid.empty(256, 256, 0.05, center=np.array([0.3, -0.2]),
                     device="cpu")
    for i in range(2):
        ref = jraycast.trace_cells(
            jg, jnp.asarray(poses[i]), jnp.asarray(ranges[i]),
            jnp.asarray(angles[i]), jnp.asarray(valid[i]), 0.01, 10.0, 256)
        got = traycast.trace_cells(
            tg, torch.from_numpy(poses[i]), torch.from_numpy(ranges[i]),
            torch.from_numpy(angles[i]), torch.from_numpy(valid[i]),
            0.01, 10.0, 256)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy().reshape(-1),
                                          np.asarray(b))


def test_integrate_scan_matches_jax():
    poses, ranges, angles, valid = _scans(2, 4)
    jg = jgrid.empty(512, 512, 0.05, center=np.zeros(2))
    tg = tgrid.empty(512, 512, 0.05, center=np.zeros(2), device="cpu")
    for i in range(4):
        jg = jraycast.integrate_scan(
            jg, jnp.asarray(poses[i]), jnp.asarray(ranges[i]),
            jnp.asarray(angles[i]), jnp.asarray(valid[i]), 0.01, 12.0,
            max_steps=256)
        tg = traycast.integrate_scan(
            tg, torch.from_numpy(poses[i]), torch.from_numpy(ranges[i]),
            torch.from_numpy(angles[i]), torch.from_numpy(valid[i]),
            0.01, 12.0, max_steps=256)
    np.testing.assert_allclose(tg.log_odds.numpy(), np.asarray(jg.log_odds),
                               rtol=0, atol=MAP_ATOL)
    np.testing.assert_array_equal(tg.observed.numpy(),
                                  np.asarray(jg.observed))


def test_integrate_scans_matches_jax():
    """Scan order matters (clamp after each scan): many repeated scans
    saturate cells, and the batched call must equal the JAX scan loop."""
    poses, ranges, angles, valid = _scans(3, 12)
    rel = np.zeros((12, 3), np.float32)
    rel[:, 0] = 0.1                       # sensor ahead of the robot
    rmin = np.full(12, 0.01, np.float32)
    rmax = np.full(12, 12.0, np.float32)
    active = np.ones(12, bool)
    active[7] = False
    jg = jraycast.integrate_scans(
        jgrid.empty(400, 400, 0.05, center=np.zeros(2)),
        jnp.asarray(poses), jnp.asarray(ranges), jnp.asarray(angles),
        jnp.asarray(valid), jnp.asarray(rel), jnp.asarray(rmin),
        jnp.asarray(rmax), scan_active=jnp.asarray(active), max_steps=256)
    tg = traycast.integrate_scans(
        tgrid.empty(400, 400, 0.05, center=np.zeros(2), device="cpu"),
        *(torch.from_numpy(a) for a in (poses, ranges, angles, valid, rel,
                                        rmin, rmax)),
        scan_active=torch.from_numpy(active), max_steps=256)
    np.testing.assert_allclose(tg.log_odds.numpy(), np.asarray(jg.log_odds),
                               rtol=0, atol=MAP_ATOL)
    np.testing.assert_array_equal(tg.observed.numpy(),
                                  np.asarray(jg.observed))
    assert np.abs(tg.log_odds.numpy()).max() == pytest.approx(
        tgrid.LOG_ODDS_MAX, rel=1e-6)


# --------------------------------------------------------------------------
# Synthetic log, CARMEN reader, config
# --------------------------------------------------------------------------


def test_synth_log_byte_identical(tmp_path):
    wps = jsynth.intel_waypoints(laps=1)[:3]
    np.testing.assert_array_equal(tsynth.intel_waypoints(laps=1)[:3], wps)
    np.testing.assert_array_equal(tsynth.intel_world(), jsynth.intel_world())
    cfg_j = jsynth.SimConfig(step=0.08, seed=7)
    cfg_t = tsynth.SimConfig(step=0.08, seed=7)
    js, jgt = jsynth.simulate(world=jsynth.intel_world(), waypoints=wps,
                              config=cfg_j)
    ts, tgt = tsynth.simulate(tsynth.intel_world(), wps, cfg_t)
    np.testing.assert_array_equal(tgt, jgt)
    jsynth.write_carmen_log(str(tmp_path / "j.clf"), js)
    tsynth.write_carmen_log(str(tmp_path / "t.clf"), ts)
    assert (tmp_path / "j.clf").read_bytes() == \
        (tmp_path / "t.clf").read_bytes()

    jr = jcarmen.load(str(tmp_path / "j.clf"))
    tr = tcarmen.load(str(tmp_path / "t.clf"))
    assert len(jr) == len(tr) == len(js)
    for a, b in zip(jr, tr):
        assert a.timestamp == b.timestamp
        np.testing.assert_array_equal(a.ranges, b.ranges)
        np.testing.assert_array_equal(a.angles, b.angles)
        np.testing.assert_array_equal(a.odom_pose, b.odom_pose)
        np.testing.assert_array_equal(a.rel_sensor_pose, b.rel_sensor_pose)


def test_default_config_builds_the_same_components():
    path = "configs/launcher_settings_default.json"
    js = jconfig.create_slam(jconfig.load(path))
    ts = tconfig.create_slam(tconfig.load(path), device="cpu")
    assert ts.device == torch.device("cpu")
    for name in ("range_x", "range_y", "range_theta", "scan_range_max",
                 "usable_range_min", "usable_range_max", "greedy_params"):
        assert getattr(ts.frontend.matcher, name) == \
            getattr(js.frontend.matcher, name)
    for name in ("score_threshold", "range_x", "range_y", "range_theta",
                 "scan_range_max", "usable_range_min", "usable_range_max",
                 "greedy_params"):
        assert getattr(ts.backend.detector, name) == \
            getattr(js.backend.detector, name)
    assert vars(ts.builder.config) == vars(js.builder.config)
    assert vars(ts.frontend.config).keys() == vars(js.frontend.config).keys()
    assert ts.backend.lm_config.loss_scale == js.backend.lm_config.loss_scale
    assert ts.scans.beam_capacity == js.scans.beam_capacity


def test_device_defaults_to_cuda_without_fallback():
    assert tdevice.resolve("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert tdevice.resolve(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            tdevice.resolve(None)
        with pytest.raises(RuntimeError):
            tconfig.create_slam(
                tconfig.load("configs/launcher_settings_default.json"))


_MAKERS = {
    "grid": lambda **kw: tgrid.empty(8, 8, 0.05, **kw).device,
    "interop": lambda **kw: interop.grid_from_numpy(
        np.zeros((8, 8)), np.zeros((8, 8), bool), np.zeros(2), 0.05,
        **kw).device,
    "builder": lambda **kw: tmb.GridMapBuilder(
        tmb.MapBuilderConfig(), tmb.ScanStore(64), **kw).device,
}


@pytest.mark.parametrize("make", sorted(_MAKERS))
def test_map_entry_points_default_to_cuda(make):
    """No device means cuda for the map builder, an empty grid and a grid
    handed over through interop: without a card they raise, and they run
    on the CPU only when asked."""
    fn = _MAKERS[make]
    assert fn(device="cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert fn().type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            fn()


def test_unported_strategies_raise():
    cfg = tconfig.load("configs/launcher_settings_default.json")
    with pytest.raises(NotImplementedError):
        tconfig.create_scan_matcher(cfg, "HillClimbing",
                                    "ScanMatcherHillClimbing")
    with pytest.raises(NotImplementedError):
        tconfig.create_loop_detector(cfg, "GridSearch",
                                     "LoopDetectorGridSearch")
