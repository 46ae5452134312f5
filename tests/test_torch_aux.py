"""The port's counting cells, motion model, SE(2) helpers, synthetic worlds
and native CARMEN reader against the JAX package, on the CPU.

Tolerances: counting integration bit-equal (whole-number counts); the
motion model's velocities, variances and covariances within 1e-6
(float32 on both sides), its poses from the same normals within 1e-6
plus, in x and y, one float32 epsilon times the arc radius; SE(2)
helpers within 1e-6; every synthetic array bit-equal and every written
log byte-equal (both packages compute them in NumPy); the native reader
within tests/test_aux.py:155-169's tolerances of the Python reader
(ranges 1e-4, its float32 buffer; poses 1e-9).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from my_lidar_graph_slam_tpu.io import carmen as jcarmen
from my_lidar_graph_slam_tpu.io import synth as jsynth
from my_lidar_graph_slam_tpu.models import motion_model as jmm
from my_lidar_graph_slam_tpu.ops import grid as jgrid
from my_lidar_graph_slam_tpu.ops import raycast as jraycast
from my_lidar_graph_slam_tpu.sensor.data import RawScan as JRawScan
from my_lidar_graph_slam_tpu.utils import se2 as jse2
from my_lidar_graph_slam_tpu_torch.io import carmen as tcarmen
from my_lidar_graph_slam_tpu_torch.io import synth as tsynth
from my_lidar_graph_slam_tpu_torch.models import motion_model as tmm
from my_lidar_graph_slam_tpu_torch.ops import grid as tgrid
from my_lidar_graph_slam_tpu_torch.ops import raycast as traycast
from my_lidar_graph_slam_tpu_torch.sensor.data import RawScan
from my_lidar_graph_slam_tpu_torch.utils import se2 as tse2
from tests.test_torch_matcher import one_torch_thread  # noqa: F401


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


# --------------------------------------------------------------------------
# Counting cells
# --------------------------------------------------------------------------


def test_counting_integration_is_bit_equal_to_jax():
    segs = jsynth.default_world()
    beam = np.linspace(-np.pi / 2, np.pi / 2, 181)
    rng = np.random.default_rng(4)
    jg = jgrid.counting_empty(256, 256, 0.05, center=np.array([-6.0, -4.0]))
    tg = tgrid.counting_empty(256, 256, 0.05, center=np.array([-6.0, -4.0]),
                              device="cpu")
    np.testing.assert_array_equal(tg.origin.numpy(), np.asarray(jg.origin))
    for _ in range(4):
        pose = np.array([-6.0, -4.0, 0.3]) + rng.uniform(-0.5, 0.5, 3)
        r = jsynth.raycast_segments(pose[:2], pose[2] + beam, segs, 9.0)
        args = (pose.astype(np.float32), r.astype(np.float32),
                beam.astype(np.float32), np.ones(181, bool))
        jg = jraycast.integrate_scan_counting(
            jg, *(jnp.asarray(a) for a in args), 0.01, 8.0, max_steps=192)
        tg = traycast.integrate_scan_counting(
            tg, *(torch.from_numpy(a) for a in args), 0.01, 8.0,
            max_steps=192)
    np.testing.assert_array_equal(tg.hits.numpy(), np.asarray(jg.hits))
    np.testing.assert_array_equal(tg.counts.numpy(), np.asarray(jg.counts))
    assert tg.counts.sum() > 1000 and tg.hits.sum() > 100
    np.testing.assert_allclose(tgrid.counting_values(tg).numpy(),
                               np.asarray(jgrid.counting_values(jg)),
                               rtol=1e-7)
    ix, iy = np.array([0, 17, 255]), np.array([3, 100, 0])
    for a, b in zip(tgrid.cell_to_world(tg, torch.from_numpy(ix),
                                        torch.from_numpy(iy)),
                    jgrid.cell_to_world(jg, jnp.asarray(ix), jnp.asarray(iy))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-7)


# --------------------------------------------------------------------------
# Motion model
# --------------------------------------------------------------------------

MODELS = {"alpha": (jmm.AlphaCoefficients(), tmm.AlphaCoefficients()),
          "stddev": (jmm.StandardDeviations(), tmm.StandardDeviations())}
MOTIONS = [([1.0, 2.0, 0.5], [0.4, 0.0, 0.05]),
           ([-3.0, 0.5, 2.9], [0.05, -0.02, -0.3]),
           ([0.0, 0.0, -1.0], [0.0, 0.0, 0.0])]


@pytest.mark.parametrize("params", sorted(MODELS))
@pytest.mark.parametrize("motion", range(len(MOTIONS)))
def test_motion_model_matches_jax(params, motion):
    jparams, tparams = MODELS[params]
    jm, tm = jmm.MotionModelVelocity(jparams), tmm.MotionModelVelocity(tparams)
    prev, rel = MOTIONS[motion]
    dt = 0.1
    for a, b in zip(tm.velocities(_t(rel), dt),
                    jm.velocities(jnp.asarray(rel, jnp.float32), dt)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    tv, av = tm.velocities(_t(rel), dt)
    for a, b in zip(tparams.variances(tv, av, dt),
                    jparams.variances(jnp.asarray(tv.numpy()),
                                      jnp.asarray(av.numpy()), dt)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)

    cov0 = np.diag([1e-4, 2e-4, 3e-5]).astype(np.float32)
    np.testing.assert_allclose(
        tm.compute_covariance(_t(prev), _t(rel), dt, _t(cov0)).numpy(),
        np.asarray(jm.compute_covariance(jnp.asarray(prev, jnp.float32),
                                         jnp.asarray(rel, jnp.float32), dt,
                                         jnp.asarray(cov0))),
        rtol=1e-6, atol=1e-12)

    # Poses from JAX's own normals (sample_poses splits its key in two).
    key = jax.random.PRNGKey(motion)
    n = 64
    k1, k2 = jax.random.split(key)
    noise = np.stack([np.asarray(jax.random.normal(k1, (n,))),
                      np.asarray(jax.random.normal(k2, (n,)))])
    ref = jm.sample_poses(key, jnp.asarray(prev, jnp.float32),
                          jnp.asarray(rel, jnp.float32), dt, n)
    got = tm.poses_from_noise(_t(prev), _t(rel), dt, _t(noise))
    # The arc form subtracts radius * sin terms: one float32 ulp of a sine
    # becomes ulp * radius in x and y (the reference clamps a negative
    # angular velocity to 0.01 rad/s, so radii reach tens of meters).
    tvar, avar = tparams.variances(tv, av, dt)
    radius = np.abs((tv + torch.sqrt(tvar) * _t(noise[0])) /
                    (av + torch.sqrt(avar) * _t(noise[1]))).numpy()
    err = np.abs(got.numpy() - np.asarray(ref))
    np.testing.assert_array_less(
        err, 1e-6 + np.float32(np.finfo(np.float32).eps) *
        np.maximum(radius, 1.0)[:, None] * np.array([1.0, 1.0, 0.0]) + 1e-12)


def test_motion_model_sampling_statistics():
    """tests/test_aux.py:72's checks with the port's generator."""
    mm = tmm.MotionModelVelocity(tmm.AlphaCoefficients(
        alpha_trans=0.01, alpha_angular=0.01))
    gen = torch.Generator().manual_seed(0)
    prev = _t([1.0, 2.0, 0.5])
    s = mm.sample_poses(gen, prev, _t([0.4, 0.0, 0.05]), 0.1, 512).numpy()
    assert s.shape == (512, 3)
    disp = s[:, :2] - prev[:2].numpy()
    d = np.hypot(disp[:, 0], disp[:, 1]).mean()
    assert 0.3 < d < 0.5
    assert s[:, 2].std() > 0.0
    again = mm.sample_poses(torch.Generator().manual_seed(0), prev,
                            _t([0.4, 0.0, 0.05]), 0.1, 512).numpy()
    np.testing.assert_array_equal(s, again)


# --------------------------------------------------------------------------
# SE(2)
# --------------------------------------------------------------------------


def test_se2_helpers_match_jax():
    rng = np.random.default_rng(9)
    p = rng.uniform(-7.0, 7.0, (6, 3)).astype(np.float32)
    d = rng.uniform(-2.0, 2.0, (6, 3)).astype(np.float32)
    a = rng.normal(size=(6, 3, 3)).astype(np.float32)
    cov = a @ a.transpose(0, 2, 1)
    pairs = [
        (tse2.normalize_pose(_t(p)), jse2.normalize_pose(jnp.asarray(p))),
        (tse2.move_forward(_t(p), _t(d)),
         jse2.move_forward(jnp.asarray(p), jnp.asarray(d))),
        (tse2.rotation_matrix(_t(p[:, 2])),
         jse2.rotation_matrix(jnp.asarray(p[:, 2]))),
        (tse2.rotate_covariance(_t(p[:, 2]), _t(cov)),
         jse2.rotate_covariance(jnp.asarray(p[:, 2]), jnp.asarray(cov))),
        (tse2.covariance_world_to_robot(_t(p), _t(cov)),
         jse2.covariance_world_to_robot(jnp.asarray(p), jnp.asarray(cov))),
        (tse2.covariance_robot_to_world(_t(p), _t(cov)),
         jse2.covariance_robot_to_world(jnp.asarray(p), jnp.asarray(cov))),
        (tse2.distance(_t(p)), jse2.distance(jnp.asarray(p))),
        (tse2.distance(_t(p), _t(d)),
         jse2.distance(jnp.asarray(p), jnp.asarray(d)))]
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6)


# --------------------------------------------------------------------------
# Synthetic worlds and logs
# --------------------------------------------------------------------------

WORLDS = ["default_world", "intel_world", "aces_world", "killian_world",
          "mini_world"]
ROUTES = [("loop_waypoints", {}), ("mini_loop_waypoints", {}),
          ("intel_waypoints", {"laps": 3}), ("aces_waypoints", {"laps": 1}),
          ("killian_waypoints", {"laps": 2})]


@pytest.mark.parametrize("name", WORLDS + [r for r, _ in ROUTES])
def test_synthetic_arrays_equal_jax(name):
    kw = dict(ROUTES).get(name, {})
    np.testing.assert_array_equal(getattr(tsynth, name)(**kw),
                                  getattr(jsynth, name)(**kw))


@pytest.mark.parametrize("profile", sorted(jsynth.ADVERSARIAL_PROFILES))
def test_adversarial_profiles_simulate_like_jax(profile):
    assert tsynth.ADVERSARIAL_PROFILES == jsynth.ADVERSARIAL_PROFILES
    kw = dict(step=0.5, seed=2, **jsynth.ADVERSARIAL_PROFILES[profile])
    tscans, tpose = tsynth.simulate(tsynth.mini_world(),
                                    tsynth.mini_loop_waypoints(),
                                    tsynth.SimConfig(**kw))
    jscans, jpose = jsynth.simulate(jsynth.mini_world(),
                                    jsynth.mini_loop_waypoints(),
                                    jsynth.SimConfig(**kw))
    np.testing.assert_array_equal(tpose, jpose)
    assert len(tscans) == len(jscans)
    for a, b in zip(tscans, jscans):
        np.testing.assert_array_equal(a.ranges, b.ranges)
        np.testing.assert_array_equal(a.odom_pose, b.odom_pose)


@pytest.mark.parametrize("fmt", ["flaser", "robotlaser", "rawlaser"])
def test_logs_are_byte_equal_to_jax(tmp_path, fmt):
    cfg = dict(step=1.0, seed=1)
    tscans, _ = tsynth.simulate(config=tsynth.SimConfig(**cfg))
    jscans, _ = jsynth.simulate(config=jsynth.SimConfig(**cfg))
    tsynth.write_carmen_log(str(tmp_path / "t.clf"), tscans, fmt=fmt)
    jsynth.write_carmen_log(str(tmp_path / "j.clf"), jscans, fmt=fmt)
    assert (tmp_path / "t.clf").read_bytes() == \
        (tmp_path / "j.clf").read_bytes()


def test_make_dataset_writes_the_same_files(tmp_path):
    cfg = dict(step=0.7, seed=5)
    tlog = tsynth.make_dataset(str(tmp_path / "t"), tsynth.SimConfig(**cfg))
    jlog = jsynth.make_dataset(str(tmp_path / "j"), jsynth.SimConfig(**cfg))
    assert open(tlog, "rb").read() == open(jlog, "rb").read()
    tz, jz = np.load(str(tmp_path / "t_gt.npz")), \
        np.load(str(tmp_path / "j_gt.npz"))
    assert sorted(tz.files) == sorted(jz.files)
    for f in tz.files:
        np.testing.assert_array_equal(tz[f], jz[f])


# --------------------------------------------------------------------------
# Native CARMEN reader
# --------------------------------------------------------------------------


def test_native_reader_matches_python_reader(tmp_path):
    """The tokenizer is built from the port's own source with the host's
    C++ compiler, here as anywhere: no skip. Its scans are held against
    the JAX package's pure-Python reader on the same log, and against the
    port's own."""
    cfg = tsynth.SimConfig(step=1.0)
    scans, _ = tsynth.simulate(config=cfg)
    path = str(tmp_path / "t.clf")
    tsynth.write_carmen_log(path, scans, max_range=cfg.max_range)
    fast = tcarmen.load_old_laser_fast(path)
    assert os.path.dirname(tcarmen.tokenizer_library()._name) == \
        tcarmen.BUILD
    ref = [r for r in jcarmen.load(path) if isinstance(r, JRawScan)]
    py = [r for r in tcarmen.load(path) if isinstance(r, RawScan)]
    assert len(fast) == len(ref) == len(py) == len(scans)
    for reader in (ref, py):
        for a, b in zip(reader, fast):
            np.testing.assert_allclose(a.ranges, b.ranges, atol=1e-4)
            np.testing.assert_allclose(a.odom_pose, b.odom_pose, atol=1e-9)
            np.testing.assert_allclose(a.rel_sensor_pose, b.rel_sensor_pose,
                                       atol=1e-9)
            np.testing.assert_allclose(a.angles, b.angles, rtol=0, atol=0)
            assert (a.timestamp, a.min_angle, a.max_angle, a.max_range) == \
                (b.timestamp, b.min_angle, b.max_angle, b.max_range)
    with pytest.raises(OSError):
        tcarmen.load_old_laser_fast(str(tmp_path / "missing.clf"))


def test_native_reader_build_failure_raises(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tcarmen, "TOKENIZER_SOURCE", str(bad))
    monkeypatch.setattr(tcarmen, "BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(tcarmen, "_lib", None)
    with pytest.raises(RuntimeError, match="building the CARMEN tokenizer"):
        tcarmen.load_old_laser_fast(str(tmp_path / "any.clf"))
