"""The port's device pose-graph solver against the JAX package's, on the
CPU (``models/optimizer_lm.py``, ``models/robust_loss.py`` and the
backend's choice of solver).

Graphs are built from a seed with NumPy (the ring of
tests/test_optimizer_solvers.py, through ``io/synth.py::ring_graph``) and
handed to both packages as the same ``GraphArrays`` arrays.

Tolerances, with the largest error seen in a CPU run in brackets:
- losses and weights: rtol 1e-6 [3.5e-7], atol 1e-30 (XLA flushes float32
  subnormals such as exp(-100) to zero);
- edge errors and Jacobians: atol 1e-5 [1.9e-6];
- chain factor/solve: atol 5e-4 against a dense solve, as
  tests/test_optimizer_solvers.py:62, and 1e-5 against the JAX one
  [4.5e-8 both];
- LM poses against the JAX solver: atol 1e-3 m [2.2e-4 with the dense
  path, which the port solves in float64 and the JAX package in float32;
  1.5e-5 with CG], equal LM iterations, total error rtol 1e-3;
- the port's device solver against its host solver: atol 0.05 m, as
  tests/test_optimizer_solvers.py:100 [9.3e-6];
- the loop run with the device solver from 16 nodes against the JAX
  backend's: equal nodes, edges and closures, poses atol 5e-3 m [9.5e-4:
  the two float32 CG solves sum in different orders, and each backend
  pass starts from the poses the last one left].
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from my_lidar_graph_slam_tpu.models import optimizer_lm as jlm
from my_lidar_graph_slam_tpu.models import robust_loss as jloss
from my_lidar_graph_slam_tpu.models.pose_graph import GraphArrays as JArrays
from my_lidar_graph_slam_tpu_torch.io import synth as tsynth
from my_lidar_graph_slam_tpu_torch.models import optimizer_host as thost
from my_lidar_graph_slam_tpu_torch.models import optimizer_lm as tlm
from my_lidar_graph_slam_tpu_torch.models import robust_loss as tloss
from my_lidar_graph_slam_tpu_torch.models import slam as tslam
from tests import test_torch_slice as slice_
from tests.test_torch_matcher import one_torch_thread  # noqa: F401

LOSSES = ["Squared", "Huber", "Cauchy", "Fair", "GemanMcClure", "Welsch",
          "DCS"]


def _jax(snap):
    return JArrays(*(np.asarray(a) for a in snap))


@pytest.mark.parametrize("name", LOSSES)
def test_robust_losses_match_jax(name):
    t = np.asarray([0.0, 1e-6, 0.004, 0.5, 1.0, 2.0, 10.0, 300.0],
                   np.float32)
    for scale in (0.01, 1.0):
        j = jloss.create(name, scale)
        p = tloss.create(name, scale)
        for fn in ("loss", "weight"):
            np.testing.assert_allclose(
                getattr(p, fn)(torch.from_numpy(t)).numpy(),
                np.asarray(getattr(j, fn)(jnp.asarray(t))), rtol=1e-6,
                atol=1e-30, err_msg=f"{name} {fn} scale {scale}")
    with pytest.raises(ValueError):
        tloss.create("NoSuchLoss")


def test_edge_errors_and_jacobians_match_jax():
    rng = np.random.default_rng(3)
    n, e = 40, 90
    poses = np.concatenate([rng.uniform(-20, 20, (n, 2)),
                            rng.uniform(-4, 4, (n, 1))], 1).astype(np.float32)
    ei = rng.integers(0, n, e).astype(np.int32)
    ej = rng.integers(0, n, e).astype(np.int32)
    rel = np.concatenate([rng.normal(0, 1, (e, 2)),
                          rng.uniform(-4, 4, (e, 1))], 1).astype(np.float32)
    got = tlm.edge_errors(torch.from_numpy(poses), torch.from_numpy(ei).long(),
                          torch.from_numpy(ej).long(), torch.from_numpy(rel))
    ref = jlm.edge_errors(jnp.asarray(poses), jnp.asarray(ei),
                          jnp.asarray(ej), jnp.asarray(rel))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    gi, gj = tlm.edge_jacobians(torch.from_numpy(poses),
                                torch.from_numpy(ei).long(),
                                torch.from_numpy(ej).long())
    ri, rj = jlm.edge_jacobians(jnp.asarray(poses), jnp.asarray(ei),
                                jnp.asarray(ej))
    np.testing.assert_allclose(gi.numpy(), np.asarray(ri), rtol=0, atol=1e-5)
    np.testing.assert_allclose(gj.numpy(), np.asarray(rj), rtol=0, atol=1e-5)


@pytest.mark.parametrize("n", [5, 16, 33])
def test_chain_factor_solves_block_tridiagonal_exactly(n):
    """Cyclic reduction == a dense solve of the same block-tridiagonal
    matrix (tests/test_optimizer_solvers.py:44-62), and == the JAX one."""
    rng = np.random.default_rng(n)
    a = rng.normal(size=(n, 3, 3))
    a[0] = 0.0
    d = np.einsum("nij,nkj->nik", a, a) + \
        np.einsum("nji,njk->nik", np.roll(a, -1, 0), np.roll(a, -1, 0)) + \
        10 * np.eye(3)
    dense = np.zeros((3 * n, 3 * n))
    for i in range(n):
        dense[3 * i:3 * i + 3, 3 * i:3 * i + 3] = d[i]
        if i > 0:
            dense[3 * i:3 * i + 3, 3 * (i - 1):3 * i] = a[i]
            dense[3 * (i - 1):3 * i, 3 * i:3 * i + 3] = a[i].T
    b = rng.normal(size=(n, 3))
    want = np.linalg.solve(dense, b.reshape(-1)).reshape(n, 3)
    levels, dinv_f, npow = tlm.chain_factor(
        torch.tensor(d, dtype=torch.float32),
        torch.tensor(a, dtype=torch.float32))
    got = tlm.chain_solve(levels, dinv_f, npow,
                          torch.tensor(b, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)
    jl, jd, jn = jlm.chain_factor(jnp.asarray(d, jnp.float32),
                                  jnp.asarray(a, jnp.float32))
    ref = np.asarray(jlm.chain_solve(jl, jd, jn, jnp.asarray(b, jnp.float32)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def padded_ring():
    """The 256-node ring in a snapshot padded to 512 nodes, 1024 edges."""
    graph, gt = tsynth.ring_graph(256, seed=0, n_loops=4)
    return graph.snapshot(node_cap=512, edge_cap=1024), gt


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("solver,pre", [("cg", "chain"), ("cg", "jacobi"),
                                        ("dense", "chain")])
def test_optimize_matches_jax(padded_ring, solver, pre, loss):
    snap, _ = padded_ring
    cfg = tlm.LMConfig(solver=solver, preconditioner=pre, loss_name=loss,
                       loss_scale=0.01 if loss == "Huber" else 1.0,
                       cg_max_iterations=64)
    ref = jlm.optimize(_jax(snap), jlm.LMConfig(**vars(cfg)))
    got = tlm.optimize(snap, cfg, device="cpu")
    n = 256
    poses = got.poses.numpy()
    assert poses.shape == (512, 3)
    np.testing.assert_allclose(poses[:n], np.asarray(ref.poses)[:n], rtol=0,
                               atol=1e-3)
    np.testing.assert_array_equal(poses[n:], snap.poses[n:])
    assert got.iterations == int(ref.iterations)
    np.testing.assert_allclose(float(got.total_error),
                               float(ref.total_error), rtol=1e-3)
    if solver == "cg":
        assert 0 < got.cg_iterations <= cfg.cg_max_iterations * \
            got.iterations
        # One read per LM step, one per CG_CHECK_EVERY CG steps or end.
        assert got.host_syncs <= got.iterations * (
            2 + cfg.cg_max_iterations // tlm.CG_CHECK_EVERY)


def test_device_solver_matches_host_solver(padded_ring):
    snap, gt = padded_ring
    cfg = tlm.LMConfig(solver="cg", cg_max_iterations=64)
    dev = tlm.optimize(snap, cfg, device="cpu").poses.numpy()[:256]
    host = thost.optimize_host(snap, cfg).poses[:256]
    assert np.linalg.norm(host[:, :2] - gt[:, :2], axis=1).max() < 0.5
    np.testing.assert_allclose(dev[:, :2], host[:, :2], rtol=0, atol=0.05)


def test_optimize_defaults_to_cuda(padded_ring):
    """No device means cuda: without a card the solver raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        tlm.optimize(padded_ring[0], tlm.LMConfig())


def test_backend_no_longer_raises_at_2048_nodes():
    """From ``host_solver_max_nodes`` nodes on, the backend solves with the
    device solver on its device instead of raising."""
    graph, gt = tsynth.ring_graph(2048, seed=1, n_loops=4)
    snap = graph.snapshot()
    cfg = tlm.LMConfig(solver="cg", max_iterations=3, cg_max_iterations=32)
    backend = tslam.Backend(None, None, cfg, device="cpu")
    assert backend.host_solver_max_nodes == 2048 == snap.num_nodes
    res = backend._optimize(snap)
    assert backend.num_device_solves == 1
    assert res.poses.shape == (2048, 3) and np.isfinite(res.poses).all()
    np.testing.assert_allclose(
        res.poses, tlm.optimize(snap, cfg, "cpu").poses.numpy(), atol=1e-6)


@pytest.fixture(scope="module")
def device_solver_runs():
    """The loop run of tests/test_torch_slice.py with the backend's device
    solver from 16 nodes on, in both packages."""
    (js, jgt), (ts, tgt) = slice_._simulate(
        slice_.jsynth.mini_world(), slice_.jsynth.mini_loop_waypoints(),
        **slice_.MINI_WORLD)
    j = slice_._build("jax", **slice_._mini_kw(jgt[0]))
    t = slice_._build("torch", **slice_._mini_kw(tgt[0]))
    j.backend.host_solver_max_nodes = t.backend.host_solver_max_nodes = 16
    t.backend.device = "cpu"
    slice_._run(j, js, jgt)
    slice_._run(t, ts, tgt)
    return j, t


def test_backend_device_solver_matches_jax(device_solver_runs):
    j, t = device_solver_runs
    assert t.backend.num_device_solves >= 1
    assert t.backend.num_device_solves == t.backend.num_loop_closures
    assert t.graph.num_nodes == j.graph.num_nodes
    assert t.graph.num_edges == j.graph.num_edges
    assert t.backend.num_loop_closures == j.backend.num_loop_closures >= 1
    np.testing.assert_allclose(t.graph.node_poses(), j.graph.node_poses(),
                               rtol=0, atol=5e-3)
