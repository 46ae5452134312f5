"""The port's parallel layer across processes, on the CPU: two gloo
processes of four CPU shards each form one 8-shard mesh, as
tests/test_multihost.py runs two JAX processes of four CPU devices.

The workers import the port alone (no JAX). On the global mesh they run
the edge-sharded solve of tests/test_multihost.py's 24-node ring (poses
within 1e-3 of the port's one-process solve, as there), the node-sharded
solve of a 96-node ring with 4 loop edges and one branch-and-bound
fan-out of tests/test_parallel.py's scene, each against the same call on
a one-process mesh of 8 CPU shards (x and y within 0.02 m; found flags
equal, poses atol 1e-4, scores rtol 1e-5), and then a call whose shapes
differ between the ranks, which must raise on both. Both ranks must
return bit-equal results. A second pair of processes runs the launcher
with ``--multihost --platform cpu`` on the small settings of
tests/test_torch_launcher.py: both ranks write the same graph. Every
process has a timeout.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from my_lidar_graph_slam_tpu_torch.io import map_io as tmap_io
from my_lidar_graph_slam_tpu_torch.io import synth as tsynth
from tests.test_torch_launcher import _small_robust_settings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240

WORKER = r"""
import hashlib, json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, os.environ["REPO"])
from my_lidar_graph_slam_tpu_torch.io import synth
from my_lidar_graph_slam_tpu_torch.models import optimizer_lm as lm
from my_lidar_graph_slam_tpu_torch.models.pose_graph import PoseGraph
from my_lidar_graph_slam_tpu_torch.ops import grid as gridops
from my_lidar_graph_slam_tpu_torch.ops import matchers, pyramid, raycast
from my_lidar_graph_slam_tpu_torch.parallel import distributed, multihost
from my_lidar_graph_slam_tpu_torch.parallel.mesh import make_mesh
from my_lidar_graph_slam_tpu_torch.utils import se2

pid = int(os.environ["PID"])
multihost.initialize(coordinator_address=os.environ["COORD"],
                     num_processes=2, process_id=pid, device="cpu",
                     timeout_s=60)
mesh = multihost.global_mesh("shard", device="cpu", shards_per_process=4)
assert mesh.num_shards == 8 and list(mesh.local_shards) == \
    list(range(4 * pid, 4 * pid + 4))
one = make_mesh(8, device="cpu")
out = {}


def ring24():  # tests/test_multihost.py's worker graph
    rng = np.random.default_rng(0)
    n = 24
    ang = 2 * np.pi * np.arange(n) / n
    gt = np.stack([4.0 * np.cos(ang), 4.0 * np.sin(ang), ang + np.pi / 2],
                  axis=-1)
    g = PoseGraph()
    pose = gt[0].copy()
    g.append_node(pose, 0)
    for k in range(1, n):
        rel = se2.inverse_compound_np(gt[k - 1], gt[k]) + \
            rng.normal(0, 0.03, 3)
        pose = se2.compound_np(pose, rel)
        g.append_node(pose, k)
        g.append_edge(k - 1, k, rel, np.diag([100.0, 100.0, 400.0]))
    g.append_edge(n - 1, 0, se2.inverse_compound_np(gt[-1], gt[0]),
                  np.diag([1e3, 1e3, 4e3]))
    return g


# Edge-sharded: tests/test_multihost.py's worker graph and config.
arrays = ring24().snapshot(edge_cap=32)
cfg = lm.LMConfig(solver="cg", max_iterations=5, cg_max_iterations=48)
garrays = multihost.shard_edges_global(mesh, "shard", arrays)
res = distributed.optimize_sharded(garrays, cfg, mesh)
poses = multihost.fetch_global(res.poses)
ref = lm.optimize(arrays, cfg, device="cpu").poses.numpy()
out["edge_err"] = float(np.abs(poses - ref).max())
out["edge"] = hashlib.sha1(poses.tobytes()).hexdigest()

# Node-sharded: a 96-node ring with 4 loop edges.
g96, _ = synth.ring_graph(96, seed=0, n_loops=4)
snap = g96.snapshot(node_cap=128, edge_cap=128)
cfg = lm.LMConfig(solver="cg", max_iterations=10, cg_max_iterations=64,
                  preconditioner="chain")
sharded = distributed.partition_graph_by_nodes(snap, 8)
poses = multihost.fetch_global(
    distributed.optimize_sharded_nodes(sharded, cfg, mesh).poses)
ref = multihost.fetch_global(
    distributed.optimize_sharded_nodes(sharded, cfg, one).poses)
out["node_err"] = float(np.abs(poses[:96, :2] - ref[:96, :2]).max())
out["node"] = hashlib.sha1(poses.tobytes()).hexdigest()

# Fan-out: tests/test_parallel.py's scene.
segs = synth.default_world()
beam = np.linspace(-np.pi / 2, np.pi / 2, 91)
base = synth.rotate_points(np.array([[-7.0, -5.0]]), synth.WORLD_ROTATION)[0]


def scan(p):
    r = np.zeros(128, np.float32)
    a = np.zeros(128, np.float32)
    v = np.zeros(128, bool)
    r[:91] = synth.raycast_segments(p[:2], p[2] + beam, segs, 12.0)
    a[:91], v[:91] = beam, True
    return r, a, v


g = gridops.empty(256, 256, 0.05, center=base, device="cpu")
for k in range(4):
    p = np.array([base[0] + 0.2 * k, base[1], synth.WORLD_ROTATION])
    g = raycast.integrate_scan(g, torch.tensor(p, dtype=torch.float32),
                               *map(torch.from_numpy, scan(p)), 0.01, 12.0,
                               max_steps=128)
pyr = pyramid.build_pyramid(gridops.values(g), 3)
rows = [np.array([base[0] + 0.1 * i, base[1] + 0.02 * i,
                  synth.WORLD_ROTATION], np.float32) for i in range(8)]
scans = [scan(p) for p in rows]
args = [np.stack(rows)] + [np.stack(x) for x in zip(*scans)] + [
    np.zeros(8, np.float32), np.full(8, 12.0, np.float32),
    np.zeros((8, 3), np.float32), np.full(8, 91.0, np.float32)]
kw = dict(scan_range_max=12.0, range_theta=0.25, usable_range_min=0.01,
          usable_range_max=12.0, normalized_score_threshold=0.2,
          node_height_max=3, win_x=8, win_y=8, frontier_cap=2048,
          win_theta_max=matchers.static_max_theta_window(0.05, 12.0, 0.25))
got = multihost.fetch_global(distributed.branch_bound_fanout(
    pyr, g, *args, mesh=mesh, **kw))
ref = multihost.fetch_global(distributed.branch_bound_fanout(
    pyr, g, *args, mesh=one, **kw))
assert got.pose_found.any()
np.testing.assert_array_equal(got.pose_found, ref.pose_found)
np.testing.assert_allclose(got.estimated_pose, ref.estimated_pose, rtol=0,
                           atol=1e-4)
np.testing.assert_allclose(got.normalized_score, ref.normalized_score,
                           rtol=1e-5)
out["fanout"] = hashlib.sha1(got.estimated_pose.tobytes()).hexdigest()

# Ranks that disagree on the shapes raise on both ranks.
other = g96.snapshot(node_cap=128 + 128 * pid, edge_cap=128)
try:
    distributed.optimize_sharded_nodes(
        distributed.partition_graph_by_nodes(other, 8), cfg, mesh)
except RuntimeError as exc:
    out["mismatch"] = str(exc)
torch.distributed.destroy_process_group()
print("RESULT " + json.dumps(out), flush=True)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_pair(cmds, envs):
    """Run two processes to their end (each within TIMEOUT_S); return
    their outputs, failing on a nonzero exit."""
    procs = [subprocess.Popen(cmd, env=env, cwd=REPO,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd, env in zip(cmds, envs)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-3000:]}"
    return outs


def _env(**extra):
    env = dict(os.environ, OMP_NUM_THREADS="1", REPO=REPO)
    env.update({k: str(v) for k, v in extra.items()})
    return env


def test_two_process_cpu_mesh(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    coord = f"127.0.0.1:{_free_port()}"
    outs = _run_pair([[sys.executable, str(worker)]] * 2,
                     [_env(COORD=coord, PID=pid) for pid in range(2)])
    res = [json.loads(next(line for line in out.splitlines()
                           if line.startswith("RESULT "))[7:])
           for out in outs]
    for r in res:
        assert r["edge_err"] < 1e-3
        assert r["node_err"] < 0.02
        assert "ranks disagree" in r["mismatch"]
    for key in ("edge", "node", "fanout"):
        assert res[0][key] == res[1][key], key


def test_two_process_launcher(tmp_path):
    scans, gt = tsynth.simulate(
        world=tsynth.mini_world(), waypoints=tsynth.mini_loop_waypoints(),
        config=tsynth.SimConfig(step=0.25, max_range=8.0, seed=4))
    log = str(tmp_path / "mini.clf")
    tsynth.write_carmen_log(log, scans, max_range=8.0)
    settings = str(tmp_path / "settings.json")
    _small_robust_settings(settings, gt[0])
    port = _free_port()
    outs = [str(tmp_path / f"rank{pid}") for pid in range(2)]
    _run_pair([[sys.executable, "-m", "my_lidar_graph_slam_tpu_torch.launcher",
                log, settings, out, "--platform", "cpu", "--multihost"]
               for out in outs],
              [_env(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, WORLD_SIZE=2,
                    RANK=pid, LOCAL_RANK=pid) for pid in range(2)])
    graphs = [tmap_io.load_checkpoint(out + ".ckpt.npz", 256)[0]
              for out in outs]
    assert graphs[0].num_nodes == graphs[1].num_nodes > 10
    assert graphs[0].num_edges == graphs[1].num_edges >= graphs[0].num_nodes
    np.testing.assert_array_equal(graphs[0].node_poses(),
                                  graphs[1].node_poses())
    metrics = json.load(open(outs[0] + ".metrics.json"))
    assert metrics["Gauges"]["NumLoopClosures"]["value"] >= 1


@pytest.mark.parametrize("bad", [dict(num_processes=2),
                                 dict(coordinator_address="127.0.0.1:1")])
def test_initialize_needs_every_setting(monkeypatch, bad):
    from my_lidar_graph_slam_tpu_torch.parallel import multihost
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        multihost.initialize(device="cpu", **bad)
