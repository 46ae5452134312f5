#!/usr/bin/env python3
"""The JAX package's device LM solver against its host solver on the ring
pose graph that ``chip_smoke.py`` phase 9 solves on the card.

Usage (on a CPU, with JAX)::

    JAX_PLATFORMS=cpu python3 tools/ring_solver_check.py [--nodes 8192]
        [--loops 4 8 16]

For each loop count it builds ``my_lidar_graph_slam_tpu_torch.io.synth.
ring_graph(nodes, seed=0, n_loops)`` (the graph of the JAX package's
``tests/test_optimizer_solvers.py::make_ring``), solves it with the default
settings' LM config by ``my_lidar_graph_slam_tpu.models.optimizer_lm.
optimize`` and by ``optimizer_host.optimize_host``, and prints one JSON line
with the largest x/y difference between the two (phase 9 holds the port to
0.05 m against the host solver), the LM iterations and the wall times.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from my_lidar_graph_slam_tpu.models import optimizer_host  # noqa: E402
from my_lidar_graph_slam_tpu.models import optimizer_lm  # noqa: E402
from my_lidar_graph_slam_tpu.models.pose_graph import \
    GraphArrays  # noqa: E402
from my_lidar_graph_slam_tpu.utils import config  # noqa: E402
from my_lidar_graph_slam_tpu_torch.io import synth  # noqa: E402

SETTINGS = "configs/launcher_settings_default.json"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--nodes", type=int, default=8192)
    parser.add_argument("--loops", type=int, nargs="+", default=[4])
    args = parser.parse_args(argv)
    cfg = config.create_optimizer_config(
        config.load(SETTINGS), "LM", "PoseGraphOptimizerLM")
    for loops in args.loops:
        graph, gt = synth.ring_graph(args.nodes, seed=0, n_loops=loops)
        snap = GraphArrays(*graph.snapshot())
        n = graph.num_nodes
        t0 = time.perf_counter()
        host = optimizer_host.optimize_host(snap, cfg)
        t1 = time.perf_counter()
        dev = optimizer_lm.optimize(snap, cfg)
        poses = np.asarray(dev.poses)[:n]
        t2 = time.perf_counter()
        print(json.dumps({
            "nodes": n, "edges": graph.num_edges, "n_loops": loops,
            "max_xy_diff_m": float(np.abs(poses[:, :2] -
                                          host.poses[:n, :2]).max()),
            "finite": bool(np.isfinite(poses).all()),
            "lm_iterations_device": int(dev.iterations),
            "lm_iterations_host": host.iterations,
            "host_max_xy_err_vs_truth_m": float(np.abs(
                host.poses[:n, :2] - gt[:, :2]).max()),
            "host_s": t1 - t0, "device_on_cpu_s_with_compile": t2 - t1}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
