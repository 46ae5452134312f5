#!/usr/bin/env python3
"""The port's online and replay frontends on one settings file, on one GPU.

Usage: ``python3 tools/compare_modes.py [--settings PATH] [--chunk K]
[--profile-scans N]`` from the repository root, on a machine with a CUDA
card and ``nvcc``.

Both modes run the loop of ``launcher.run`` (online: ``process_scan`` per
scan with a synchronous backend; replay: ``ReplayRunner`` in chunks of K
keyframes) over ``chip_smoke.slice_log``'s 2-lap log, with the same
settings (the robust ones unless ``--settings`` says otherwise):

1. over the whole log, without the profiler: scans/s, closures, loop
   edges, aligned ATE, the backend passes and the host seconds inside
   them (a timer around ``Backend.run_once``, with no added
   synchronisation), and the backend's own metrics (detection, solve,
   post-closure rebuild, local-map rebuilds);
2. over the first N scans under ``torch.profiler`` (CPU and CUDA
   activities): the device-busy share of the wall time and the CUDA
   kernels with the most device time.

Prints one JSON line per mode and run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from my_lidar_graph_slam_tpu_torch.models.replay import ReplayRunner  # noqa: E402,E501
from my_lidar_graph_slam_tpu_torch.ops.cuda import loader  # noqa: E402
from my_lidar_graph_slam_tpu_torch.utils import ate, config  # noqa: E402
from my_lidar_graph_slam_tpu_torch.utils.metrics import MetricManager  # noqa: E402,E501


def drive(settings, records, mode, chunk):
    """One run of ``mode`` over ``records``; returns (slam, wall seconds,
    backend passes, host seconds inside them)."""
    slam = config.create_slam(config.load(settings), device="cuda",
                              threaded_backend=False)
    backend = {"passes": 0, "s": 0.0}
    run_once = slam.backend.run_once

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = run_once(*args, **kwargs)
        backend["s"] += time.perf_counter() - t0
        backend["passes"] += 1
        return out

    slam.backend.run_once = timed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if mode == "replay":
        ReplayRunner(slam, chunk=chunk).run(records)
    else:
        for scan in records:
            slam.process_scan(scan, scan.odom_pose)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    slam.stop_backend()
    return slam, wall, backend


def metric_totals(names):
    """Sum and count of each named distribution, and each counter."""
    d = MetricManager.instance().to_dict()
    out = {}
    for name, v in d.get("Distributions", {}).items():
        if name in names:
            out[name] = {"count": v["num_samples"], "sum_s": v["sum"]}
    for name, v in d.get("Counters", {}).items():
        if name in names:
            out[name] = v["value"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--settings", default=chip_smoke.ROBUST)
    ap.add_argument("--chunk", type=int, default=chip_smoke.REPLAY_CHUNK)
    ap.add_argument("--profile-scans", type=int, default=1500)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory(dir=REPO, prefix="modes_") as wd:
        records, gt, gt_t = chip_smoke.slice_log(wd)
    loader.build_all()
    smi = chip_smoke.smi_line()
    wanted = ("LoopDetectionTime", "PoseGraphSolveTime",
              "PostClosureRebuildTime", "FrontendChunkTime",
              "BackendPassTime", "LoopDetectionQueries", "LoopClosingEdges",
              "LocalMapRebuilds", "LoopDetectMxuQueries",
              "LoopDetectMxuPaddedQueries")

    for mode in ("online", "replay"):
        MetricManager.reset_instance()
        slam, wall, backend = drive(args.settings, records, mode,
                                    args.chunk)
        g = slam.graph
        poses = g.node_poses()
        times = slam.scans.timestamps[g.scan_ids[:g.num_nodes]]
        print(json.dumps({
            "device": smi, "run": "whole log", "mode": mode,
            "settings": os.path.basename(args.settings),
            "scans": len(records), "nodes": g.num_nodes,
            "edges": g.num_edges,
            "loop_closures": slam.backend.num_loop_closures,
            "loop_edges": slam.backend.num_loop_edges,
            "ate_aligned_m": ate.ate_rmse(poses, gt, est_times=times,
                                          gt_times=gt_t),
            "wall_s": wall, "scans_per_s": len(records) / wall,
            "backend_passes": backend["passes"],
            "backend_host_s": backend["s"],
            "metrics": metric_totals(wanted)}), flush=True)

    prof_records = records[:args.profile_scans]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for mode in ("online", "replay"):
        MetricManager.reset_instance()
        with torch.profiler.profile(activities=acts) as prof:
            slam, wall, backend = drive(args.settings, prof_records, mode,
                                        args.chunk)
        # Device-side entries only (kernels, copies, memsets): an
        # operator's entry repeats the device time of its kernels.
        on_device = [e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
        device_us = sum(e.self_device_time_total for e in on_device)
        top = sorted(on_device, key=lambda e: e.self_device_time_total,
                     reverse=True)[:8]
        print(json.dumps({
            "device": smi, "run": "profiled", "mode": mode,
            "scans": len(prof_records), "nodes": slam.graph.num_nodes,
            "loop_closures": slam.backend.num_loop_closures,
            "profiled_wall_s": wall,
            "backend_passes": backend["passes"],
            "backend_host_s": backend["s"],
            "device_busy_s": device_us / 1e6,
            "device_busy_share": device_us / 1e6 / wall,
            "top_kernels": [{"name": e.key[:90], "calls": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
