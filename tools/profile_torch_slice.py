#!/usr/bin/env python3
"""Where the time of the PyTorch port's online slice goes, on one GPU.

Usage: ``python3 tools/profile_torch_slice.py [--scans N] [--out DIR]``
from the repository root, on a machine with a CUDA card and ``nvcc``.

Drives the SLAM of ``chip_smoke.py``'s slice (``chip_smoke.slice_slam``:
the default config, synchronous backend) over the first N scans of its log
(``chip_smoke.slice_log``), twice:

1. with host timers around the three stages of a keyframe (the frontend
   match, the map update, the backend pass), each ended by
   ``torch.cuda.synchronize()``, and
2. under ``torch.profiler`` (CPU and CUDA activities), reporting the
   device-busy share of the wall time and the CUDA kernels with the most
   device time.

Prints one JSON line with the breakdown; with ``--out DIR`` also writes
the profiler table to ``DIR/profile_table.txt``.
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
from my_lidar_graph_slam_tpu_torch.ops.cuda import loader  # noqa: E402


def _timed(stage_s, name, fn):
    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        stage_s[name] = stage_s.get(name, 0.0) + time.perf_counter() - t0
        return out
    return wrapper


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scans", type=int, default=1500)
    ap.add_argument("--out", default=None,
                    help="directory for the profiler table (not written "
                         "when omitted)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    with tempfile.TemporaryDirectory(dir=REPO, prefix="profile_") as wd:
        records = chip_smoke.slice_log(wd)[0][:args.scans]

    loader.build_all()

    # 1. Stage timers.
    slam = chip_smoke.slice_slam("cuda")
    stages = {}
    slam.frontend.matcher.match = _timed(stages, "match",
                                         slam.frontend.matcher.match)
    slam.builder.append_scan = _timed(stages, "map_update",
                                      slam.builder.append_scan)
    slam.backend.run_once = _timed(stages, "backend", slam.backend.run_once)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in records:
        slam.process_scan(r, r.odom_pose)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    # 2. Profiler over the same run, without the stage timers.
    slam = chip_smoke.slice_slam("cuda")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t1 = time.perf_counter()
        for r in records:
            slam.process_scan(r, r.odom_pose)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t1
    events = prof.key_averages()
    # Device-side entries only (kernels, copies, memsets): an operator's
    # entry repeats the device time of the kernels it launched.
    on_device = [e for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in on_device)
    top = sorted(on_device, key=lambda e: e.self_device_time_total,
                 reverse=True)[:12]
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "profile_table.txt"), "w") as f:
            f.write(events.table(sort_by="self_cuda_time_total",
                                 row_limit=40))

    print(json.dumps({
        "device": chip_smoke.smi_line(),
        "scans": len(records), "keyframes": slam.graph.num_nodes,
        "loop_closures": slam.backend.num_loop_closures,
        "wall_s": wall, "stage_s": stages,
        "profiled_wall_s": prof_wall,
        "device_busy_s": device_us / 1e6,
        "device_busy_share": device_us / 1e6 / prof_wall,
        "top_kernels": [{"name": e.key[:90], "calls": e.count,
                         "ms": e.self_device_time_total / 1e3}
                        for e in top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
