#!/usr/bin/env python3
"""Record the JAX package's loop-detection passes on the 2-lap intel log.

Usage (CPU)::

    JAX_PLATFORMS=cpu python3 tools/dump_jax_detections.py OUT.npz \
        [--sweep-passes P1,P2,...]

Runs the JAX package's online pipeline as ``launcher.py
--no-backend-thread --platform cpu`` does (``config.load``,
``create_slam`` with a synchronous backend, ``process_scan`` per scan) on
the synthetic intel-like world, 2 laps at 0.08 m steps, seed 0, with
``configs/launcher_settings_default.json``. On a CPU the loop detector is
branch-and-bound (BB). Every backend pass that reaches the detector is
recorded: the candidate, the candidate's finished local map (stored once
per distinct content), the node poses and scan ids, and per candidate node
the found flag, normalized score, matched pose and BB frontier overflow.
The same state also goes, without changing the run, through

* BB with ``frontier_cap`` raised to 65536 (does the cap drop loops?), and
* the exhaustive sweep, ``use_mxu=True, mxu_interpret=True``, on the
  passes listed (interpret mode takes tens of minutes per pass on a CPU;
  the run is deterministic, so a second run can add the sweep on passes
  picked from the first), and
* the RealTimeCorrelative detector (``rtc``) built from the same settings
  file's ``LoopDetectorRealTimeCorrelative`` group, on every pass: per
  candidate node its found flag, score and pose, the exactness flag of
  every row of its padded batch, the escalations it took, and the
  windowed-max coarse map it actually used (stored once per distinct
  content, as the fine maps are), with a flag telling whether that cached
  coarse map was older than the local map (the JAX package keeps it across
  the rebuilds after a loop closure).

The scan store is saved at the end (it only grows, so scan ids stay
valid), with the simulator's ground-truth poses and their timestamps. ``tools/replay_detections_torch.py`` hands the same state to the
PyTorch port's detector and compares.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

from my_lidar_graph_slam_tpu.io import carmen, synth  # noqa: E402
from my_lidar_graph_slam_tpu.models import loop_closure as lc  # noqa: E402
from my_lidar_graph_slam_tpu.ops import correlative_coarse  # noqa: E402
from my_lidar_graph_slam_tpu.ops import grid as gridops  # noqa: E402
from my_lidar_graph_slam_tpu.ops import matchers, matchers_mxu  # noqa: E402
from my_lidar_graph_slam_tpu.ops import pyramid as pyrops  # noqa: E402
from my_lidar_graph_slam_tpu.sensor.data import RawScan  # noqa: E402
from my_lidar_graph_slam_tpu.utils import config  # noqa: E402

SETTINGS = os.path.join(REPO, "configs", "launcher_settings_default.json")
UNCAPPED = 65536


class Stash:
    """Keeps the result of the last call of a matcher function and counts
    its calls."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.last = None
        self.calls = 0
        setattr(module, name, self)

    def __call__(self, *args, **kwargs):
        self.calls += 1
        self.last = self.fn(*args, **kwargs)
        return self.last


def summary_rows(out, k):
    """found, score, pose, overflow of the first ``k`` rows."""
    return dict(
        found=np.asarray(out.pose_found)[:k].astype(bool),
        score=np.asarray(out.normalized_score, np.float32)[:k],
        pose=np.asarray(out.estimated_pose, np.float32)[:k],
        overflow=np.broadcast_to(np.asarray(out.frontier_overflow),
                                 np.asarray(out.pose_found).shape)[:k]
        .astype(np.int64))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--sweep-passes", default="",
                    help="comma-separated pass indices")
    args = ap.parse_args()
    sweep_passes = {int(p) for p in args.sweep_passes.split(",") if p}
    jax.config.update("jax_platforms", "cpu")

    sim = synth.SimConfig(step=0.08, seed=0)
    scans, gt = synth.simulate(synth.intel_world(),
                               synth.intel_waypoints(laps=2), sim)
    with tempfile.TemporaryDirectory() as wd:
        path = os.path.join(wd, "intel2.clf")
        synth.write_carmen_log(path, scans, max_range=sim.max_range)
        records = [r for r in carmen.load(path) if isinstance(r, RawScan)]

    slam = config.create_slam(config.load(SETTINGS), threaded_backend=False)
    det = slam.backend.detector
    if not isinstance(det, lc.LoopDetectorBranchBound) or det._mxu_enabled():
        raise SystemExit("expected the branch-and-bound detector on a CPU")
    uncapped = dataclasses.replace(det, frontier_cap=UNCAPPED)
    sweep = dataclasses.replace(det, use_mxu=True, mxu_interpret=True)
    root = config.load(SETTINGS)
    rtc = config.create_loop_detector(root, "RealTimeCorrelative",
                                      "LoopDetectorRealTimeCorrelative")
    bb_stash = Stash(matchers, "branch_bound_match_batch")
    sweep_stash = Stash(matchers_mxu, "correlative_match_mxu_batch")
    rtc_stash = Stash(correlative_coarse, "two_stage_match_batch")
    rtc_core = Stash(correlative_coarse, "_two_stage_core_batch")

    arrays = {}
    maps = {}            # local map idx -> list of (map key, log_odds)
    meta = []
    run_detect = det.detect

    coarse_maps = {}     # local map idx -> list of (coarse key, coarse)

    def map_key(lm):
        lo = np.asarray(lm.grid.log_odds)
        for key, prev in maps.get(lm.idx, []):
            if np.array_equal(prev, lo):
                return key
        key = f"map{sum(len(v) for v in maps.values()):04d}"
        arrays[key + "_log_odds"] = lo
        arrays[key + "_observed"] = np.asarray(lm.grid.observed)
        arrays[key + "_origin"] = np.asarray(lm.grid.origin, np.float32)
        maps.setdefault(lm.idx, []).append((key, lo))
        return key

    def coarse_key(lm):
        """Key of the coarse map the correlative detector used on ``lm``
        (its cache), stored once per distinct content."""
        coarse = np.asarray(lm._coarse_cache[1])
        for key, prev in coarse_maps.get(lm.idx, []):
            if np.array_equal(prev, coarse):
                return key
        key = f"coarse{sum(len(v) for v in coarse_maps.values()):04d}"
        arrays[key] = coarse
        coarse_maps.setdefault(lm.idx, []).append((key, coarse))
        return key

    def detect(graph, builder, candidates):
        p = len(meta)
        t0 = time.perf_counter()
        results = run_detect(graph, builder, candidates)
        times = {"bb": time.perf_counter() - t0}
        if len(candidates) != 1:
            raise SystemExit("the default config emits one candidate map")
        cand = candidates[0]
        k = len(cand.node_indices)
        rows = {"bb": summary_rows(bb_stash.last, k)}
        t0 = time.perf_counter()
        uncapped.detect(graph, builder, candidates)
        times["bb_uncapped"] = time.perf_counter() - t0
        rows["bb_uncapped"] = summary_rows(bb_stash.last, k)
        if p in sweep_passes:
            print(f"pass {p}: sweep in interpret mode...", flush=True)
            t0 = time.perf_counter()
            sweep.detect(graph, builder, candidates)
            times["sweep"] = time.perf_counter() - t0
            rows["sweep"] = summary_rows(sweep_stash.last, k)
        lm = builder.local_maps[cand.local_map_idx]
        calls0 = rtc_core.calls
        t0 = time.perf_counter()
        rtc.detect(graph, builder, candidates)
        times["rtc"] = time.perf_counter() - t0
        summary, exact = rtc_stash.last
        rows["rtc"] = summary_rows(summary, k)
        fresh = np.asarray(pyrops.windowed_max(gridops.values(lm.grid),
                                               rtc.low_resolution))
        n = graph.num_nodes
        pre = f"pass{p:04d}_"
        arrays[pre + "rtc_exact"] = np.asarray(exact, bool)
        arrays[pre + "rtc_escalations"] = np.asarray(
            rtc_core.calls - calls0 - 1, np.int64)
        arrays[pre + "rtc_stale"] = np.asarray(
            not np.array_equal(fresh, np.asarray(lm._coarse_cache[1])))
        arrays[pre + "rtc_coarse"] = np.asarray(coarse_key(lm))
        arrays[pre + "poses"] = graph.poses[:n].copy()
        arrays[pre + "scan_ids"] = graph.scan_ids[:n].copy()
        arrays[pre + "nodes"] = np.asarray(cand.node_indices, np.int64)
        for v, r in rows.items():
            for f, a in r.items():
                arrays[pre + v + "_" + f] = a
        meta.append(dict(
            map=map_key(lm), local_map_idx=cand.local_map_idx,
            local_map_node_idx=cand.local_map_node_idx,
            node_idx_min=lm.node_idx_min, node_idx_max=lm.node_idx_max,
            variants=sorted(rows)))
        print(f"pass {p}: nodes {n} map {cand.local_map_idx} "
              + " ".join(f"{v}={int(r['found'].sum())}/{k}"
                         f"({times[v]:.1f}s)" for v, r in rows.items()),
              flush=True)
        return results

    det.detect = detect
    t0 = time.perf_counter()
    for i, scan in enumerate(records):
        slam.process_scan(scan, scan.odom_pose)
        if i % 500 == 0:
            print(f"scan {i}: nodes {slam.graph.num_nodes} "
                  f"{time.perf_counter() - t0:.0f} s", flush=True)
    slam.stop_backend()
    st = slam.builder.scans
    n = st.count
    for name in ("ranges", "angles", "valid", "min_range", "max_range",
                 "rel_sensor_pose", "raw_beams", "timestamps"):
        arrays["store_" + name] = getattr(st, name)[:n]
    arrays["meta_map"] = np.asarray([m["map"] for m in meta])
    for f in ("local_map_idx", "local_map_node_idx", "node_idx_min",
              "node_idx_max"):
        arrays["meta_" + f] = np.asarray([m[f] for m in meta], np.int64)
    arrays["beam_capacity"] = np.asarray(st.beam_capacity)
    arrays["rtc_settings"] = np.asarray([
        rtc.score_threshold, rtc.low_resolution, rtc.range_x, rtc.range_y,
        rtc.range_theta, rtc.scan_range_max, rtc.usable_range_min,
        rtc.usable_range_max, rtc.refine_blocks], np.float64)
    arrays["gt_poses"] = np.asarray(gt, np.float64)
    arrays["gt_timestamps"] = np.asarray([s.timestamp for s in scans])
    np.savez_compressed(args.out, **arrays)
    print(f"scans {len(records)} nodes {slam.graph.num_nodes} passes "
          f"{len(meta)} closures {slam.backend.num_loop_closures} in "
          f"{time.perf_counter() - t0:.0f} s -> {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
