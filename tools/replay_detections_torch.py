#!/usr/bin/env python3
"""Run the PyTorch port's loop detector on loop-detection passes recorded
from the JAX package, and compare.

Usage::

    python3 tools/replay_detections_torch.py PASSES.npz [--device cpu]
        [--out SUMMARY.json]

``PASSES.npz`` is what ``tools/dump_jax_detections.py`` writes. For every
recorded pass, ``interop.py`` rebuilds the state the JAX detector saw: the
scan store, a pose graph with the recorded node poses and scan ids, and a
builder holding the candidate's finished local map. The port's detector
with the default settings (``configs/launcher_settings_default.json``)
then matches the candidate nodes against that map. Per candidate node the
port's found flag, normalized score and matched pose are compared with each
recorded JAX variant: branch-and-bound (``bb``), branch-and-bound with the
frontier cap raised (``bb_uncapped``) and the exhaustive sweep in
interpret mode (``sweep``, on the passes where it was run). For every
found node it also notes whether the match lies outside the configured
search window around the node's pose, and, when the file holds the
ground truth, the error of the loop edge (anchor node to matched pose)
against the true relative pose.

The port then also drives its own online pipeline over the same log (``chip_smoke.slice_log`` and ``chip_smoke.slice_slam``) and its
detection passes are set beside the JAX run's, in order: the summary names
the first pass where the two runs differ (node count, node poses beyond
1e-3, candidate, found flags or matched poses) and what differs there.

Prints one line per pass and a JSON summary as the last line.
``--device`` defaults to ``cuda``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from my_lidar_graph_slam_tpu_torch import interop  # noqa: E402
from my_lidar_graph_slam_tpu_torch.models import loop_closure as lc  # noqa
from my_lidar_graph_slam_tpu_torch.models import map_builder as mb  # noqa
from my_lidar_graph_slam_tpu_torch.ops import matchers_sweep  # noqa: E402
from my_lidar_graph_slam_tpu_torch.utils import config, se2  # noqa: E402

SETTINGS = os.path.join(REPO, "configs", "launcher_settings_default.json")
VARIANTS = ("bb", "bb_uncapped", "sweep")
POSE_ATOL = 1e-5


class Stash:
    """Keeps the MatchSummary of the last sweep."""

    def __init__(self):
        self.fn = matchers_sweep.correlative_match_sweep
        self.last = None
        matchers_sweep.correlative_match_sweep = self

    def __call__(self, *args, **kwargs):
        self.last = self.fn(*args, **kwargs)
        return self.last


def own_run(z, device, stash):
    """The port's own run over the slice's log; its detection passes
    beside the recorded JAX passes."""
    import chip_smoke

    with tempfile.TemporaryDirectory(dir=REPO, prefix="replay_") as wd:
        records, _, _ = chip_smoke.slice_log(wd)
    slam = chip_smoke.slice_slam(device)
    det = slam.backend.detector
    run_detect = det.detect
    passes = []

    def detect(graph, builder, candidates):
        results = run_detect(graph, builder, candidates)
        k = len(candidates[0].node_indices)
        passes.append(dict(
            poses=graph.poses[:graph.num_nodes].copy(),
            nodes=list(candidates[0].node_indices),
            anchor=candidates[0].local_map_node_idx,
            found=stash.last.pose_found[:k].cpu().numpy(),
            pose=stash.last.estimated_pose[:k].cpu().numpy()))
        return results

    det.detect = detect
    for scan in records:
        slam.process_scan(scan, scan.odom_pose)
    slam.stop_backend()

    first, pose_diff = None, 0.0
    for p, own in enumerate(passes[:len(z["meta_map"])]):
        pre = f"pass{p:04d}_"
        jp = z[pre + "poses"]
        what = []
        if len(own["poses"]) != len(jp):
            what.append(f"nodes {len(own['poses'])} vs {len(jp)}")
        else:
            d = float(np.abs(own["poses"] - jp).max())
            if d > 1e-3:
                what.append(f"node poses differ by {d:.4g}")
            else:
                pose_diff = max(pose_diff, d)
        if own["nodes"] != [int(n) for n in z[pre + "nodes"]] or \
                own["anchor"] != int(z["meta_local_map_node_idx"][p]):
            what.append("candidate differs")
        elif (own["found"] != z[pre + "bb_found"]).any():
            what.append("found flags differ")
        elif own["found"].any() and np.abs(
                own["pose"][own["found"]] -
                z[pre + "bb_pose"][own["found"]]).max() > 1e-3:
            what.append("matched poses differ by " + str(float(np.abs(
                own["pose"][own["found"]] -
                z[pre + "bb_pose"][own["found"]]).max())))
        if what:
            first = dict(pass_=p, nodes=len(own["poses"]), what=what)
            break
    return {"passes": len(passes),
            "closures": slam.backend.num_loop_closures,
            "loop_edges": slam.backend.num_loop_edges,
            "nodes": slam.graph.num_nodes,
            "first_difference": first,
            "node_pose_max_abs_diff_before": pose_diff}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("passes")
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    z = np.load(args.passes)
    store = interop.scan_store_from_arrays(
        *(z["store_" + n] for n in (
            "ranges", "angles", "valid", "min_range", "max_range",
            "rel_sensor_pose", "raw_beams", "timestamps")))
    slam = config.create_slam(config.load(SETTINGS), device=args.device,
                              threaded_backend=False)
    det = slam.backend.detector
    if not isinstance(det, lc.LoopDetectorBranchBound):
        raise SystemExit("expected the BranchBound detector")
    builder = mb.GridMapBuilder(slam.builder.config, store,
                                device=slam.builder.device)
    stash = Stash()

    n_pass = len(z["meta_map"])
    res = builder.config.resolution
    win_x, win_y, _ = det._window_params(res)
    gt_of_scan = None
    if "gt_poses" in z:
        gt_t = z["gt_timestamps"]
        hi = np.clip(np.searchsorted(gt_t, store.timestamps[:store.count]),
                     1, len(gt_t) - 1)
        near = np.where(np.abs(gt_t[hi] - store.timestamps[:store.count])
                        < np.abs(gt_t[hi - 1]
                                 - store.timestamps[:store.count]),
                        hi, hi - 1)
        gt_of_scan = z["gt_poses"][near]
    rows = {v: [] for v in ("port",) + VARIANTS}
    flags = {v: [] for v in VARIANTS}
    overflow_rows = 0
    no_edge = np.zeros((0,), np.int64)
    for p in range(n_pass):
        pre = f"pass{p:04d}_"
        key = str(z["meta_map"][p])
        interop.set_local_maps(builder, [dict(
            log_odds=z[key + "_log_odds"], observed=z[key + "_observed"],
            origin=z[key + "_origin"],
            node_idx_min=int(z["meta_node_idx_min"][p]),
            node_idx_max=int(z["meta_node_idx_max"][p]), finished=True)])
        poses, scan_ids = z[pre + "poses"], z[pre + "scan_ids"]
        graph = interop.pose_graph_from_arrays(
            poses, scan_ids, no_edge, no_edge, np.zeros((0, 3)),
            np.zeros((0, 3, 3)))
        nodes = [int(n) for n in z[pre + "nodes"]]
        anchor = int(z["meta_local_map_node_idx"][p])
        det.detect(graph, builder, [lc.LoopCandidate(
            node_indices=nodes, local_map_idx=0,
            local_map_node_idx=anchor)])
        k = len(nodes)
        out = stash.last
        found = {"port": out.pose_found[:k].cpu().numpy()}
        score = {"port": out.normalized_score[:k].cpu().numpy()}
        pose = {"port": out.estimated_pose[:k].cpu().numpy()}
        for v in VARIANTS:
            if pre + v + "_found" in z:
                found[v] = z[pre + v + "_found"]
                score[v] = z[pre + v + "_score"]
                pose[v] = z[pre + v + "_pose"]
        overflow_rows += int((z[pre + "bb_overflow"] > 0).sum())
        for v in found:
            for r, node in enumerate(nodes):
                if not found[v][r]:
                    continue
                m = pose[v][r].astype(np.float64)
                shift = np.abs(m[:2] - poses[node][:2])
                row = dict(pass_=p, node=node, pose=m, score=score[v][r],
                           outside=bool(shift[0] > win_x * res + 1e-4 or
                                        shift[1] > win_y * res + 1e-4))
                if gt_of_scan is not None:
                    rel = se2.inverse_compound_np(poses[anchor], m)
                    ref = se2.inverse_compound_np(
                        gt_of_scan[scan_ids[anchor]],
                        gt_of_scan[scan_ids[node]])
                    row["edge_err_m"] = float(np.hypot(*(rel[:2] - ref[:2])))
                    row["edge_err_rad"] = float(abs(
                        se2.normalize_angle_np(rel[2] - ref[2])))
                rows[v].append(row)
        for v in VARIANTS:
            if v in found:
                flags[v].append((found[v], found["port"]))
        print(f"pass {p}: " + " ".join(
            f"{v}={int(found[v].sum())}/{k}[" +
            " ".join(f"{s_:.3f}" for s_ in score[v]) + "]"
            for v in found), flush=True)

    def errs(rs, key):
        e = np.asarray([r[key] for r in rs if key in r])
        return None if e.size == 0 else \
            {"median": float(np.median(e)), "max": float(e.max())}

    found_rows = {}
    for v, rs in rows.items():
        found_rows[v] = {
            "found": len(rs),
            "outside_window": sum(r["outside"] for r in rs),
            "edge_err_m": errs(rs, "edge_err_m"),
            "edge_err_rad": errs(rs, "edge_err_rad"),
            "passes_with_edge_err_over_1m": sorted(
                {r["pass_"] for r in rs if r.get("edge_err_m", 0.0) > 1.0})}
    compare = {}
    port_by = {(r["pass_"], r["node"]): r for r in rows["port"]}
    for v in VARIANTS:
        if not flags[v]:
            continue
        jf = np.concatenate([a for a, _ in flags[v]])
        tf = np.concatenate([b for _, b in flags[v]])
        pairs = [(port_by[(r["pass_"], r["node"])], r) for r in rows[v]
                 if (r["pass_"], r["node"]) in port_by]
        d = np.asarray([np.abs(a["pose"] - b["pose"]).max()
                        for a, b in pairs]).reshape(-1)
        ds = np.asarray([abs(float(a["score"]) - float(b["score"]))
                         for a, b in pairs]).reshape(-1)
        differ = [(a, b) for a, b in pairs
                  if np.abs(a["pose"] - b["pose"]).max() > POSE_ATOL]
        compare[v] = {
            "candidate_nodes": int(jf.size),
            "found_flags_equal": int((jf == tf).sum()),
            "found_both": len(pairs),
            "same_pose_rows": int((d <= POSE_ATOL).sum()),
            "pose_max_abs_diff": float(d.max()) if d.size else None,
            "score_max_abs_diff": float(ds.max()) if ds.size else None,
            "different_pose_rows": {
                "count": len(differ),
                "jax_outside_window": sum(b["outside"] for _, b in differ),
                "port_edge_err_m": errs([a for a, _ in differ],
                                        "edge_err_m"),
                "jax_edge_err_m": errs([b for _, b in differ],
                                       "edge_err_m")}}
    summary = {"passes": n_pass, "device": str(builder.device),
               "score_threshold": det.score_threshold,
               "window_m": [win_x * res, win_y * res],
               "bb_rows_with_frontier_overflow": overflow_rows,
               "found_rows": found_rows, "compare_with_port": compare}
    summary["own_run"] = own_run(z, builder.device, stash)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
