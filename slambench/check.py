"""What decides ``correct``: the timed path's answers against the plain
reference (``reference/``), once the window has closed.

During the window :class:`Capture` keeps, for a sample drawn from the
seed, what each answer was computed from and what it was: frontend
matches (the latest map the program matched against, the poses that map
was integrated at, the initial pose, and the pose, score and covariance
it returned), backend detection passes (the candidate maps and node
poses, the loop edges) and backend solves (the snapshot and the
optimised poses). It also keeps, for every node, the pose the pose graph
handed the map builder when the builder integrated that node's scan
(``integrated``), and the poses each latest map was built from.

After the window :func:`compare` works every sampled answer out again
with the reference, from the log's own text:

* each sampled match's latest map is built again from its poses and
  compared with the program's; the reference searches its own map;
* the latest map and every local map at the close are built again from
  the integrated poses and compared with the program's;
* each local map's record of the poses it was built at, which decides
  the map builder's rebuilds after a loop closure, is compared with the
  integrated poses (exact);
* detections and solves are searched and solved again.

Where the reference follows the program's state, it says so: the
initial pose of a match, the node poses and candidate maps of a
detection pass and the snapshot of a solve are the program's; each of
those is checked by itself where it is made (the poses by the matches
and the solve check, the maps by the map check at the close).

The control (:func:`compare` with ``control=True``) is the reference put
in the program's place one precision lower: maps, scores and costs in
bfloat16 instead of float32, the solve in float32 instead of float64.
"""

from __future__ import annotations

import math
import sys
from typing import Dict, List

import numpy as np
import torch

from slambench import ate as ate_mod
from slambench.reference import lm as ref_lm
from slambench.reference import maps as ref_maps
from slambench.reference import match as ref_match

# Gap recorded for an answer that is no candidate of the search at all
# (a pose off the lattice or outside the window).
OFF_LATTICE = 1.0
# A detection row whose best score lies this close (per beam) to the
# detector's threshold may be found by either side.
THRESHOLD_MARGIN = 1e-4
# Gap recorded for a map whose integration the capture did not see.
UNSEEN = 1e9
# Latest maps remembered with the poses they were built from.
LATEST_KEPT = 8

# The numbers compared, in the order printed.
NUMBERS = ("match_gap", "cov_gap", "loop_found_diff", "map_gap",
           "map_observed_diff", "built_pose_gap", "solve_gap")


class Capture:
    """The seed's sample of the window's answers (see module doc)."""

    def __init__(self, seed: int, check: dict):
        self.check = check
        self.rng = np.random.default_rng([seed, 7])
        self.active = False
        self.matches: List[dict] = []
        self.detects: List[dict] = []
        self.solves: List[dict] = []
        self._seen = {"matches": 0, "detects": 0, "solves": 0}
        self.pending = None
        self.raw_of_scan: Dict[int, int] = {}
        # The pose graph's pose of each node when the map builder last
        # integrated its scan into a local map.
        self.integrated: Dict[int, np.ndarray] = {}
        # The newest latest maps: (grid, scan ids, poses built from).
        self.latest: List[tuple] = []
        self.current_raw = -1

    def latest_built(self, builder, graph):
        """Called under the SLAM's lock right after the map builder made
        its latest map."""
        lo, hi = builder.latest_scan_idx_min, builder.latest_scan_idx_max
        self.latest.append((builder.latest_map,
                            graph.scan_ids[lo:hi + 1].copy(),
                            graph.poses[lo:hi + 1].copy()))
        del self.latest[:-LATEST_KEPT]

    def latest_of(self, grid):
        """``(scan ids, poses)`` the latest map ``grid`` was built from,
        or None."""
        for g, ids, poses in reversed(self.latest):
            if g is grid:
                return ids, poses
        return None

    def _reservoir(self, kind: str, item: dict):
        """Keep a uniform sample of at most ``check[kind]`` items."""
        self._seen[kind] += 1
        keep = getattr(self, kind)
        if len(keep) < self.check[kind]:
            keep.append(item)
            return
        j = int(self.rng.integers(self._seen[kind]))
        if j < len(keep):
            keep[j] = item

    def match_started(self, grid, initial_pose):
        self.pending = None
        if self.active:
            self.pending = dict(raw=self.current_raw, grid=grid,
                                built=self.latest_of(grid),
                                initial_pose=np.asarray(initial_pose,
                                                        np.float32).copy())

    def match_resolved(self, summary):
        if self.pending is not None:
            self.pending.update(
                pose=np.asarray(summary.estimated_pose, np.float64).copy(),
                cov=np.asarray(summary.covariance, np.float64).copy(),
                score=float(summary.normalized_score))
            self._reservoir("matches", self.pending)
            self.pending = None

    def detect_called(self, graph, builder, candidates, results):
        if not self.active:
            return
        cands = []
        for c in candidates:
            lm = builder.local_maps[c.local_map_idx]
            cands.append(dict(
                nodes=list(c.node_indices), anchor=c.local_map_node_idx,
                anchor_pose=graph.poses[c.local_map_node_idx].copy(),
                node_poses=graph.poses[list(c.node_indices)].copy(),
                scan_ids=[int(graph.scan_ids[n]) for n in c.node_indices],
                grid=lm.grid))
        found = {(r.start_node_idx, r.end_node_idx): r for r in results}
        self._reservoir("detects", dict(cands=cands, found=found))

    def solve_called(self, snapshot, poses):
        if self.active:
            self._reservoir("solves", dict(snapshot=snapshot,
                                           poses=np.asarray(poses).copy()))


def _f32(a, dev):
    return torch.as_tensor(np.asarray(a, np.float32), device=dev)


class _Query:
    """One scan at one pose, as the reference sees it."""

    def __init__(self, scan, pose, dev, mset, res):
        self.scan = scan
        self.n_total = max(len(scan.ranges), 1)
        self.r = _f32(scan.ranges, dev)
        self.a = _f32(scan.angles, dev)
        self.valid = torch.ones_like(self.r, dtype=torch.bool)
        self.rel = _f32(scan.rel_sensor_pose, dev)
        self.sensor, self.step_t = ref_match.sensor_and_step(
            _f32(pose, dev), self.rel, self.r, self.valid, res,
            mset["scan_range_max"])

    def gate(self, mset, gate):
        return ref_match.beam_gate(
            self.valid, self.r, gate, mset["scan_range_max"],
            mset["usable_min"], mset["usable_max"], self.scan.min_range,
            self.scan.max_range)


def _windows(mset, res):
    win_x = int(math.ceil(0.5 * mset["range_x"] / res))
    win_y = int(math.ceil(0.5 * mset["range_y"] / res))
    win_t = ref_match.static_max_theta_window(res, mset["scan_range_max"],
                                              mset["range_theta"])
    return win_x, win_y, win_t


def _sensor_of(pose, rel, dev):
    return ref_maps.compound32(_f32(pose, dev), rel)


class Matcher:
    """The reference's search on one map: the exhaustive sweep or the
    frozen branch-and-bound, in a given dtype, and the float64 score of
    any lattice candidate."""

    def __init__(self, mset, gate, res, origin, log_odds, observed, dev):
        self.mset, self.gate, self.res, self.dev = mset, gate, res, dev
        self.origin = torch.as_tensor(origin, device=dev)
        self.v64 = ref_match.values(log_odds.to(dev), observed.to(dev),
                                    torch.float64)
        self.wins = _windows(mset, res)
        self._bb = mset["kind"] == "BranchBound" and gate == "range"
        self._pyr = {}

    def search(self, q: _Query, dtype, threshold: float):
        """The best candidate ``(t, x, y)`` (lattice offsets) in ``dtype``
        and its score per beam in that dtype (branch-and-bound gives a
        candidate of None where it found none above ``threshold``, a
        score per beam)."""
        win_x, win_y, win_t = self.wins
        weight = q.gate(self.mset, self.gate)
        vmap = self.v64.to(dtype)
        if self._bb:
            if dtype not in self._pyr:
                self._pyr[dtype] = ref_match.build_pyramid(
                    vmap, self.mset["node_height_max"])
            leaf = ref_match.branch_bound(
                self._pyr[dtype], self.origin, self.res, q.sensor, q.step_t,
                q.r, q.a, weight, threshold * q.n_total,
                self.mset["node_height_max"], win_x, win_y, win_t,
                self.mset["range_theta"], self.mset["frontier_cap"])
            if leaf is None:
                return None, None
            cand = (leaf[2], leaf[0], leaf[1])
            value = ref_match.score_at(vmap, self.origin, self.res,
                                       self.pose_of(q, cand), q.r, q.a,
                                       weight)
            return cand, float(value) / q.n_total
        scores = ref_match.sweep_scores(
            vmap, self.origin, self.res, q.sensor, q.step_t, q.r, q.a,
            weight.to(dtype), win_x, win_y, win_t,
            self.mset["range_theta"])
        best, value = ref_match.first_max(scores)
        wxn, wyn = 2 * win_x + 1, 2 * win_y + 1
        return ((best // (wxn * wyn) - win_t, (best // wyn) % wxn - win_x,
                 best % wyn - win_y), float(value) / q.n_total)

    def pose_of(self, q: _Query, cand):
        t, x, y = cand
        f32 = torch.float32
        s = q.sensor
        return torch.stack([
            s[0] + torch.tensor(x, dtype=f32, device=self.dev) * self.res,
            s[1] + torch.tensor(y, dtype=f32, device=self.dev) * self.res,
            s[2] + torch.tensor(t, dtype=f32, device=self.dev) * q.step_t])

    def score(self, q: _Query, cand) -> float:
        """float64 score of candidate ``cand``, per beam."""
        if cand is None:
            return 0.0
        weight = q.gate(self.mset, self.gate)
        if self._bb:
            s = ref_match.score_at(self.v64, self.origin, self.res,
                                   self.pose_of(q, cand), q.r, q.a, weight)
        else:
            win_x, win_y, _ = self.wins
            t, x, y = cand
            ix, iy = ref_match.lattice_cells(
                self.origin, self.res, q.sensor, q.r, q.a, q.step_t,
                torch.tensor([t], device=self.dev))
            keep = weight
            s = (ref_match._gather(self.v64, ix[0] + x, iy[0] + y) *
                 keep.to(torch.float64)).sum()
        return float(s) / q.n_total

    def candidate_of(self, q: _Query, sensor_pose: np.ndarray):
        """The lattice offsets of a sensor pose the program returned, or
        None when it is no candidate of this search."""
        s = q.sensor.double().cpu().numpy()
        step_t = float(q.step_t)
        x = ref_match.lattice_index(sensor_pose[0], s[0], self.res)
        y = ref_match.lattice_index(sensor_pose[1], s[1], self.res)
        t = ref_match.lattice_index(sensor_pose[2], s[2], step_t)
        if x is None or y is None or t is None:
            return None
        win_x, win_y, win_t = self.wins
        if self._bb:
            return (t, x, y)
        if abs(x) > win_x or abs(y) > win_y or abs(t) > win_t:
            return None
        return (t, x, y)

    def cov(self, q: _Query, sensor_pose, dtype):
        mask = q.gate(self.mset, "range")
        _, cov = ref_match.greedy_cost_cov(
            self.v64.to(dtype), self.origin, sensor_pose, q.r, q.a, mask,
            self.res, **self.mset["greedy"])
        return cov.double().cpu().numpy()


def _cov_gap(cov_test, cov_ref) -> float:
    return float(np.abs(cov_test - cov_ref).max() / np.abs(cov_ref).max())


def _match_numbers(cap, book, ref, dev, control):
    """Per sampled match: the score gap and covariance gap of the
    program's answer, searched on the reference's own build of the latest
    map it matched against, and that map's log-odds gap and observed-mask
    difference from the program's."""
    res = ref["map"]["resolution"]
    mset = ref["frontend"]
    gate = "range" if mset["kind"] == "BranchBound" else "correlative"
    gaps, covs, map_gaps, map_diffs = [], [], [], 0
    for m in cap.matches:
        if m["built"] is None:
            map_gaps.append(UNSEEN)
            gaps.append(OFF_LATTICE)
            continue
        ids, poses = m["built"]
        grid = m["grid"]
        origin = ref_maps.origin_for(poses[-1][:2], ref["map"]["latest_size"],
                                     res)
        lo_ref, ob_ref = _build(book, cap, ids, poses, ref, origin,
                                ref["map"]["latest_size"], dev,
                                torch.float64)
        gap, diff = _map_gap(grid, lo_ref, ob_ref, book, cap, ids, poses,
                             ref, origin, ref["map"]["latest_size"], dev,
                             control)
        map_gaps.append(gap)
        map_diffs += diff
        sc = book.scan(m["raw"])
        q = _Query(sc, m["initial_pose"], dev, mset, res)
        mt = Matcher(mset, gate, res, origin, lo_ref, ob_ref, dev)
        best, _ = mt.search(q, torch.float64, 0.0)
        best_score = mt.score(q, best)
        if control:
            cand, reported = mt.search(q, torch.bfloat16, 0.0)
        else:
            sp = _sensor_of(m["pose"], q.rel, dev).double().cpu().numpy()
            cand = mt.candidate_of(q, sp)
            reported = m["score"]
        if cand is None:
            gaps.append(OFF_LATTICE)
            continue
        gaps.append(max(abs(best_score - mt.score(q, cand)),
                        abs(best_score - reported)))
        sensor = mt.pose_of(q, cand)
        cov_ref = mt.cov(q, sensor, torch.float64)
        cov_test = mt.cov(q, sensor, torch.bfloat16) if control else \
            m["cov"]
        covs.append(_cov_gap(cov_test, cov_ref))
    return gaps, covs, map_gaps, map_diffs


def _loop_numbers(cap, book, ref, dev, control):
    res = ref["map"]["resolution"]
    mset = ref["detector"]
    thr_share = mset["score_threshold"]
    gaps, covs, diffs = [], [], 0
    for d in cap.detects:
        for c in d["cands"]:
            g = c["grid"]
            mt = Matcher(mset, "pixel_accurate", res, g.origin, g.log_odds,
                         g.observed, dev)
            for k, node in enumerate(c["nodes"]):
                sc = book.scan(cap.raw_of_scan[c["scan_ids"][k]])
                q = _Query(sc, c["node_poses"][k], dev, mset, res)
                best, _ = mt.search(q, torch.float64, -math.inf)
                best_score = mt.score(q, best)
                r = None
                if control:
                    cand, value = mt.search(q, torch.bfloat16, -math.inf)
                    found = value > thr_share
                else:
                    r = d["found"].get((c["anchor"], node))
                    found = r is not None
                    cand = None
                    if found:
                        matched = _compound(r.start_node_pose,
                                            r.relative_pose)
                        sp = _sensor_of(matched, q.rel, dev)
                        cand = mt.candidate_of(q, sp.double().cpu().numpy())
                if found != (best_score > thr_share) and \
                        abs(best_score - thr_share) > THRESHOLD_MARGIN:
                    diffs += 1
                if not found:
                    continue
                if cand is None:
                    gaps.append(OFF_LATTICE)
                    continue
                gaps.append(abs(best_score - mt.score(q, cand)))
                sensor = mt.pose_of(q, cand)
                cov_ref = mt.cov(q, sensor, torch.float64)
                cov_test = mt.cov(q, sensor, torch.bfloat16) if control \
                    else np.asarray(r.covariance, np.float64)
                covs.append(_cov_gap(cov_test, cov_ref))
    return gaps, covs, diffs


def _compound(start, diff):
    start = np.asarray(start, np.float64)
    diff = np.asarray(diff, np.float64)
    s, c = np.sin(start[2]), np.cos(start[2])
    return np.array([c * diff[0] - s * diff[1] + start[0],
                     s * diff[0] + c * diff[1] + start[1],
                     start[2] + diff[2]])


def _rows(book, raw_of_scan, scan_ids, poses, mref):
    rows = []
    for sid, pose in zip(scan_ids, poses):
        sc = book.scan(raw_of_scan[int(sid)])
        rows.append((pose, sc.rel_sensor_pose, sc.ranges, sc.angles,
                     max(mref["usable_min"], sc.min_range),
                     min(mref["usable_max"], sc.max_range)))
    return rows


def _steps(book, raw_of_scan, scan_ids, mref) -> int:
    reach = min(mref["usable_max"], max(
        book.scan(raw_of_scan[int(s)]).max_range for s in scan_ids))
    steps = int(-(-(reach / mref["resolution"] + 2) // 64) * 64)
    return min(steps, mref["max_ray_steps"])


def _build(book, cap, ids, poses, ref, origin, size, dev, dtype):
    """The reference's map of the scans ``ids`` at ``poses``."""
    mref = ref["map"]
    return ref_maps.build(
        size, origin, mref["resolution"],
        _rows(book, cap.raw_of_scan, ids, poses, mref), mref["prob_hit"],
        mref["prob_miss"], _steps(book, cap.raw_of_scan, ids, mref), dev,
        dtype)


def _map_gap(grid, lo_ref, ob_ref, book, cap, ids, poses, ref, origin,
             size, dev, control):
    """Largest log-odds gap and observed-mask difference of the program's
    map ``grid`` (the control: the reference's in bfloat16) from the
    reference's ``lo_ref``/``ob_ref``."""
    if control:
        lo_test, ob_test = _build(book, cap, ids, poses, ref, origin, size,
                                  dev, torch.bfloat16)
    else:
        lo_test, ob_test = grid.log_odds.to(dev), grid.observed.to(dev)
    return (float((lo_test.double() - lo_ref).abs().max()),
            int((ob_test != ob_ref).sum()))


def _pose_gap(a, b) -> float:
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    d[..., 2] = np.abs(np.arctan2(np.sin(d[..., 2]), np.cos(d[..., 2])))
    return float(d.max()) if d.size else 0.0


def _map_numbers(slam, cap, book, ref, dev, control):
    """The latest map and every local map at the close, built again by
    the reference from the poses the pose graph handed the map builder
    (a local map at the program's origin, which a rebuild moves; the
    latest map centred on its last pose); and the largest gap between a
    local map's record of the poses it was built at and those poses."""
    mref = ref["map"]
    g = slam.graph
    jobs = []
    latest = slam.builder.latest_map
    built = cap.latest_of(latest)
    jobs.append((latest, mref["latest_size"], None if built is None else
                 ref_maps.origin_for(built[1][-1][:2], mref["latest_size"],
                                     mref["resolution"]), built))
    pose_gap = 0.0
    for lm in slam.builder.local_maps:
        nodes = range(lm.node_idx_min, lm.node_idx_max + 1)
        if any(n not in cap.integrated for n in nodes):
            jobs.append((lm.grid, mref["local_size"], None, None))
            continue
        poses = np.stack([cap.integrated[n] for n in nodes])
        jobs.append((lm.grid, mref["local_size"], lm.origin,
                     (g.scan_ids[lm.node_idx_min:lm.node_idx_max + 1],
                      poses)))
        gap = _pose_gap(lm.built_poses, poses) \
            if lm.built_poses.shape == poses.shape else UNSEEN
        if gap > 0.0 and not control:
            print(f"map check: local map {lm.idx} (nodes {lm.node_idx_min}"
                  f"-{lm.node_idx_max}) records poses {gap} off those its "
                  "scans were integrated at", file=sys.stderr)
        pose_gap = max(pose_gap, gap)
    gaps, diff = [], 0
    for grid, size, origin, built in jobs:
        if built is None:
            gaps.append(UNSEEN)
            continue
        ids, poses = built
        lo_ref, ob_ref = _build(book, cap, ids, poses, ref, origin, size,
                                dev, torch.float64)
        gap, d = _map_gap(grid, lo_ref, ob_ref, book, cap, ids, poses, ref,
                          origin, size, dev, control)
        gaps.append(gap)
        diff += d
    return gaps, diff, 0.0 if control else pose_gap


def _solve_numbers(cap, ref, control):
    out = []
    for s in cap.solves:
        snap = s["snapshot"]
        nm = np.asarray(snap.node_mask, bool)
        em = np.asarray(snap.edge_mask, bool)
        n = int(nm.sum())
        args = (np.asarray(snap.poses, np.float64)[:n],
                np.asarray(snap.edge_i)[em], np.asarray(snap.edge_j)[em],
                np.asarray(snap.edge_rel, np.float64)[em],
                np.asarray(snap.edge_info, np.float64)[em])
        kw = dict(ref["lm"])
        want = ref_lm.optimize(*args, **kw, dtype=np.float64)
        got = ref_lm.optimize(*args, **kw, dtype=np.float32) if control \
            else np.asarray(s["poses"], np.float64)[:n]
        d = np.abs(np.asarray(got, np.float64) - want)
        d[:, 2] = np.abs(np.arctan2(np.sin(d[:, 2]), np.cos(d[:, 2])))
        out.append(float(d.max()))
    return out


def compare(slam, cap: Capture, book, ref: dict, gt_poses, dev,
            control: bool = False) -> dict:
    """Every number compared, with its sample count:
    ``{name: (value, count)}``, and the trajectory's ATE (reported, not
    compared)."""
    match_gaps, match_covs, mmap_gaps, mmap_diff = _match_numbers(
        cap, book, ref, dev, control)
    loop_gaps, loop_covs, loop_diffs = _loop_numbers(cap, book, ref, dev,
                                                     control)
    map_gaps, map_diff, pose_gap = _map_numbers(slam, cap, book, ref, dev,
                                                control)
    map_gaps += mmap_gaps
    solve_gaps = _solve_numbers(cap, ref, control)
    covs = match_covs + loop_covs
    rows = sum(len(c["nodes"]) for d in cap.detects for c in d["cands"])
    numbers = {
        "match_gap": (max(match_gaps + loop_gaps, default=0.0),
                      len(match_gaps) + len(loop_gaps)),
        "cov_gap": (max(covs, default=0.0), len(covs)),
        "loop_found_diff": (loop_diffs, rows),
        "map_gap": (max(map_gaps, default=0.0), len(map_gaps)),
        "map_observed_diff": (map_diff + mmap_diff, len(map_gaps)),
        "built_pose_gap": (pose_gap, len(slam.builder.local_maps)),
        "solve_gap": (max(solve_gaps, default=0.0), len(solve_gaps)),
    }
    g = slam.graph
    raw = [cap.raw_of_scan[int(s)] for s in g.scan_ids[:g.num_nodes]]
    ate = ate_mod.ate_rmse(g.poses[:g.num_nodes], np.asarray(gt_poses)[raw])
    return {"numbers": numbers, "ate_m": ate}


def verdict(numbers: dict, limits: dict):
    """``(correct, lines)``: each number that the cell's workload file
    gives a limit beside that limit."""
    ok = True
    lines = {}
    for name in (n for n in NUMBERS if n in limits):
        value, count = numbers[name]
        limit = limits[name]
        passed = value <= limit
        ok = ok and passed
        lines[name] = {"value": value, "limit": limit, "n": count}
    return ok, lines
