#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine
with a CUDA card and the CUDA toolkit (``nvcc``). Phases:

1. Device: the card's name and power limit.
2. Build: compiles every CUDA kernel of ``my_lidar_graph_slam_tpu_torch``
   from ``my_lidar_graph_slam_tpu_torch/csrc`` (one ``nvcc`` per source, in
   parallel).
3. Kernels vs plain, edge cases: each kernel against its plain PyTorch
   version on the card, on random maps and cells made from a seed at the
   default config's widths (beam capacity 1024, 5x5 and 41x41 windows,
   1024^2 and 1536^2 maps): off-map edges, far-out zero-weight beams,
   ``map_idx`` over stacked maps, K2 at kernel_size 2 and at a 40 m
   range. Phase 5 holds them again on the slice's own inputs.
4. Slice: the default online SLAM path (``configs/
   launcher_settings_default.json``, synchronous backend) over a synthetic
   intel-like world, 2 laps at 0.08 m steps, through ``config.load``,
   ``config.create_slam``, ``carmen.load`` and ``process_scan``. The launch
   counters are zeroed just before and read just after.
5. Times: for every shape the slice gave a kernel, the kernel and its
   plain version run again on the inputs of the slice's last call at that
   shape; their outputs are held to the tolerances of phase 3 and both are
   timed with CUDA events, beside the least time the card could take: the
   larger of the bytes the call must move (the map cells it reads, counted
   on these inputs, plus the other inputs and the output, each once) over
   3.35 TB/s and its operations over 67 TFLOP/s.

The last three lines of standard output are the ``kernels`` JSON line, the
``nvidia-smi`` name and power limit, and the result line
``{"ok": true, "device": {...}}``. Any failure exits non-zero before the
result line. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SETTINGS = os.path.join(REPO, "configs", "launcher_settings_default.json")
SEED = 0
LAPS = 2
STEP = 0.08
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM float32, no tensor cores
K1_RTOL, K1_ATOL = 1e-5, 1e-3  # f32 summation order over <= 1024 beams
K2_COST_ATOL = 1e-4
K2_COV_RTOL, K2_COV_ATOL = 1e-4, 1e-8


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# Phase 3: kernels vs plain versions
# --------------------------------------------------------------------------


def random_map(gen, h, w, dev, torch):
    """Occupancy-like values: ~40% unknown (0), the rest in (0, 1)."""
    vals = torch.rand((h, w), generator=gen, device="cpu")
    known = torch.rand((h, w), generator=gen, device="cpu") < 0.6
    return torch.where(known, vals, torch.zeros_like(vals)).to(dev)


def arc_cells(gen, q, nt, nb, h, w, margin, dev, torch):
    """Per-theta hit cells drifting <= 1 cell per theta step."""
    bx = torch.randint(margin, w - margin, (q, 1, nb), generator=gen)
    by = torch.randint(margin, h - margin, (q, 1, nb), generator=gen)
    ix = bx + torch.randint(-1, 2, (q, nt, nb), generator=gen).cumsum(1)
    iy = by + torch.randint(-1, 2, (q, nt, nb), generator=gen).cumsum(1)
    return (ix.to(torch.int32).to(dev), iy.to(torch.int32).to(dev))


def check_k1(name, got, ref, torch):
    err = (got - ref).abs()
    bad = err > K1_ATOL + K1_RTOL * ref.abs()
    if bool(bad.any()):
        raise AssertionError(f"K1 {name}: max |err| {float(err.max())}")
    # Argmax agreement wherever the top two scores are separated.
    flat_g = got.reshape(got.shape[0], -1)
    flat_r = ref.reshape(ref.shape[0], -1)
    top2 = flat_r.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > K1_ATOL
    same = flat_g.argmax(1) == flat_r.argmax(1)
    if bool((clear & ~same).any()):
        raise AssertionError(f"K1 {name}: argmax differs")
    return float(err.max())


def check_k2(name, got, ref, torch):
    (c, cov), (c_ref, cov_ref) = got, ref
    ce = float((c - c_ref).abs().max())
    ve = (cov - cov_ref).abs()
    if ce > K2_COST_ATOL or bool(
            (ve > K2_COV_ATOL + K2_COV_RTOL * cov_ref.abs()).any()):
        raise AssertionError(f"K2 {name}: cost err {ce}, cov err "
                             f"{float(ve.max())}")
    return max(ce, float(ve.max()))


def phase_kernels(torch, dev, nb):
    from my_lidar_graph_slam_tpu_torch.ops.cuda import correlate, greedy_cost

    gen = torch.Generator().manual_seed(SEED)
    errs = {"window_scores": 0.0, "greedy_cost": 0.0}

    def k1(name, vm, ix, iy, w, win, map_idx=None, plain_q=None):
        got = correlate.window_scores(vm, ix, iy, w, win, win, map_idx)
        sl = slice(0, plain_q)
        ref = correlate.window_scores_plain(
            vm, ix[sl], iy[sl], w[sl], win, win,
            None if map_idx is None else map_idx[sl])
        torch.cuda.synchronize()
        e = check_k1(name, got[sl], ref, torch)
        errs["window_scores"] = max(errs["window_scores"], e)
        log(f"  K1 {name}: {tuple(got.shape)} max|err| {e:.3g}")

    # Frontend shape: 1024^2 map, Q=1, NT=201, 5x5 window.
    m1 = random_map(gen, 1024, 1024, dev, torch)
    ix, iy = arc_cells(gen, 1, 201, nb, 1024, 1024, 120, dev, torch)
    w = (torch.rand((1, nb), generator=gen) < 0.8).float().to(dev)
    k1("frontend", m1, ix, iy, w, 2)
    # Off-map edge: endpoints hugging and crossing every border.
    edge = torch.tensor([-3, -1, 0, 1, 1022, 1023, 1024, 1026])
    bx = edge[torch.randint(0, 8, (1, 1, nb), generator=gen)]
    by = edge[torch.randint(0, 8, (1, 1, nb), generator=gen)]
    drift = torch.randint(-1, 2, (1, 201, nb), generator=gen).cumsum(1)
    k1("off-map edge", m1, (bx + drift).int().to(dev),
       (by - drift).int().to(dev), w, 2)
    # Far-out zero-weight beams: must neither fault nor contribute.
    far = torch.rand((1, 1, nb), generator=gen) < 0.3
    big = torch.full((1, 201, nb), 2_000_000_000, dtype=torch.int32)
    wz = torch.where(far[:, 0].to(dev), torch.zeros_like(w), w)
    k1("far zero-weight", m1,
       torch.where(far.to(dev), big.to(dev), ix),
       torch.where(far.to(dev), -big.to(dev), iy), wz, 2)

    # Detection shape: 1536^2 map, Q=8, NT=401, 41x41 window; the plain
    # version runs on 2 of the 8 queries to bound its memory.
    m2 = random_map(gen, 1536, 1536, dev, torch)
    ix, iy = arc_cells(gen, 8, 401, nb, 1536, 1536, 250, dev, torch)
    w8 = (torch.rand((8, nb), generator=gen) < 0.8).float().to(dev)
    k1("detection", m2, ix, iy, w8, 20, plain_q=2)
    # map_idx over 2 stacked maps.
    stack = torch.stack([m2, random_map(gen, 1536, 1536, dev, torch)])
    midx = torch.tensor([0, 1, 1, 0], dtype=torch.int32, device=dev)
    k1("map_idx", stack, ix[:4], iy[:4], w8[:4], 20, map_idx=midx)

    def k2(name, vm, origin, q, k, rmax, map_idx=None, h=1024):
        res = 0.05
        extent = h * res
        poses = torch.stack([
            origin.reshape(-1, 2)[:, 0].cpu().expand(q)
            + extent * (0.3 + 0.4 * torch.rand(q, generator=gen)),
            origin.reshape(-1, 2)[:, 1].cpu().expand(q)
            + extent * (0.3 + 0.4 * torch.rand(q, generator=gen)),
            torch.rand(q, generator=gen) * 6.0 - 3.0], 1).to(dev)
        ranges = (0.5 + (rmax - 0.5) * torch.rand((q, nb), generator=gen)
                  ).to(dev)
        angles = torch.linspace(-1.6, 1.6, nb).expand(q, nb).contiguous(
            ).to(dev)
        mask = (torch.rand((q, nb), generator=gen) < 0.9).to(dev)
        args = (vm, origin, poses, ranges, angles, mask, res)
        kw = dict(kernel_size=k, map_idx=map_idx)
        got = greedy_cost.greedy_cost_cov(*args, **kw)
        ref = greedy_cost.greedy_cost_cov_plain(*args, **kw)
        torch.cuda.synchronize()
        e = check_k2(name, got, ref, torch)
        errs["greedy_cost"] = max(errs["greedy_cost"], e)
        log(f"  K2 {name}: Q={q} k={k} max|err| {e:.3g}")

    # Smooth-ish map so that many kernel cells are usable.
    occ = (torch.rand((1024, 1024), generator=gen) < 0.15).float()
    occ = torch.nn.functional.max_pool2d(occ[None, None], 3, 1, 1)[0, 0]
    m3 = torch.where(occ > 0, torch.full_like(occ, 0.9),
                     torch.full_like(occ, 0.05)).to(dev)
    org = torch.tensor([-25.6, -25.6], device=dev)
    k2("frontend", m3, org, 1, 1, 20.0)
    k2("detection", m3, org, 8, 1, 20.0)
    k2("kernel_size 2", m3, org, 8, 2, 20.0)
    k2("usable_range_max 40", m3, org, 8, 1, 40.0)
    stack3 = torch.stack([m3, m3.flip(0)])
    orgs = torch.tensor([[-25.6, -25.6], [-20.0, -30.0]], device=dev)
    midx = torch.tensor([0, 1, 1, 0, 1, 0, 0, 1], dtype=torch.int32,
                        device=dev)
    k2("map_idx", stack3, orgs[midx.long()], 8, 1, 20.0, map_idx=midx)
    return errs


# --------------------------------------------------------------------------
# Phase 4: the slice
# --------------------------------------------------------------------------


class Recorder:
    """Stands in for a kernel wrapper during the slice: keeps the arguments
    of the last call at each shape, keyed by (path, Q), and counts the calls
    at each shape. The path is "frontend" for a call on the latest map and
    "detection" for one on a local map (the two have different widths)."""

    def __init__(self, module, name, latest_width):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.latest_width = latest_width
        self.calls = {}
        self.counts = {}
        setattr(module, name, self)

    # The wrapper counts its launches on the module-level name, which is
    # this object while it stands in.
    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, value):
        self.fn.launches = value

    def __call__(self, *args, **kwargs):
        path = "frontend" if args[0].shape[-1] == self.latest_width \
            else "detection"
        key = (path, args[1].shape[0])
        self.calls[key] = (args, kwargs)
        self.counts[key] = self.counts.get(key, 0) + 1
        return self.fn(*args, **kwargs)

    def restore(self):
        setattr(self.module, self.name, self.fn)


def ate(est, est_t, gt, gt_t, align):
    """Translational ATE RMSE after nearest-timestamp association; with
    ``align`` the best-fit SE(2) transform is applied first, else est is
    anchored so its first pose coincides with the ground truth's."""
    hi = np.clip(np.searchsorted(gt_t, est_t), 1, len(gt_t) - 1)
    gi = np.where(np.abs(gt_t[hi] - est_t) < np.abs(gt_t[hi - 1] - est_t),
                  hi, hi - 1)
    g = gt[gi]
    if align:
        e, t = est[:, :2], g[:, :2]
        me, mt = e.mean(0), t.mean(0)
        u, _, vt = np.linalg.svd((e - me).T @ (t - mt))
        d = np.sign(np.linalg.det(vt.T @ u.T))
        r = vt.T @ np.diag([1.0, d]) @ u.T
        p = (e - me) @ r.T + mt
    else:
        th = g[0, 2] - est[0, 2]
        c, s = np.cos(th), np.sin(th)
        rel = est[:, :2] - est[0, :2]
        p = g[0, :2] + rel @ np.array([[c, -s], [s, c]]).T
    return float(np.sqrt(((p - g[:, :2]) ** 2).sum(1).mean()))


def slice_log(workdir):
    """The slice's log: the synthetic intel-like world, LAPS laps at STEP m,
    seed SEED, written to ``workdir`` and read back through the port's
    CARMEN reader. Returns (scan records, ground-truth poses, ground-truth
    timestamps)."""
    from my_lidar_graph_slam_tpu_torch.io import carmen, synth
    from my_lidar_graph_slam_tpu_torch.sensor.data import RawScan

    sim = synth.SimConfig(step=STEP, seed=SEED)
    scans, gt = synth.simulate(synth.intel_world(),
                               synth.intel_waypoints(laps=LAPS), sim)
    log_path = os.path.join(workdir, "intel2.clf")
    synth.write_carmen_log(log_path, scans, max_range=sim.max_range)
    gt_t = np.array([s.timestamp for s in scans])
    records = [r for r in carmen.load(log_path) if isinstance(r, RawScan)]
    return records, gt, gt_t


def slice_slam(dev):
    """The slice's SLAM: the default settings, a synchronous backend."""
    from my_lidar_graph_slam_tpu_torch.utils import config

    return config.create_slam(config.load(SETTINGS), device=dev,
                              threaded_backend=False)


def phase_slice(torch, dev, workdir):
    from my_lidar_graph_slam_tpu_torch.ops.cuda import correlate, greedy_cost

    records, gt, gt_t = slice_log(workdir)
    slam = slice_slam(dev)
    latest = slam.builder.config.latest_map_size
    correlate.window_scores.launches = 0
    greedy_cost.greedy_cost_core.launches = 0
    rec = [Recorder(correlate, "window_scores", latest),
           Recorder(greedy_cost, "greedy_cost_core", latest)]
    key_ms = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for scan in records:
        t1 = time.perf_counter()
        if slam.process_scan(scan, scan.odom_pose):
            key_ms.append(1e3 * (time.perf_counter() - t1))
    slam.stop_backend()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"window_scores": rec[0].fn.launches,
                "greedy_cost": rec[1].fn.launches}
    for r in rec:
        r.restore()

    g = slam.graph
    poses = g.node_poses()
    times = slam.scans.timestamps[g.scan_ids[:g.num_nodes]]
    stats = {
        "scans": len(records), "nodes": g.num_nodes, "edges": g.num_edges,
        "loop_closures": slam.backend.num_loop_closures,
        "loop_edges": slam.backend.num_loop_edges,
        "ate_anchored_m": ate(poses, times, gt, gt_t, align=False),
        "ate_aligned_m": ate(poses, times, gt, gt_t, align=True),
        "seconds": elapsed, "scans_per_s": len(records) / elapsed,
        "keyframe_ms_median": float(np.median(key_ms)),
        "beam_bucket": slam.scans.beam_bucket(),
        "launches": launches,
    }
    log("  " + json.dumps(stats))
    if not np.isfinite(poses).all():
        raise AssertionError("non-finite node poses")
    if stats["loop_closures"] < 1:
        raise AssertionError("the slice closed no loop")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} was not launched by the slice")
    return stats, rec, slam


# --------------------------------------------------------------------------
# Phase 5: times
# --------------------------------------------------------------------------


def time_ms(torch, fn, iters=20):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound_ms(bytes_moved, ops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def cells_read(torch, value_map, map_idx, centers):
    """Distinct in-map cells of ``value_map`` ([H, W], or [M, H, W] with
    ``map_idx`` i32[Q]) that lie within rx columns and ry rows of any
    center. ``centers``: list of (ix, iy, keep, rx, ry), ix/iy int [Q, ...]
    and keep bool of the same shape. A center off the map still counts the
    cells of its window that lie on it."""
    m = 1 if value_map.dim() == 2 else value_map.shape[0]
    h, w = value_map.shape[-2:]
    pad = max(max(rx, ry) for *_, rx, ry in centers)
    read = torch.zeros((m, h, w), dtype=torch.bool,
                       device=value_map.device)
    for ix, iy, keep, rx, ry in centers:
        hit = torch.zeros((m, h + 2 * pad, w + 2 * pad), dtype=torch.float32,
                          device=value_map.device)
        px, py = ix.long() + pad, iy.long() + pad
        ok = keep & (px >= 0) & (px < w + 2 * pad) & (py >= 0) & \
            (py < h + 2 * pad)
        q = ix.shape[0]
        mi = torch.zeros(q, dtype=torch.long, device=ix.device) \
            if map_idx is None else map_idx.long()
        mi = mi.reshape((q,) + (1,) * (ix.dim() - 1)).expand_as(ix)
        hit[mi[ok], py[ok], px[ok]] = 1.0
        near = torch.nn.functional.max_pool2d(
            hit[:, None], (2 * ry + 1, 2 * rx + 1), stride=1,
            padding=(ry, rx))[:, 0]
        read |= near[:, pad:pad + h, pad:pad + w] > 0
    return int(read.sum())


def phase_times(torch, rec, stats, slam, errs):
    """Per main-path shape of each kernel: the kernel against its plain
    version on the slice's inputs (held to phase 3's tolerances), both
    timed, and the bound."""
    from my_lidar_graph_slam_tpu_torch.ops.cuda import correlate, greedy_cost

    rows = []
    for (path, q), (args, kw) in sorted(rec[0].calls.items()):
        vm, ix, iy, w, wx, wy, *rest = args
        map_idx = rest[0] if rest else kw.get("map_idx")
        out = correlate.window_scores(vm, ix, iy, w, wx, wy, map_idx)
        ref = correlate.window_scores_plain(vm, ix, iy, w, wx, wy, map_idx)
        torch.cuda.synchronize()
        err = check_k1(f"{path} Q={q} (main-path inputs)", out, ref, torch)
        _, nt, nb = ix.shape
        live = (w != 0)[:, None, :].expand_as(ix)
        n_live = int(live.sum())                # live (q, theta, beam)
        cells = (2 * wx + 1) * (2 * wy + 1)
        ops = 2.0 * n_live * cells              # one multiply-add each
        read = cells_read(torch, vm, map_idx, [(ix, iy, live, wx, wy)])
        moved = 4 * read + 8 * n_live + nbytes(w, map_idx, out)
        b, by = bound_ms(moved, ops)
        rows.append({
            "name": f"window_scores[{path} Q={q}]", "route": "cuda",
            "source": "my_lidar_graph_slam_tpu_torch/csrc/correlate.cu",
            "replaces": "my_lidar_graph_slam_tpu/ops/pallas/"
                        "correlate_mxu.py:191",
            "launches": rec[0].counts[(path, q)],
            "max_abs_err": err,
            "edge_cases_max_abs_err": errs["window_scores"],
            "ms": time_ms(torch, lambda: correlate.window_scores(
                vm, ix, iy, w, wx, wy, map_idx)),
            "plain_ms": time_ms(torch, lambda: correlate.window_scores_plain(
                vm, ix, iy, w, wx, wy, map_idx), iters=3),
            "bound_ms": b, "bound_by": by, "library_ms": None,
            "shape": {"Q": q, "NT": nt, "NB": nb, "window": [2 * wx + 1,
                                                             2 * wy + 1],
                      "map": list(vm.shape[-2:]), "map_cells_read": read}})

    res = slam.builder.config.resolution
    for (path, q), (args, kw) in sorted(rec[1].calls.items()):
        vm, cells, mask, table, k, thr, *rest = args
        map_idx = rest[0] if rest else kw.get("map_idx")
        gp = dict(slam.frontend.matcher.greedy_params if path == "frontend"
                  else slam.backend.detector.greedy_params)
        scaling = gp.get("scaling_factor", 0.05)
        raw = greedy_cost.greedy_cost_core(vm, cells, mask, table, k, thr,
                                           map_idx)
        raw_ref = greedy_cost.greedy_cost_core_plain(vm, cells, mask, table,
                                                     k, thr, map_idx)
        torch.cuda.synchronize()
        err = check_k2(f"{path} Q={q} (main-path inputs)",
                       greedy_cost._epilogue(raw, res, scaling),
                       greedy_cost._epilogue(raw_ref, res, scaling), torch)
        nb = cells.shape[3]
        n_masked = int(mask.sum())
        # Reads per masked beam: the (2k+3)^2 patches around the base hit
        # and missed cells, the (2k+1)^2 kernels of the 4 theta cells.
        reads = 2 * (2 * k + 3) ** 2 + 4 * (2 * k + 1) ** 2
        ops = n_masked * reads * 6.0            # read, 4 tests, min
        read = cells_read(torch, vm, map_idx, [
            (cells[:, j, 0], cells[:, j + 1, 0], mask, k + 1, k + 1)
            for j in (0, 2)] + [
            (cells[:, j, a], cells[:, j + 1, a], mask, k, k)
            for a in (1, 2) for j in (0, 2)])
        moved = 4 * read + 4 * 12 * n_masked + \
            nbytes(mask, table, map_idx, raw)
        b, by = bound_ms(moved, ops)
        rows.append({
            "name": f"greedy_cost[{path} Q={q}]", "route": "cuda",
            "source": "my_lidar_graph_slam_tpu_torch/csrc/greedy_cost.cu",
            "replaces": "my_lidar_graph_slam_tpu/ops/pallas/"
                        "greedy_cost_mxu.py:233",
            "launches": rec[1].counts[(path, q)],
            "max_abs_err": err,
            "edge_cases_max_abs_err": errs["greedy_cost"],
            "ms": time_ms(torch, lambda: greedy_cost.greedy_cost_core(
                vm, cells, mask, table, k, thr, map_idx)),
            "plain_ms": time_ms(torch, lambda:
                                greedy_cost.greedy_cost_core_plain(
                                    vm, cells, mask, table, k, thr,
                                    map_idx), iters=5),
            "bound_ms": b, "bound_by": by, "library_ms": None,
            "shape": {"Q": q, "NB": nb, "kernel_size": k,
                      "map": list(vm.shape[-2:]), "map_cells_read": read}})
    for name, key in (("window_scores", 0), ("greedy_cost", 1)):
        if sum(rec[key].counts.values()) != stats["launches"][name]:
            raise AssertionError(f"{name}: per-shape counts do not add up "
                                 "to the launch counter")
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from my_lidar_graph_slam_tpu_torch.ops.cuda import loader

    # Scores are sums of up to 1024 occupancies; TF32 keeps ~3 digits.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[1/5] device: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {kind}")

    t0 = time.perf_counter()
    loader.build_all()
    log(f"[2/5] build: {time.perf_counter() - t0:.2f} s")
    for name, text in loader.ptxas_report.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    with tempfile.TemporaryDirectory(dir=REPO,
                                     prefix="chip_smoke_") as workdir:
        t0 = time.perf_counter()
        # Phase 3 runs before the slice, so it uses the default config's
        # beam capacity for NB.
        dev = torch.device("cuda")
        errs = phase_kernels(torch, dev, 1024)
        log(f"[3/5] kernels vs plain: ok in {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        stats, rec, slam = phase_slice(torch, dev, workdir)
        log(f"[4/5] slice: ok in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    rows = phase_times(torch, rec, stats, slam, errs)
    for r in rows:
        log(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.3f} ms, "
            f"bound {r['bound_ms']:.5f} ms by {r['bound_by']}), "
            f"{r['launches']} launches, max|err| vs plain "
            f"{r['max_abs_err']:.3g} {json.dumps(r['shape'])}")
    log(f"[5/5] times: ok in {time.perf_counter() - t0:.1f} s")

    print(json.dumps({"kernels": rows, "slice": stats}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
