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
   1024^2 and 1536^2 maps). K1: off-map edges, far-out zero-weight beams,
   every beam a border beam, border and interior beams in one row, all
   weights zero (scores exactly 0), 13 live beams (not a multiple of the
   beam split), NB = 384, ``map_idx`` over stacked maps, and border and
   interior beams in one row at the 41x41 window. K2: kernel_size
   1, 2 and 3 (the run-time body) at Q = 1 and 8, a 40 m range,
   ``map_idx``; its core must equal the plain core bit for bit. Every
   case is launched twice and the two outputs must be bit-equal (for K2
   this also shows that its scratch clears itself). Phase 5 holds them
   again on the slice's own inputs.
4. Slice: the default online SLAM path (``configs/
   launcher_settings_default.json``, synchronous backend) over a synthetic
   intel-like world, 2 laps at 0.08 m steps, through ``config.load``,
   ``config.create_slam``, ``carmen.load`` and ``process_scan``. The launch
   counters (K1's and K2's, K3's ``RaycastKernelLaunches`` and the plain
   cast's ``RaycastPlainScans``) are zeroed just before and read just
   after, as in phases 6 to 11; each of them fails if a kernel did not
   launch or the plain cast ran on the card.
6. Launcher: ``launcher.run`` (the entry point of ``python -m
   my_lidar_graph_slam_tpu_torch.launcher``) on
   ``configs/launcher_settings_robust.json`` verbatim (up to 3 candidate
   maps per detection pass, DCS), in replay mode with chunks of 16
   keyframes, on phase 4's log and ground truth. Every artifact must
   exist; the checkpoint and pose graph are read back by the port's
   loaders, the PNGs by its PNG reader; at least one loop closure, at
   least one detection pass over a stack of two or more maps, a finite
   ATE.
7. Async: the default settings (synchronous backend) over the log's first
   800 scans, four runs in turns (blocking, pipelined, pipelined,
   blocking); node and edge counts equal, node poses within 1e-5,
   latest-map values within 1e-4, each run against the first.
   The pipelined frontend notifies the backend with the graph one
   keyframe behind, so from the first loop candidate on the two runs
   search from different nodes and part by design (the JAX package's
   parity test has no backend for that reason): the prefix ends before
   the first candidate, and the phase fails if the blocking run closed a
   loop in it.
8. BranchBound frontend: ``launcher.run`` on
   ``configs/launcher_settings_bb_frontend.json`` verbatim, online
   (blocking frontend, synchronous backend), on phase 4's log and ground
   truth. Every artifact must exist; at least one closure, a finite ATE,
   K1 (the detector sweep) and K2 (the cost tail of the branch-and-bound
   match and of the sweep) launched. Prints nodes, edges, closures, loop
   edges, ATE, scans/s, median keyframe ms, the total
   ``frontier_overflow`` and the host synchronizations per keyframe that
   PyTorch's sync debug mode reports (uploads of the scans included).
9. Device pose-graph solver (``models/optimizer_lm.py``): (a) phase 4's
   final graph and (b) a ring of 8192 nodes (``io/synth.py::ring_graph``,
   seed 0, 4 loop edges), each solved on the card (CG with the chain
   preconditioner, the default settings' LM config; (b) with TF32 off and
   with TF32 on) three times and by the host solver; poses finite and
   within 0.05 m of the host solver's in x and y; device ms (median of
   3), host ms, LM and CG iterations, host reads, the run-to-run spread.
   (c) The default settings over the log's first 2000 scans with
   ``host_solver_max_nodes`` = 128, so every backend pass above 128
   nodes solves on the card inside ``Backend.run_once``: at least one
   closure, a device solve, a finite ATE, K1 and K2 launched.
10. The rest of the port: (a) ``launcher.run`` online (blocking
   frontend, synchronous backend) on a copy of
   ``configs/launcher_settings_default.json`` whose loop detector is the
   RealTimeCorrelative one (``Backend.LoopDetectorType`` and its group;
   every other key verbatim), on phase 4's log and ground truth: every
   artifact, at least one closure, a finite ATE, and K2 launched on a
   local map, recorded under the path "detection-rtc". Prints nodes,
   edges, closures, loop edges, ATE, scans/s, median keyframe ms, median
   and max ms per detection pass, host synchronizations per detection
   pass (sync debug mode), escalations (and how many of them padded rows
   alone asked for), passes still uncertified after escalation, padded
   rows and stale coarse maps. (b) The default
   settings over the log's first 800 scans; at each keyframe the pruned
   frontend path (``CorrelativeMatcher(use_sweep=False)``) also matches
   the same latest map, scan and prior, without feeding its result back;
   its pose must sit at the sweep's lattice cell on every keyframe whose
   best sweep score is not tied within K1's tolerance. Prints the ties,
   the certificate hit rate, the sweep re-runs and each path's match
   time per keyframe (from an empty queue to the pose on the host,
   median and max); its kernel calls are
   recorded under "frontend-pruned". (c) The native CARMEN tokenizer
   (``io/carmen.py::load_old_laser_fast``, built with the host's C++
   compiler) against ``carmen.load`` on phase 4's log: the same scans,
   ranges within 1e-4 and poses within 1e-9; both parse times.
11. The parallel layer (``parallel/``): (a) phase 4's final graph and the
   ring of phase 9, each solved by the node-sharded and the edge-sharded
   LM over ``Mesh([cuda:0] * 4)`` (median of 3 solves at 661 nodes, one
   on the ring): poses finite and within 0.05 m of the host solver's in x
   and y; ms per solve, LM and CG steps, host reads, psum calls and
   bytes, ``psum_bytes_per_cg_step``. (b) ``launcher.run(...,
   mesh_devices=1)`` on the default settings, verbatim, online and
   blocking, over the log's first 1600 scans: every artifact, at least
   one closure and one node-sharded solve, a finite ATE, K2 launched at
   the path "detection-fanout" (the branch-and-bound fan-out detector's
   cost tail) and K1 at the frontend; scans/s, closures, loop edges,
   ATE, median ms per detection pass (queue drained first) and per
   solve, ``frontier_overflow``, padded rows and the accepted loop nodes
   outside +-range/2. (c) Two processes under gloo, one shard each on
   card 0, run the edge- and node-sharded solves of phase 4's graph and
   one fan-out of (b); one process of world size 1 under NCCL runs a
   node-sharded solve (``python3 chip_smoke.py --mesh-worker ...``, all
   three at once, killed after 240 s). Each must agree with the same call
   over an in-process mesh of as many shards of the card: node-sharded x
   and y within 0.02 m, edge-sharded poses within 1e-3, the fan-out's
   found flags equal, poses within 1e-4 and scores rtol 1e-5.
5. Times (run last, on the inputs recorded by phases 4 and 6-11): first
   the launch floor, an empty kernel launched as the kernels are (ctypes,
   current stream), back to back and queued. Then, for every shape that
   any of those runs gave a kernel, keyed by (path, M, Q), the kernel and
   its plain version run again on the inputs of the last call at that
   shape in the first phase that gave it, and the row counts the launches
   at that shape in each phase's run; the outputs are held to
   phase 3's tolerances (K2 bit-equal) and to a relaunch (bit-equal). The
   kernel is timed with CUDA events three ways: back to back over 20 calls
   (``ms``; a call shorter than the wrapper's host time is timed at the
   host's rate), queued (``ms_queued``: the card sleeps while the host
   enqueues the 20 calls, so the time is the device's), and alone after a
   128 MB write (``cold_ms``, a cold L2). Beside it: the plain version's
   time; for K1 the library yardstick, ``embedding_bag(mode="sum",
   per_sample_weights=...)`` over flat indices into a zero-padded map
   (built outside the timed region, one theta chunk of at most 1.5e8
   indices at a time, the time summed over the chunks), held to K1's
   tolerance as well; and the least time the card could take: the larger
   of the bytes the call must move (the map cells it reads, counted on
   these inputs, plus the other inputs and the output, each once) over
   3.35 TB/s and its operations over 67 TFLOP/s, with its share of the
   back-to-back and queued times. Last K3, the map builder's cast, at
   each path that those runs gave it (one scan into a local map, the
   latest map's scans, a stacked rebuild, several scans into one map),
   on a copy of the arguments of the widest call at that path: the cast
   against the plain cast (``observed`` equal, log-odds within
   ``ops/raycast.py::kernel_tolerance``) and its relaunch (bit-equal),
   the kernel timed the same three ways in place, the plain cast's time,
   and the bound from the distinct cells the call touches (9 bytes each)
   and its scan inputs.

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
ROBUST = os.path.join(REPO, "configs", "launcher_settings_robust.json")
BB_FRONTEND = os.path.join(REPO, "configs",
                           "launcher_settings_bb_frontend.json")
LOG_NAME, GT_NAME = "intel2.clf", "intel2_gt.npz"
REPLAY_CHUNK = 16
# Phase 7's prefix of the log: on the ground truth the first loop
# candidate of the default settings appears at scan 840.
ASYNC_SCANS = 800
# Phase 9: the ring's size and loop edges, the backend run's prefix and
# solver threshold, and the tolerance against the host solver
# (tests/test_optimizer_solvers.py:100).
RING_NODES, RING_LOOPS = 8192, 4
DEVICE_SOLVER_SCANS, DEVICE_SOLVER_FROM = 2000, 128
SOLVER_ATOL = 0.05
# Phase 11: shards of the one card in (a), the mesh launcher run's prefix
# (phase 9(c)'s 2000 scans cut to keep the phase within 120 s; the first
# loop candidate comes at scan 840), and the (c) processes' collective and
# overall timeouts.
MESH_SHARDS = 4
MESH_SCANS = 1600
MESH_GROUP_TIMEOUT_S = 120
MESH_WORKER_TIMEOUT_S = 240
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
        again = correlate.window_scores(vm, ix, iy, w, win, win, map_idx)
        sl = slice(0, plain_q)
        ref = correlate.window_scores_plain(
            vm, ix[sl], iy[sl], w[sl], win, win,
            None if map_idx is None else map_idx[sl])
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"K1 {name}: two launches differ")
        e = check_k1(name, got[sl], ref, torch)
        errs["window_scores"] = max(errs["window_scores"], e)
        log(f"  K1 {name}: {tuple(got.shape)} max|err| {e:.3g}, "
            "bit-equal on relaunch")
        return got

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
    # Every beam a border beam (its window crosses an edge), and half the
    # beams of each (q, theta) border, half interior.
    rim = torch.tensor([-2, 0, 1023, 1025])
    bx = rim[torch.randint(0, 4, (1, 201, nb), generator=gen)].int().to(dev)
    k1("all border", m1, bx, iy, w, 2)
    half = (torch.rand((1, 1, nb), generator=gen) < 0.5).to(dev)
    k1("interior and border", m1, torch.where(half, bx, ix), iy, w, 2)
    # All weights zero: exactly 0. 13 live beams: not a multiple of the
    # beam split. NB = 384, the slice's bucket.
    zero = k1("all weights zero", m1, ix, iy, torch.zeros_like(w), 2)
    if bool((zero != 0).any()):
        raise AssertionError("K1 all weights zero: a score is not 0")
    w13 = torch.zeros_like(w)
    w13[:, torch.randperm(nb, generator=gen)[:13].to(dev)] = 1.0
    k1("13 live beams", m1, ix, iy, w13, 2)
    k1("NB 384", m1, ix[..., :384].contiguous(), iy[..., :384].contiguous(),
       w[:, :384].contiguous(), 2)

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
    # Border beams at the 41x41 window (windows crossing an edge) beside
    # interior ones, some touching an edge from inside.
    rim = torch.tensor([-20, -1, 0, 20, 1515, 1535, 1536, 1555])
    bx = rim[torch.randint(0, 8, (2, 401, nb), generator=gen)].int().to(dev)
    half = (torch.rand((2, 1, nb), generator=gen) < 0.5).to(dev)
    k1("detection, interior and border", m2, torch.where(half, bx, ix[:2]),
       iy[:2], w8[:2], 20)

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
        # The core itself: bit-equal to the plain core, and two calls in a
        # row give the same bits (the kernel's scratch clears itself).
        cells = greedy_cost.prepare_cells(origin, poses, ranges, angles, res,
                                          0.075)
        table = greedy_cost.class_table(res, k, 1.0, dev)
        core = (vm, cells, mask, table, k, 0.1, map_idx)
        raw = greedy_cost.greedy_cost_core(*core)
        raw2 = greedy_cost.greedy_cost_core(*core)
        raw_ref = greedy_cost.greedy_cost_core_plain(*core)
        torch.cuda.synchronize()
        e = check_k2(name, got, ref, torch)
        if not (torch.equal(raw, raw_ref) and torch.equal(raw, raw2)):
            raise AssertionError(f"K2 {name}: core not bit-equal to the "
                                 "plain core or to its own relaunch")
        errs["greedy_cost"] = max(errs["greedy_cost"], e)
        log(f"  K2 {name}: Q={q} k={k} max|err| {e:.3g}, core bit-equal "
            "to plain and on relaunch")

    # Smooth-ish map so that many kernel cells are usable.
    occ = (torch.rand((1024, 1024), generator=gen) < 0.15).float()
    occ = torch.nn.functional.max_pool2d(occ[None, None], 3, 1, 1)[0, 0]
    m3 = torch.where(occ > 0, torch.full_like(occ, 0.9),
                     torch.full_like(occ, 0.05)).to(dev)
    org = torch.tensor([-25.6, -25.6], device=dev)
    k2("frontend", m3, org, 1, 1, 20.0)
    k2("detection", m3, org, 8, 1, 20.0)
    k2("kernel_size 2", m3, org, 8, 2, 20.0)
    k2("kernel_size 2, Q=1", m3, org, 1, 2, 20.0)
    k2("kernel_size 3 (run-time k)", m3, org, 8, 3, 20.0)
    k2("kernel_size 3, Q=1", m3, org, 1, 3, 20.0)
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
    """Stands in for a kernel wrapper during a run: keeps the arguments of
    the last call at each shape, keyed by (path, M, Q), and counts the
    calls at each shape. The path is "frontend" for a call on the latest
    map and ``detection_path`` ("detection" unless the run names its
    detector) for one on a local map (the two have different widths; a
    stacked detection map [M, H, W] has a local map's width), or
    ``path_override`` while that is set. M is the depth of a stacked map,
    1 for a single map. ``last_out`` is the output of the last call."""

    def __init__(self, module, name, latest_width,
                 detection_path="detection"):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.latest_width = latest_width
        self.detection_path = detection_path
        self.path_override = None
        self.last_out = None
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
        path = self.path_override or (
            "frontend" if args[0].shape[-1] == self.latest_width
            else self.detection_path)
        m = args[0].shape[0] if args[0].dim() == 3 else 1
        key = (path, m, args[1].shape[0])
        self.calls[key] = (args, kwargs)
        self.counts[key] = self.counts.get(key, 0) + 1
        self.last_out = self.fn(*args, **kwargs)
        return self.last_out

    def restore(self):
        setattr(self.module, self.name, self.fn)


class CastRecorder:
    """Stands in for ``ops/raycast.py::integrate_scans_stacked`` (the cast
    that launches K3 on the card) during a run: counts its calls on CUDA
    tensors at each path and keeps a copy of the arguments of one call per
    path, the widest (most maps, then most scans; the last of equals). The
    path is "latest" for a map of the latest map's width, "local" for one
    scan into one map of another width, "rebuild" for a stack of maps and
    "scans" for several scans into one map (a single map's rebuild, a
    replay chunk, the global map)."""

    def __init__(self, latest_width):
        import inspect

        from my_lidar_graph_slam_tpu_torch.ops import raycast

        self.module = raycast
        self.fn = raycast.integrate_scans_stacked
        self.signature = inspect.signature(self.fn)
        self.latest_width = latest_width
        self.calls = {}
        self.counts = {}
        raycast.integrate_scans_stacked = self

    def __call__(self, *args, **kwargs):
        bound = self.signature.bind(*args, **kwargs)
        bound.apply_defaults()
        a = bound.arguments
        m, _, w = a["log_odds"].shape
        k = a["node_poses"].shape[1]
        if m and k and a["log_odds"].is_cuda:
            path = ("latest" if w == self.latest_width else
                    "local" if m == 1 and k == 1 else
                    "rebuild" if m > 1 else "scans")
            self.counts[path] = self.counts.get(path, 0) + 1
            kept = self.calls.get(path)
            if kept is None or (m, k) >= tuple(kept["node_poses"].shape[:2]):
                # Copies, for a donated map is written into by the call;
                # without ``donate``, for the plain cast takes none.
                self.calls[path] = {
                    n: v.clone() if hasattr(v, "clone") else v
                    for n, v in a.items() if n != "donate"}
        return self.fn(*args, **kwargs)

    def restore(self):
        self.module.integrate_scans_stacked = self.fn


K3_COUNTERS = ("RaycastKernelLaunches", "RaycastPlainScans")


def k3_counter(name):
    """The value of counter ``name`` of the current metrics, 0 where it
    does not exist (reading it does not create it)."""
    from my_lidar_graph_slam_tpu_torch.utils.metrics import MetricManager

    family = MetricManager.instance().counters
    return family(name).value if name in family.names() else 0


def ate_anchored(est, est_t, gt, gt_t):
    """Translational ATE RMSE with est anchored so that its first pose
    coincides with the ground truth's (after nearest-timestamp
    association); the aligned figure is ``utils/ate.py``'s."""
    from my_lidar_graph_slam_tpu_torch.utils import ate

    ei, gi = ate.associate(est_t, gt_t)
    e, g = est[ei], gt[gi]
    th = g[0, 2] - e[0, 2]
    c, s = np.cos(th), np.sin(th)
    p = g[0, :2] + (e[:, :2] - e[0, :2]) @ np.array([[c, -s], [s, c]]).T
    return float(np.sqrt(((p - g[:, :2]) ** 2).sum(1).mean()))


def slice_log(workdir):
    """The slice's log: the synthetic intel-like world, LAPS laps at STEP m,
    seed SEED, written to ``workdir`` (with its ground truth, the
    launcher's ``--gt`` npz) and read back through the port's CARMEN
    reader. Returns (scan records, ground-truth poses, ground-truth
    timestamps)."""
    from my_lidar_graph_slam_tpu_torch.io import carmen, synth
    from my_lidar_graph_slam_tpu_torch.sensor.data import RawScan

    sim = synth.SimConfig(step=STEP, seed=SEED)
    scans, gt = synth.simulate(synth.intel_world(),
                               synth.intel_waypoints(laps=LAPS), sim)
    log_path = os.path.join(workdir, LOG_NAME)
    synth.write_carmen_log(log_path, scans, max_range=sim.max_range)
    gt_t = np.array([s.timestamp for s in scans])
    np.savez(os.path.join(workdir, GT_NAME), true_poses=gt, timestamps=gt_t)
    records = [r for r in carmen.load(log_path) if isinstance(r, RawScan)]
    return records, gt, gt_t


def slice_slam(dev):
    """The slice's SLAM: the default settings, a synchronous backend."""
    from my_lidar_graph_slam_tpu_torch.utils import config

    return config.create_slam(config.load(SETTINGS), device=dev,
                              threaded_backend=False)


def start_recording(latest_width, detection_path="detection"):
    """Zero the three kernels' launch counters (K3's and the plain cast's
    in the current metrics) and put recorders in front of K1's and K2's
    wrappers and of the cast; returns the recorders."""
    from my_lidar_graph_slam_tpu_torch.ops.cuda import correlate, greedy_cost
    from my_lidar_graph_slam_tpu_torch.utils.metrics import MetricManager

    correlate.window_scores.launches = 0
    greedy_cost.greedy_cost_core.launches = 0
    family = MetricManager.instance().counters
    for name in K3_COUNTERS:
        if name in family.names():
            family(name).reset()
    return [Recorder(correlate, "window_scores", latest_width,
                     detection_path),
            Recorder(greedy_cost, "greedy_cost_core", latest_width,
                     detection_path),
            CastRecorder(latest_width)]


def stop_recording(rec, what):
    """Read the three launch counters, put the wrappers back, and fail
    unless every kernel launched during ``what`` and the plain cast never
    ran."""
    launches = {"window_scores": rec[0].fn.launches,
                "greedy_cost": rec[1].fn.launches,
                "raycast": k3_counter("RaycastKernelLaunches")}
    plain_scans = k3_counter("RaycastPlainScans")
    for r in rec:
        r.restore()
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} was not launched by {what}")
    if plain_scans:
        raise AssertionError(f"the plain cast ran {plain_scans} scans on "
                             f"the card in {what}")
    for r, k in zip(rec, launches):
        if sum(r.counts.values()) != launches[k]:
            raise AssertionError(f"{k}: per-shape counts do not add up to "
                                 f"the launch counter in {what}")
    return launches


def phase_slice(torch, dev, workdir):
    records, gt, gt_t = slice_log(workdir)
    slam = slice_slam(dev)
    rec = start_recording(slam.builder.config.latest_map_size)
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
    launches = stop_recording(rec, "the slice")

    from my_lidar_graph_slam_tpu_torch.utils import ate

    g = slam.graph
    poses = g.node_poses()
    times = slam.scans.timestamps[g.scan_ids[:g.num_nodes]]
    stats = {
        "scans": len(records), "nodes": g.num_nodes, "edges": g.num_edges,
        "loop_closures": slam.backend.num_loop_closures,
        "loop_edges": slam.backend.num_loop_edges,
        "ate_anchored_m": ate_anchored(poses, times, gt, gt_t),
        "ate_aligned_m": ate.ate_rmse(poses, gt, est_times=times,
                                      gt_times=gt_t),
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
    return stats, rec, slam, records, (gt, gt_t)


# --------------------------------------------------------------------------
# Phase 6: the robust config through the launcher, in replay mode
# --------------------------------------------------------------------------


def phase_launcher(torch, workdir):
    """``launcher.run`` on the robust settings, verbatim, in replay mode
    (chunks of REPLAY_CHUNK keyframes), on the slice's log, with its ground
    truth; the artifacts are read back through the port's own readers."""
    from my_lidar_graph_slam_tpu_torch import launcher
    from my_lidar_graph_slam_tpu_torch.io import map_io, png
    from my_lidar_graph_slam_tpu_torch.utils import config
    from my_lidar_graph_slam_tpu_torch.utils.metrics import MetricManager

    latest = int(config.load(ROBUST).get("Tpu.LatestMapSize", 1024))
    out = os.path.join(workdir, "robust")
    MetricManager.reset_instance()
    rec = start_recording(latest)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run = launcher.run(os.path.join(workdir, LOG_NAME), ROBUST, out,
                       replay_chunk=REPLAY_CHUNK,
                       gt_path=os.path.join(workdir, GT_NAME))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = stop_recording(rec, "the launcher run")

    suffixes = (".png", ".json", "-latest.png", "-latest.json",
                ".posegraph.json", "-posegraph.png", ".ckpt.npz",
                ".metrics.json")
    missing = [x for x in suffixes if not os.path.exists(out + x)]
    if missing:
        raise AssertionError(f"launcher artifacts missing: {missing}")
    graph, _ = map_io.load_checkpoint(out + ".ckpt.npz")
    pg = map_io.load_pose_graph(out + ".posegraph.json")
    if not graph.num_nodes == pg.num_nodes == run["num_nodes"]:
        raise AssertionError("checkpoint / pose graph node counts differ")
    images = {x: png.read_png(out + x).shape
              for x in (".png", "-latest.png", "-posegraph.png")}
    metrics = json.load(open(out + ".metrics.json"))
    shapes = sorted({(m, q) for (path, m, q) in rec[0].counts
                     if path == "detection"})
    multi = sum(n for (path, m, q), n in rec[0].counts.items() if m >= 2)
    stats = {
        "scans": run["num_scans"], "nodes": run["num_nodes"],
        "edges": run["num_edges"], "loop_closures": run["num_loop_closures"],
        "loop_edges": run["num_edges"] - (run["num_nodes"] - 1),
        "ate_aligned_m": run["ate_rmse_m"], "seconds": run["elapsed_s"],
        "scans_per_s": run["scans_per_s"], "wall_s": wall,
        "multi_candidate_passes": multi,
        "detection_shapes_MQ": shapes,
        "images": images,
        "loop_detect_queries": metrics["Counters"].get(
            "LoopDetectMxuQueries", {}).get("value"),
        "loop_detect_padded_queries": metrics["Counters"].get(
            "LoopDetectMxuPaddedQueries", {}).get("value"),
        "launches": launches,
    }
    log("  " + json.dumps(stats))
    if stats["loop_closures"] < 1:
        raise AssertionError("the launcher run closed no loop")
    if multi < 1:
        raise AssertionError("no detection pass stacked two or more maps")
    if not np.isfinite(stats["ate_aligned_m"]):
        raise AssertionError("the launcher run's ATE is not finite")
    return stats, rec


# --------------------------------------------------------------------------
# Phase 7: the async frontend against the blocking one
# --------------------------------------------------------------------------


def phase_async(torch, dev, records):
    """The default settings, a synchronous backend, the first ASYNC_SCANS
    scans of the slice's log, four runs in turns: blocking, async, async,
    blocking. Every run is held to the first one: equal node and edge
    counts, node poses within 1e-5 and latest-map values within 1e-4
    (tests/test_async_frontend.py:36-42), which holds only while no loop
    closes. Returns the stats and the first async run's recorders."""
    from my_lidar_graph_slam_tpu_torch.ops import grid as gridops

    runs, async_rec = [], None
    for mode in ("blocking", "async", "async", "blocking"):
        slam = slice_slam(dev)
        slam.frontend.async_pipeline = mode == "async"
        rec = start_recording(slam.builder.config.latest_map_size)
        key_ms = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for scan in records[:ASYNC_SCANS]:
            t1 = time.perf_counter()
            if slam.process_scan(scan, scan.odom_pose):
                key_ms.append(1e3 * (time.perf_counter() - t1))
        slam.stop_backend()
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = stop_recording(rec, f"the {mode} run")
        if mode == "async" and async_rec is None:
            async_rec = rec
        ref = runs[0][0] if runs else slam
        same_size = ref.graph.num_nodes == slam.graph.num_nodes
        runs.append((slam, {
            "mode": mode, "nodes": slam.graph.num_nodes,
            "edges": slam.graph.num_edges,
            "loop_closures": slam.backend.num_loop_closures,
            "seconds": elapsed,
            "keyframe_ms_median": float(np.median(key_ms)),
            "max_pose_err": float(np.abs(
                ref.graph.node_poses() - slam.graph.node_poses()).max())
            if same_size else float("inf"),
            "max_latest_map_err": float(
                (gridops.values(ref.builder.latest_map) -
                 gridops.values(slam.builder.latest_map)).abs().max()),
            "launches": launches}))
    stats = {"runs": [r for _, r in runs]}
    for mode in ("blocking", "async"):
        stats[f"{mode}_keyframe_ms_median_mean"] = float(np.mean(
            [r["keyframe_ms_median"] for _, r in runs if r["mode"] == mode]))
    log("  " + json.dumps(stats))
    first = runs[0][1]
    if first["loop_closures"]:
        raise AssertionError("the blocking run closed a loop in the prefix")
    for _, r in runs[1:]:
        if (r["nodes"], r["edges"]) != (first["nodes"], first["edges"]):
            raise AssertionError(f"{r['mode']} and blocking graphs differ "
                                 "in size")
        if r["max_pose_err"] > 1e-5 or r["max_latest_map_err"] > 1e-4:
            raise AssertionError(
                f"{r['mode']} differs from blocking: poses "
                f"{r['max_pose_err']}, latest map {r['max_latest_map_err']}")
    return stats, async_rec


# --------------------------------------------------------------------------
# Phase 8: the BranchBound frontend settings through the launcher
# --------------------------------------------------------------------------


class MethodSpy:
    """Wraps method ``name`` of ``cls`` while installed; ``around(fn, *args,
    **kwargs)`` is called in place of each call and returns its result."""

    def __init__(self, cls, name, around):
        self.cls, self.name, self.fn = cls, name, getattr(cls, name)
        fn = self.fn
        setattr(cls, name, lambda *a, **kw: around(fn, *a, **kw))

    def restore(self):
        setattr(self.cls, self.name, self.fn)


def phase_bb_frontend(torch, dev, workdir):
    """``launcher.run`` on the bb_frontend settings, verbatim, online
    (blocking frontend, synchronous backend) on the slice's log. Around
    each ``process_scan`` it times the keyframes and counts the host
    synchronizations that PyTorch's sync debug mode reports; around each
    ``resolve_async`` it adds up the matches' ``frontier_overflow``."""
    import warnings

    from my_lidar_graph_slam_tpu_torch import launcher
    from my_lidar_graph_slam_tpu_torch.models import scan_matchers
    from my_lidar_graph_slam_tpu_torch.models import slam as slam_mod
    from my_lidar_graph_slam_tpu_torch.utils import config
    from my_lidar_graph_slam_tpu_torch.utils.metrics import MetricManager

    cfg = config.load(BB_FRONTEND)
    if cfg.get("Frontend.LocalSlam.ScanMatcherType") != "BranchBound":
        raise AssertionError("the bb_frontend settings do not match with BB")
    latest = int(cfg.get("Tpu.LatestMapSize", 1024))
    out = os.path.join(workdir, "bb_frontend")
    key_ms, key_syncs, overflow = [], [], []

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")

        def timed_scan(fn, *args, **kwargs):
            n0, t0 = len(caught), time.perf_counter()
            updated = fn(*args, **kwargs)
            if updated:
                key_ms.append(1e3 * (time.perf_counter() - t0))
                key_syncs.append(len(caught) - n0)
            return updated

        def counted_resolve(fn, *args, **kwargs):
            summary = fn(*args, **kwargs)
            overflow.append(int(summary.frontier_overflow))
            return summary

        spies = [MethodSpy(slam_mod.LidarGraphSlam, "process_scan",
                           timed_scan),
                 MethodSpy(scan_matchers.AsyncMatcher, "resolve_async",
                           counted_resolve)]
        MetricManager.reset_instance()
        rec = start_recording(latest)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            probe = len(caught)
            torch.zeros(1, device=dev).cpu()
            sync_counting = len(caught) > probe
            t0 = time.perf_counter()
            run = launcher.run(os.path.join(workdir, LOG_NAME), BB_FRONTEND,
                               out, threaded_backend=False,
                               gt_path=os.path.join(workdir, GT_NAME))
        finally:
            torch.cuda.set_sync_debug_mode(0)
            for spy in spies:
                spy.restore()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = stop_recording(rec, "the bb_frontend run")

    suffixes = (".png", ".json", "-latest.png", "-latest.json",
                ".posegraph.json", "-posegraph.png", ".ckpt.npz",
                ".metrics.json")
    missing = [x for x in suffixes if not os.path.exists(out + x)]
    if missing:
        raise AssertionError(f"bb_frontend artifacts missing: {missing}")
    stats = {
        "scans": run["num_scans"], "nodes": run["num_nodes"],
        "edges": run["num_edges"], "loop_closures": run["num_loop_closures"],
        "loop_edges": run["num_edges"] - (run["num_nodes"] - 1),
        "ate_aligned_m": run["ate_rmse_m"], "seconds": run["elapsed_s"],
        "scans_per_s": run["scans_per_s"], "wall_s": wall,
        "keyframe_ms_median": float(np.median(key_ms)),
        "bb_matches": len(overflow),
        "frontier_overflow_total": int(sum(overflow)),
        "matches_with_overflow": int(sum(o > 0 for o in overflow)),
        "host_syncs_per_keyframe": float(np.mean(key_syncs))
        if sync_counting else None,
        "host_syncs_per_keyframe_median": float(np.median(key_syncs))
        if sync_counting else None,
        "host_syncs_max_keyframe": int(max(key_syncs))
        if sync_counting else None,
        "launches": launches,
    }
    log("  " + json.dumps(stats))
    if stats["loop_closures"] < 1:
        raise AssertionError("the bb_frontend run closed no loop")
    if not np.isfinite(stats["ate_aligned_m"]):
        raise AssertionError("the bb_frontend run's ATE is not finite")
    if len(overflow) != stats["nodes"] - 1:
        raise AssertionError("not every keyframe after the first was "
                             "matched by branch-and-bound")
    return stats, rec


# --------------------------------------------------------------------------
# Phase 9: the device pose-graph solver
# --------------------------------------------------------------------------


def set_tf32(torch, on: bool):
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    torch.set_float32_matmul_precision("high" if on else "highest")


def solver_rows(torch, dev, name, graph, lm_config, tf32_modes):
    """``graph`` solved by the host solver once and on the card three
    times per TF32 mode; fails unless the card's poses are finite and
    within SOLVER_ATOL of the host's in x and y."""
    from my_lidar_graph_slam_tpu_torch.models import (optimizer_host,
                                                      optimizer_lm)

    snap = graph.snapshot()
    n = graph.num_nodes
    t0 = time.perf_counter()
    host = optimizer_host.optimize_host(snap, lm_config)
    host_ms = 1e3 * (time.perf_counter() - t0)
    rows, first = [], None
    for tf32 in tf32_modes:
        set_tf32(torch, tf32)
        try:
            runs = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = optimizer_lm.optimize(snap, lm_config, dev)
                poses = res.poses.cpu().numpy()[:n]
                runs.append((1e3 * (time.perf_counter() - t0), poses, res))
        finally:
            set_tf32(torch, False)
        poses = [p for _, p, _ in runs]
        if first is None:
            first = poses[0]
        res = runs[0][2]
        row = {
            "graph": name, "tf32": tf32, "N": n, "E": graph.num_edges,
            "lm_iterations": res.iterations,
            "cg_iterations": res.cg_iterations,
            "host_syncs": res.host_syncs,
            "device_ms_median": float(np.median([ms for ms, _, _ in runs])),
            "device_ms": [ms for ms, _, _ in runs],
            "host_ms": host_ms, "host_lm_iterations": host.iterations,
            "max_xy_err_vs_host_m": float(max(
                np.abs(p[:, :2] - host.poses[:n, :2]).max() for p in poses)),
            "run_to_run_max_diff": float(max(
                np.abs(p - poses[0]).max() for p in poses)),
            "max_diff_vs_tf32_off": float(np.abs(poses[0] - first).max()),
            "total_error": float(res.total_error),
            "host_total_error": float(host.total_error)}
        log("  " + json.dumps(row))
        if not all(np.isfinite(p).all() for p in poses):
            raise AssertionError(f"solver {name}: non-finite poses")
        if row["max_xy_err_vs_host_m"] > SOLVER_ATOL:
            raise AssertionError(
                f"solver {name}: {row['max_xy_err_vs_host_m']} m from the "
                "host solver")
        rows.append(row)
    return rows


def phase_solver(torch, dev, slam4, records, gt, gt_t):
    """(a) phase 4's final graph and (b) the ring of RING_NODES, solved on
    the card and on the host; (c) the default settings over the log's
    first DEVICE_SOLVER_SCANS scans with the device solver from
    DEVICE_SOLVER_FROM nodes, inside ``Backend.run_once``."""
    from my_lidar_graph_slam_tpu_torch.io import synth
    from my_lidar_graph_slam_tpu_torch.utils import ate
    from my_lidar_graph_slam_tpu_torch.utils.metrics import MetricManager

    lm_config = slam4.backend.lm_config
    rows = solver_rows(torch, dev, "phase 4 final graph", slam4.graph,
                       lm_config, (False,))
    ring, _ = synth.ring_graph(RING_NODES, seed=SEED, n_loops=RING_LOOPS)
    rows += solver_rows(torch, dev, f"ring {RING_NODES}", ring, lm_config,
                        (False, True))

    slam = slice_slam(dev)
    slam.backend.host_solver_max_nodes = DEVICE_SOLVER_FROM
    MetricManager.reset_instance()
    rec = start_recording(slam.builder.config.latest_map_size)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for scan in records[:DEVICE_SOLVER_SCANS]:
        slam.process_scan(scan, scan.odom_pose)
    slam.stop_backend()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = stop_recording(rec, "the device-solver run")
    g = slam.graph
    poses = g.node_poses()
    times = slam.scans.timestamps[g.scan_ids[:g.num_nodes]]
    solve = MetricManager.instance().distributions(
        "PoseGraphSolveTime").to_dict()
    backend = {
        "scans": DEVICE_SOLVER_SCANS, "nodes": g.num_nodes,
        "edges": g.num_edges,
        "loop_closures": slam.backend.num_loop_closures,
        "device_solves": slam.backend.num_device_solves,
        "solve_ms_mean": 1e3 * solve["mean"],
        "solve_ms_max": 1e3 * solve["max"],
        "ate_aligned_m": ate.ate_rmse(poses, gt, est_times=times,
                                      gt_times=gt_t),
        "seconds": elapsed, "launches": launches}
    log("  " + json.dumps(backend))
    if backend["loop_closures"] < 1 or backend["device_solves"] < 1:
        raise AssertionError("the device-solver run closed no loop on the "
                             "card")
    if not np.isfinite(backend["ate_aligned_m"]) or \
            not np.isfinite(poses).all():
        raise AssertionError("the device-solver run is not finite")
    return {"solves": rows, "backend": backend}, rec


# --------------------------------------------------------------------------
# Phase 10: the correlative loop detector, the pruned frontend, the native
# reader
# --------------------------------------------------------------------------


def correlative_settings(workdir):
    """A copy of the default settings in ``workdir`` whose only change is
    the loop detector: ``Backend.LoopDetectorType`` RealTimeCorrelative
    with its group; returns its path."""
    with open(SETTINGS) as f:
        tree = json.load(f)
    tree["Backend"]["LoopDetectorType"] = "RealTimeCorrelative"
    tree["Backend"]["LoopDetectorConfigGroup"] = \
        "LoopDetectorRealTimeCorrelative"
    path = os.path.join(workdir, "settings_correlative.json")
    with open(path, "w") as f:
        json.dump(tree, f, indent=4)
    return path


def phase_correlative(torch, dev, workdir):
    """(a) ``launcher.run`` on the default settings with the
    RealTimeCorrelative loop detector, online (blocking frontend,
    synchronous backend), on the slice's log with its ground truth. Around
    each detection pass it drains the card's queue, then times the pass
    and counts the host synchronizations that PyTorch's sync debug mode
    reports; K2 calls on a local map are recorded under the path
    "detection-rtc"."""
    import warnings

    from my_lidar_graph_slam_tpu_torch import launcher
    from my_lidar_graph_slam_tpu_torch.models import loop_closure
    from my_lidar_graph_slam_tpu_torch.utils import config
    from my_lidar_graph_slam_tpu_torch.utils.metrics import MetricManager

    settings = correlative_settings(workdir)
    cfg = config.load(settings)
    latest = int(cfg.get("Tpu.LatestMapSize", 1024))
    out = os.path.join(workdir, "correlative")
    key_ms, pass_ms, pass_syncs = [], [], []

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")

        def timed_scan(fn, *args, **kwargs):
            t0 = time.perf_counter()
            updated = fn(*args, **kwargs)
            if updated:
                key_ms.append(1e3 * (time.perf_counter() - t0))
            return updated

        def timed_detect(fn, *args, **kwargs):
            # Drain the frontend's queued work first, so that the time is
            # the pass's own (the backend's LoopDetectionTime includes it).
            torch.cuda.synchronize()
            n0, t0 = len(caught), time.perf_counter()
            results = fn(*args, **kwargs)
            pass_ms.append(1e3 * (time.perf_counter() - t0))
            pass_syncs.append(len(caught) - n0)
            return results

        # Which rows asked for each escalation: the certificate of every
        # refinement is kept on the card and read after the run.
        batches = []

        def note_rows(fn, n):
            batches.append({"real": n, "exact": []})
            return fn(n)

        def keep_exact(fn, *args, **kwargs):
            out = fn(*args, **kwargs)
            batches[-1]["exact"].append(out[2])
            return out

        from my_lidar_graph_slam_tpu_torch.models import slam as slam_mod
        from my_lidar_graph_slam_tpu_torch.ops import correlative_coarse
        spies = [MethodSpy(slam_mod.LidarGraphSlam, "process_scan",
                           timed_scan),
                 MethodSpy(loop_closure.LoopDetectorCorrelative, "detect",
                           timed_detect),
                 MethodSpy(loop_closure, "_bucket_batch", note_rows),
                 MethodSpy(correlative_coarse, "_refine", keep_exact)]
        MetricManager.reset_instance()
        rec = start_recording(latest, "detection-rtc")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            probe = len(caught)
            torch.zeros(1, device=dev).cpu()
            sync_counting = len(caught) > probe
            t0 = time.perf_counter()
            run = launcher.run(os.path.join(workdir, LOG_NAME), settings,
                               out, threaded_backend=False,
                               gt_path=os.path.join(workdir, GT_NAME))
        finally:
            torch.cuda.set_sync_debug_mode(0)
            for spy in spies:
                spy.restore()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = stop_recording(rec, "the correlative-detector run")
    # An escalation is asked for by padding alone when every row whose
    # certificate failed on the refinement before it is a padded one.
    padding_only = real_asked = 0
    for b in batches:
        for exact in b["exact"][:-1]:
            failed = ~exact.cpu().numpy()
            if failed[:b["real"]].any():
                real_asked += 1
            else:
                padding_only += 1

    suffixes = (".png", ".json", "-latest.png", "-latest.json",
                ".posegraph.json", "-posegraph.png", ".ckpt.npz",
                ".metrics.json")
    missing = [x for x in suffixes if not os.path.exists(out + x)]
    if missing:
        raise AssertionError(f"correlative-run artifacts missing: {missing}")
    metrics = json.load(open(out + ".metrics.json"))
    counters = metrics["Counters"]
    backend_ms = metrics["Distributions"].get("LoopDetectionTime", {})

    def counter(name):
        return counters.get(name, {}).get("value", 0)

    rtc_k2 = {f"M={m} Q={q}": n for (path, m, q), n in rec[1].counts.items()
              if path == "detection-rtc"}
    stats = {
        "scans": run["num_scans"], "nodes": run["num_nodes"],
        "edges": run["num_edges"], "loop_closures": run["num_loop_closures"],
        "loop_edges": run["num_edges"] - (run["num_nodes"] - 1),
        "ate_aligned_m": run["ate_rmse_m"], "seconds": run["elapsed_s"],
        "scans_per_s": run["scans_per_s"], "wall_s": wall,
        "keyframe_ms_median": float(np.median(key_ms)),
        "detection_passes": len(pass_ms),
        "detection_pass_ms_median": float(np.median(pass_ms))
        if pass_ms else None,
        "detection_pass_ms_max": float(max(pass_ms)) if pass_ms else None,
        "loop_detection_time_ms_mean": 1e3 * backend_ms.get("mean", 0.0),
        "loop_detection_time_ms_max": 1e3 * backend_ms.get("max", 0.0),
        "host_syncs_per_detection_pass": float(np.mean(pass_syncs))
        if sync_counting and pass_syncs else None,
        "host_syncs_per_detection_pass_max": int(max(pass_syncs))
        if sync_counting and pass_syncs else None,
        "escalations": counter("LoopDetectCorrelativeEscalations"),
        "escalations_asked_by_padding_only": padding_only,
        "escalations_asked_by_real_rows": real_asked,
        "passes_inexact_after_escalation": counter(
            "LoopDetectCorrelativeInexact"),
        "padded_rows": counter("LoopDetectMxuPaddedQueries"),
        "real_rows": counter("LoopDetectMxuQueries"),
        "stale_coarse_maps": counter("LoopDetectStaleCoarseMaps"),
        "k2_detection_rtc_launches": rtc_k2,
        "launches": launches,
    }
    log("  " + json.dumps(stats))
    if padding_only + real_asked != stats["escalations"]:
        raise AssertionError("the certificates read after the run account "
                             "for another number of escalations than the "
                             "detector's counter")
    if stats["loop_closures"] < 1:
        raise AssertionError("the correlative-detector run closed no loop")
    if not np.isfinite(stats["ate_aligned_m"]):
        raise AssertionError("the correlative-detector run's ATE is not "
                             "finite")
    if not rtc_k2:
        raise AssertionError("K2 never launched on the detection-rtc path")
    return stats, rec


def live_scores(torch, scores, store, scan_id, matcher, resolution):
    """One frontend sweep's window scores (K1's output f32[1, NT, 5, 5])
    without the thetas outside the scan's live window, flattened; the
    live window is the sweep's own (``matchers_sweep._sweep``), computed
    on the card as it computes it."""
    from my_lidar_graph_slam_tpu_torch.ops import grid as gridops
    from my_lidar_graph_slam_tpu_torch.ops import matchers

    dev = scores.device
    nb = store.beam_bucket()
    valid = store.valid[scan_id, :nb]
    max_range = torch.tensor(float(store.ranges[scan_id, :nb][valid].max()),
                             dtype=torch.float32, device=dev).clamp(
        max=matcher.scan_range_max)
    step = matchers.search_step_theta(gridops.scalar(resolution, dev),
                                      max_range)
    win_t = (scores.shape[1] - 1) // 2
    win_act = int(torch.ceil(0.5 * gridops.scalar(matcher.range_theta, dev)
                             / step).clamp(max=win_t))
    return scores[0, win_t - win_act:win_t + win_act + 1].reshape(-1)


def phase_pruned(torch, dev, records):
    """(b) The default settings over the log's first ASYNC_SCANS scans; at
    each keyframe the pruned frontend path also matches the same latest
    map, scan and prior, and its result is not fed back. Its pose must
    sit at the sweep's lattice cell on every keyframe whose sweep best
    score is not tied (the top two live window scores within K1's
    tolerance). Its K1 and K2 calls are recorded under the path
    "frontend-pruned"."""
    import dataclasses

    from my_lidar_graph_slam_tpu_torch.models import scan_matchers
    from my_lidar_graph_slam_tpu_torch.utils.metrics import MetricManager

    slam = slice_slam(dev)
    sweep = slam.frontend.matcher
    pruned = dataclasses.replace(sweep, use_sweep=False)
    res = slam.builder.config.resolution
    MetricManager.reset_instance()
    rec = start_recording(slam.builder.config.latest_map_size)
    rows = []

    def both(fn, self, grid, store, scan_id, initial_pose):
        if self is not sweep:
            return fn(self, grid, store, scan_id, initial_pose)
        # Each path is timed alone from an empty queue to its resolved
        # pose on the host.
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pending = fn(self, grid, store, scan_id, initial_pose)
        ref = self.resolve_async(pending, initial_pose)
        sweep_ms = 1e3 * (time.perf_counter() - t0)
        scores = live_scores(torch, rec[0].last_out, store, scan_id, sweep,
                             res)
        top2 = torch.topk(scores, 2).values.cpu().numpy()
        for r in rec:
            r.path_override = "frontend-pruned"
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = pruned.resolve_async(
                pruned.match_async(grid, store, scan_id, initial_pose),
                initial_pose)
            pruned_ms = 1e3 * (time.perf_counter() - t0)
        finally:
            for r in rec:
                r.path_override = None
        rows.append(dict(
            sweep_ms=sweep_ms, pruned_ms=pruned_ms,
            tied=bool(top2[0] - top2[1] <= K1_ATOL + K1_RTOL * abs(top2[0])),
            exact=pruned.last_exact_fraction == 1.0,
            dpose=float(np.abs(np.asarray(got.estimated_pose, np.float64) -
                               np.asarray(ref.estimated_pose)).max())))
        return pending

    spy = MethodSpy(scan_matchers.CorrelativeMatcher, "match_async", both)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        for scan in records[:ASYNC_SCANS]:
            slam.process_scan(scan, scan.odom_pose)
        slam.stop_backend()
    finally:
        spy.restore()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = stop_recording(rec, "the pruned-frontend run")
    counters = MetricManager.instance()
    differ = [r for r in rows if r["dpose"] > 1e-6]
    stats = {
        "scans": ASYNC_SCANS, "keyframes": len(rows),
        "ties": sum(r["tied"] for r in rows),
        "certificate_hit_rate": float(np.mean([r["exact"] for r in rows])),
        "sweep_reruns": counters.counters("FrontendPrunedReruns").value,
        "pruned_matches": counters.counters("FrontendPrunedMatches").value,
        "poses_differ": len(differ),
        "poses_differ_untied": sum(not r["tied"] for r in differ),
        "max_pose_diff": max((r["dpose"] for r in rows), default=0.0),
        "sweep_match_ms_median": float(np.median(
            [r["sweep_ms"] for r in rows])) if rows else None,
        "pruned_match_ms_median": float(np.median(
            [r["pruned_ms"] for r in rows])) if rows else None,
        "sweep_match_ms_max": max((r["sweep_ms"] for r in rows),
                                  default=None),
        "pruned_match_ms_max": max((r["pruned_ms"] for r in rows),
                                   default=None),
        "seconds": elapsed, "launches": launches}
    log("  " + json.dumps(stats))
    if stats["poses_differ_untied"]:
        raise AssertionError("the pruned frontend left the sweep's lattice "
                             "cell on an untied keyframe")
    if not rows:
        raise AssertionError("the pruned-frontend run matched no keyframe")
    return stats, rec


def phase_native_reader(workdir):
    """(c) The native tokenizer (built from the checkout's source with the
    host's C++ compiler) against the Python reader on the slice's log:
    the same scans, ranges within 1e-4 and poses within 1e-9
    (tests/test_aux.py:155-169); both parse times."""
    from my_lidar_graph_slam_tpu_torch.io import carmen
    from my_lidar_graph_slam_tpu_torch.sensor.data import RawScan

    path = os.path.join(workdir, LOG_NAME)
    t0 = time.perf_counter()
    carmen.tokenizer_library()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fast = carmen.load_old_laser_fast(path)
    fast_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    py = [r for r in carmen.load(path) if isinstance(r, RawScan)]
    py_s = time.perf_counter() - t0
    if len(fast) != len(py):
        raise AssertionError(f"native reader: {len(fast)} scans against "
                             f"{len(py)}")
    err_r = max(float(np.abs(a.ranges - b.ranges).max())
                for a, b in zip(py, fast))
    err_p = max(float(np.abs(a.odom_pose - b.odom_pose).max())
                for a, b in zip(py, fast))
    stats = {"scans": len(fast), "native_s": fast_s, "python_s": py_s,
             "build_s": build_s, "max_range_err": err_r,
             "max_pose_err": err_p}
    log("  " + json.dumps(stats))
    if err_r > 1e-4 or err_p > 1e-9:
        raise AssertionError("the native reader differs from the Python "
                             "reader")
    return stats


# --------------------------------------------------------------------------
# Phase 11: the parallel layer (mesh, multi-process runtime, sharded
# solvers, branch-and-bound fan-out)
# --------------------------------------------------------------------------


def sharded_rows(torch, name, snap, n, lm_config, mesh, runs, host):
    """The node- and edge-sharded solves of ``snap`` over ``mesh``,
    ``runs`` times each; fails unless the poses are finite and within
    SOLVER_ATOL of the host solver's in x and y. Returns the rows and the
    last poses of each solver."""
    from my_lidar_graph_slam_tpu_torch.parallel import distributed, multihost

    d = mesh.num_shards
    sharded = distributed.partition_graph_by_nodes(snap, d)
    solvers = {
        "nodes": lambda: distributed.optimize_sharded_nodes(
            sharded, lm_config, mesh),
        "edges": lambda: distributed.optimize_sharded(snap, lm_config, mesh)}
    rows, last = [], {}
    for solver, solve in solvers.items():
        times = []
        for _ in range(runs):
            calls0, bytes0 = mesh.psum_calls, mesh.psum_bytes
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = solve()
            poses = multihost.fetch_global(res.poses)[:n]
            times.append(1e3 * (time.perf_counter() - t0))
        last[solver] = poses
        row = {"graph": name, "solver": solver, "shards": d, "N": n,
               "ms_median": float(np.median(times)), "ms": times,
               "lm_iterations": res.iterations,
               "cg_iterations": res.cg_iterations,
               "host_syncs": res.host_syncs,
               "psum_calls": mesh.psum_calls - calls0,
               "psum_bytes": mesh.psum_bytes - bytes0,
               "max_xy_err_vs_host_m": float(
                   np.abs(poses[:, :2] - host[:n, :2]).max()),
               "total_error": float(res.total_error)}
        if solver == "nodes":
            row["psum_bytes_per_cg_step"] = \
                distributed.psum_bytes_per_cg_step(sharded)
            row["cross_edges"] = int(sharded.c_mask.sum())
        log("  " + json.dumps(row))
        if not np.isfinite(poses).all():
            raise AssertionError(f"{solver}-sharded solve of {name}: "
                                 "non-finite poses")
        if row["max_xy_err_vs_host_m"] > SOLVER_ATOL:
            raise AssertionError(
                f"{solver}-sharded solve of {name}: "
                f"{row['max_xy_err_vs_host_m']} m from the host solver")
        rows.append(row)
    return rows, last


def phase_mesh_solvers(torch, dev, slam4):
    """(a) phase 4's final graph and the RING_NODES ring, each solved by
    the node- and the edge-sharded LM over MESH_SHARDS shards of the one
    card (median of 3 solves at 661 nodes, one at the ring), against the
    host solver."""
    from my_lidar_graph_slam_tpu_torch.io import synth
    from my_lidar_graph_slam_tpu_torch.models import optimizer_host
    from my_lidar_graph_slam_tpu_torch.models.slam import _round_multiple
    from my_lidar_graph_slam_tpu_torch.parallel.mesh import Mesh

    lm_config = slam4.backend.lm_config
    mesh = Mesh(devices=[dev] * MESH_SHARDS)
    rows = []
    ring, _ = synth.ring_graph(RING_NODES, seed=SEED, n_loops=RING_LOOPS)
    for name, graph, runs in (("phase 4 final graph", slam4.graph, 3),
                              (f"ring {RING_NODES}", ring, 1)):
        snap = graph.snapshot(edge_cap=_round_multiple(graph.num_edges,
                                                       MESH_SHARDS))
        host = optimizer_host.optimize_host(snap, lm_config).poses
        rows += sharded_rows(torch, name, snap, graph.num_nodes, lm_config,
                             mesh, runs, host)[0]
    return rows


def phase_mesh_launcher(torch, workdir):
    """(b) ``launcher.run(..., mesh_devices=1)`` on the default settings,
    verbatim, online and blocking, over the log's first MESH_SCANS scans:
    the node-sharded solve at every closure and the branch-and-bound
    fan-out detector, K2 recorded at "detection-fanout". Each detection
    pass is timed after the queue is drained, and the accepted loop nodes
    whose match lies outside the configured +-range/2 window (inside BB's
    rounded-up lattice) are counted. Returns the stats, the recorders and
    the last fan-out call that found a row (for (c))."""
    from my_lidar_graph_slam_tpu_torch import launcher
    from my_lidar_graph_slam_tpu_torch.models import loop_closure
    from my_lidar_graph_slam_tpu_torch.models import slam as slam_mod
    from my_lidar_graph_slam_tpu_torch.parallel import distributed, multihost
    from my_lidar_graph_slam_tpu_torch.utils import config, se2
    from my_lidar_graph_slam_tpu_torch.utils.metrics import MetricManager

    latest = int(config.load(SETTINGS).get("Tpu.LatestMapSize", 1024))
    out = os.path.join(workdir, "mesh")
    pass_ms, solve_ms, outside, fanouts = [], [], [], []

    def timed_detect(fn, det, graph, builder, candidates):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = fn(det, graph, builder, candidates)
        pass_ms.append(1e3 * (time.perf_counter() - t0))
        for r in results:
            matched = se2.compound_np(r.start_node_pose, r.relative_pose)
            d = np.abs(matched[:2] - graph.poses[r.end_node_idx][:2])
            outside.append(bool(d[0] > 0.5 * det.range_x + 1e-6 or
                                d[1] > 0.5 * det.range_y + 1e-6))
        return results

    def timed_solve(fn, backend, snapshot):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(backend, snapshot)
        solve_ms.append(1e3 * (time.perf_counter() - t0))
        return res

    def kept_fanout(fn, *args, **kwargs):
        res = fn(*args, **kwargs)
        fanouts.append((args, kwargs, res))
        return res

    spies = [MethodSpy(loop_closure.LoopDetectorBranchBound,
                       "_detect_fanout", timed_detect),
             MethodSpy(slam_mod.Backend, "_optimize", timed_solve),
             MethodSpy(distributed, "branch_bound_fanout", kept_fanout)]
    MetricManager.reset_instance()
    rec = start_recording(latest, "detection-fanout")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        run = launcher.run(os.path.join(workdir, LOG_NAME), SETTINGS, out,
                           threaded_backend=False, max_scans=MESH_SCANS,
                           mesh_devices=1,
                           gt_path=os.path.join(workdir, GT_NAME))
    finally:
        for spy in spies:
            spy.restore()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = stop_recording(rec, "the mesh launcher run")

    suffixes = (".png", ".json", "-latest.png", "-latest.json",
                ".posegraph.json", "-posegraph.png", ".ckpt.npz",
                ".metrics.json")
    missing = [x for x in suffixes if not os.path.exists(out + x)]
    if missing:
        raise AssertionError(f"mesh-run artifacts missing: {missing}")
    counters = json.load(open(out + ".metrics.json"))["Counters"]

    def counter(name):
        return counters.get(name, {}).get("value", 0)

    fan_k2 = {f"M={m} Q={q}": n for (path, m, q), n in rec[1].counts.items()
              if path == "detection-fanout"}
    stats = {
        "scans": run["num_scans"], "nodes": run["num_nodes"],
        "edges": run["num_edges"], "loop_closures": run["num_loop_closures"],
        "loop_edges": run["num_edges"] - (run["num_nodes"] - 1),
        "ate_aligned_m": run["ate_rmse_m"], "seconds": run["elapsed_s"],
        "scans_per_s": run["scans_per_s"], "wall_s": wall,
        "detection_passes": len(pass_ms),
        "detection_pass_ms_median": float(np.median(pass_ms))
        if pass_ms else None,
        "detection_pass_ms_max": float(max(pass_ms)) if pass_ms else None,
        "sharded_solves": len(solve_ms),
        "solve_ms_median": float(np.median(solve_ms)) if solve_ms else None,
        "solve_ms_max": float(max(solve_ms)) if solve_ms else None,
        "frontier_overflow": counter("LoopDetectFrontierOverflow"),
        "padded_rows": counter("LoopDetectMxuPaddedQueries"),
        "real_rows": counter("LoopDetectMxuQueries"),
        "accepted_loop_nodes": len(outside),
        "accepted_outside_window": int(sum(outside)),
        "k2_detection_fanout_launches": fan_k2,
        "launches": launches,
    }
    log("  " + json.dumps(stats))
    if stats["loop_closures"] < 1:
        raise AssertionError("the mesh launcher run closed no loop")
    if stats["sharded_solves"] < 1:
        raise AssertionError("the mesh launcher run made no sharded solve")
    if not np.isfinite(stats["ate_aligned_m"]):
        raise AssertionError("the mesh launcher run's ATE is not finite")
    if not fan_k2:
        raise AssertionError("K2 never launched on the detection-fanout path")
    found = [f for f in fanouts
             if multihost.fetch_global(f[2].pose_found).any()]
    if not found:
        raise AssertionError("no fan-out of the mesh run found a row")
    return stats, rec, found[-1]


def save_mesh_inputs(torch, workdir, slam4, fanout):
    """Phase 4's graph and one fan-out call of (b), padded to an even
    row count, as .npz files for the (c) workers; returns their paths."""
    from my_lidar_graph_slam_tpu_torch.models.slam import _round_multiple

    g = slam4.graph
    snap = g.snapshot(edge_cap=_round_multiple(g.num_edges, 2))
    graph_path = os.path.join(workdir, "mesh_graph.npz")
    np.savez(graph_path, num_nodes=g.num_nodes, **snap._asdict())
    (pyr, grid, *rows), kw, _ = fanout
    rows = [r.cpu().numpy() if hasattr(r, "cpu") else np.asarray(r)
            for r in rows]
    k = rows[0].shape[0]
    arrays, scalars = rows[:8], rows[8:]
    if k % 2:      # one all-invalid row, beam count 1 as the detector pads
        arrays = [np.concatenate([a, np.zeros_like(a[:1])]) for a in arrays]
        arrays[7][-1] = 1.0
    fan_path = os.path.join(workdir, "mesh_fanout.npz")
    np.savez(fan_path, pyramid=pyr.cpu().numpy(),
             log_odds=grid.log_odds.cpu().numpy(),
             observed=grid.observed.cpu().numpy(),
             origin=grid.origin.cpu().numpy(), resolution=grid.resolution,
             rows=np.array(len(arrays)), scalars=np.asarray(scalars, float),
             kwargs=json.dumps({k_: v for k_, v in kw.items()
                                if k_ not in ("mesh", "axis")}),
             **{f"row{i}": a for i, a in enumerate(arrays)})
    return graph_path, fan_path


def load_mesh_inputs(torch, graph_path, fan_path, dev):
    """The inverse of :func:`save_mesh_inputs`: (snapshot, node count,
    fan-out positional arguments, keyword arguments)."""
    from my_lidar_graph_slam_tpu_torch.models.pose_graph import GraphArrays
    from my_lidar_graph_slam_tpu_torch.ops import grid as gridops

    z = np.load(graph_path)
    snap = GraphArrays(*(z[f] for f in GraphArrays._fields))
    f = np.load(fan_path)
    grid = gridops.GridMap(torch.from_numpy(f["log_odds"]).to(dev),
                           torch.from_numpy(f["observed"]).to(dev),
                           torch.from_numpy(f["origin"]).to(dev),
                           float(f["resolution"]))
    rows = [f[f"row{i}"] for i in range(int(f["rows"]))]
    args = [torch.from_numpy(f["pyramid"]).to(dev), grid, *rows,
            *(float(s) for s in f["scalars"])]
    return snap, int(z["num_nodes"]), args, json.loads(str(f["kwargs"]))


def mesh_worker(argv):
    """``chip_smoke.py --mesh-worker MODE RANK WORLD PORT GRAPH FANOUT OUT
    LMCONFIG``: one process of phase 11(c). ``gloo``: rank RANK of WORLD
    on card 0 with one shard, the edge- and node-sharded solves of the
    graph and the fan-out; ``nccl``: world size 1 under NCCL, one
    node-sharded solve. Rank 0 writes the results to OUT."""
    import torch

    from my_lidar_graph_slam_tpu_torch.models.optimizer_host import LMConfig
    from my_lidar_graph_slam_tpu_torch.parallel import distributed, multihost

    mode, rank, world, port, graph_path, fan_path, out, cfg = argv
    rank, world = int(rank), int(world)
    lm_config = LMConfig(**json.loads(cfg))
    multihost.initialize(f"127.0.0.1:{port}", world, rank, device="cuda",
                         backend=mode, timeout_s=MESH_GROUP_TIMEOUT_S)
    mesh = multihost.global_mesh("shard", device="cuda")
    snap, n, fan_args, fan_kw = load_mesh_inputs(torch, graph_path,
                                                 fan_path, mesh.devices[0])
    res = {}
    t0 = time.perf_counter()
    part = distributed.partition_graph_by_nodes(snap, mesh.num_shards)
    res["nodes"] = multihost.fetch_global(distributed.optimize_sharded_nodes(
        part, lm_config, mesh).poses)[:n]
    res["nodes_ms"] = 1e3 * (time.perf_counter() - t0)
    if mode == "gloo":
        t0 = time.perf_counter()
        res["edges"] = multihost.fetch_global(distributed.optimize_sharded(
            snap, lm_config, mesh).poses)[:n]
        res["edges_ms"] = 1e3 * (time.perf_counter() - t0)
        fan = multihost.fetch_global(distributed.branch_bound_fanout(
            *fan_args, mesh=mesh, **fan_kw))
        res.update(fan_found=fan.pose_found, fan_pose=fan.estimated_pose,
                   fan_score=fan.normalized_score)
    res.update(psum_calls=mesh.psum_calls, psum_bytes=mesh.psum_bytes)
    torch.distributed.destroy_process_group()
    if rank == 0:
        np.savez(out, **res)
    print(f"mesh worker {mode} rank {rank}: ok", flush=True)
    return 0


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_mesh_processes(torch, dev, workdir, slam4, fanout):
    """(c) Two processes under gloo, one shard each on card 0, and one
    process of world size 1 under NCCL, all at once, each with a timeout.
    Their results must agree with the same calls over an in-process mesh
    of as many shards: node-sharded poses within 0.02 m in x and y, the
    edge-sharded within 1e-3 (the CPU tests' tolerances), the fan-out's
    found flags equal, poses within 1e-4 and scores rtol 1e-5."""
    from my_lidar_graph_slam_tpu_torch.parallel import distributed, multihost
    from my_lidar_graph_slam_tpu_torch.parallel.mesh import Mesh

    graph_path, fan_path = save_mesh_inputs(torch, workdir, slam4, fanout)
    cfg = json.dumps(vars(slam4.backend.lm_config))
    outs = {m: os.path.join(workdir, f"mesh_{m}.npz")
            for m in ("gloo", "nccl")}
    gloo_port, nccl_port = free_port(), free_port()
    cmds = [["gloo", r, 2, gloo_port] for r in range(2)] + \
        [["nccl", 0, 1, nccl_port]]
    logs = [os.path.join(workdir, f"mesh_worker{i}.log")
            for i in range(len(cmds))]
    t0 = time.perf_counter()
    procs = []
    for c, path in zip(cmds, logs):
        with open(path, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mesh-worker",
                 *map(str, c), graph_path, fan_path, outs[c[0]], cfg],
                cwd=REPO, stdout=f, stderr=subprocess.STDOUT))
    # All end, or one fails or the time runs out and every one is killed.
    deadline = time.monotonic() + MESH_WORKER_TIMEOUT_S
    while any(p.poll() is None for p in procs):
        if time.monotonic() > deadline or \
                any(p.poll() not in (None, 0) for p in procs):
            for p in procs:
                p.kill()
            break
        time.sleep(0.2)
    for p in procs:
        p.wait()
    wall = time.perf_counter() - t0
    for c, p, path in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise AssertionError(f"phase 11(c) process {c[:2]} failed "
                                 f"({p.returncode}):\n"
                                 f"{open(path).read()[-3000:]}")

    snap, n, fan_args, fan_kw = load_mesh_inputs(torch, graph_path,
                                                 fan_path, dev)
    lm_config = slam4.backend.lm_config
    stats = {"processes_wall_s": wall}
    for mode, shards in (("gloo", 2), ("nccl", 1)):
        mesh = Mesh(devices=[dev] * shards)
        got = np.load(outs[mode])
        ref = multihost.fetch_global(distributed.optimize_sharded_nodes(
            distributed.partition_graph_by_nodes(snap, shards), lm_config,
            mesh).poses)[:n]
        errs = {"nodes": float(np.abs(got["nodes"][:, :2] -
                                      ref[:, :2]).max())}
        if mode == "gloo":
            ref_e = multihost.fetch_global(distributed.optimize_sharded(
                snap, lm_config, mesh).poses)[:n]
            errs["edges"] = float(np.abs(got["edges"] - ref_e).max())
            fan = multihost.fetch_global(distributed.branch_bound_fanout(
                *fan_args, mesh=mesh, **fan_kw))
            if not np.array_equal(got["fan_found"], fan.pose_found):
                raise AssertionError("phase 11(c): the gloo fan-out found "
                                     "other rows than the in-process mesh")
            errs["fan_pose"] = float(np.abs(got["fan_pose"] -
                                            fan.estimated_pose).max())
            errs["fan_score_rel"] = float(np.max(
                np.abs(got["fan_score"] - fan.normalized_score) /
                np.maximum(np.abs(fan.normalized_score), 1e-30)))
            stats["fan_rows"] = int(fan.pose_found.size)
            stats["fan_found"] = int(fan.pose_found.sum())
        stats[mode] = {"shards": shards, "max_err": errs,
                       "nodes_ms": float(got["nodes_ms"]),
                       "edges_ms": float(got["edges_ms"])
                       if "edges_ms" in got else None,
                       "psum_calls": int(got["psum_calls"]),
                       "psum_bytes": int(got["psum_bytes"])}
        limits = {"nodes": 0.02, "edges": 1e-3, "fan_pose": 1e-4,
                  "fan_score_rel": 1e-5}
        for key, err in errs.items():
            if not err <= limits[key]:
                raise AssertionError(f"phase 11(c) {mode}: {key} differs "
                                     f"from the in-process mesh by {err}")
    log("  " + json.dumps(stats))
    return stats


# --------------------------------------------------------------------------
# Phase 5: times
# --------------------------------------------------------------------------


def time_ms(torch, fn, iters=20, queued=False):
    """Mean ms of ``fn`` over ``iters`` back-to-back calls, by CUDA events
    (the ``ms`` of the kernels line): a call shorter than its own enqueue
    is timed at the host's rate. With ``queued`` the card first sleeps
    (~3 ms) while the host enqueues every call, so the time is the
    device's alone, without the host's per-call cost."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(5_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


FLUSH_BYTES = 128 << 20        # > the H100's 50 MB L2


def time_cold_ms(torch, fn, iters=10):
    """Mean ms of one call of ``fn`` alone, by CUDA events around it, right
    after writing a 128 MB buffer, so that the call finds the L2 cold."""
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flush.fill_(1.0)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def launch_floor(torch):
    """An empty kernel launched as the port's kernels are (ctypes, the
    current stream): (back-to-back ms, queued ms, cold single-launch
    ms)."""
    import ctypes
    from my_lidar_graph_slam_tpu_torch.ops.cuda import loader

    fn = loader.library("empty").empty_launch
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_void_p]
    anchor = torch.empty(1, device="cuda")

    def launch():
        loader.check(fn(loader.stream_handle(anchor)), "empty")

    return time_ms(torch, launch, iters=200), \
        time_ms(torch, launch, iters=200, queued=True), \
        time_cold_ms(torch, launch)


def k1_library(torch, vm, ix, iy, w, wx, wy, map_idx, max_elems=150e6):
    """K1's function as PyTorch's ``embedding_bag(mode="sum",
    per_sample_weights=...)``: one bag per output (q, t, a, b) of the live
    beams' flat indices into a zero-padded copy of the map (off-map cells
    land in the zero ring), with the beams' weights; the bag length is the
    most live beams of any query, the shorter queries padded with weight-0
    reads of cell 0. Returns (ms, scores): the indices are built outside
    the timed region one theta chunk of at most ``max_elems`` indices at a
    time, and the time is the sum over the chunks of one embedding_bag
    call each (so that no more than one chunk's indices are held)."""
    f = torch.nn.functional
    maps = vm if vm.dim() == 3 else vm[None]
    _, h, wd = maps.shape
    py, px = wy + 1, wx + 1
    padded = f.pad(maps, (px, px, py, py))
    hp, wp = h + 2 * py, wd + 2 * px
    table = padded.reshape(-1, 1)
    q, nt, nb = ix.shape
    live = w != 0
    n_live = int(live.sum(1).max())
    # Live beams first, in beam order, then padding.
    order = torch.sort((~live).to(torch.int8), dim=1, stable=True).indices
    sel = order[:, :n_live]                                     # [Q, L]
    wsel = torch.gather(w, 1, sel)                              # 0 on padding
    base = torch.zeros(q, dtype=torch.int64, device=ix.device)
    if map_idx is not None:
        base = map_idx.long() * (hp * wp)
    wxn, wyn = 2 * wx + 1, 2 * wy + 1
    dx = torch.arange(-wx, wx + 1, device=ix.device)
    dy = torch.arange(-wy, wy + 1, device=ix.device)
    per_theta = q * wxn * wyn * max(n_live, 1)
    step = max(1, int(max_elems // per_theta))
    total_ms, outs = 0.0, []
    for t0 in range(0, nt, step):
        t1 = min(nt, t0 + step)
        idx_sel = sel[:, None, :].expand(q, t1 - t0, n_live)
        gx = torch.gather(ix[:, t0:t1].long(), 2, idx_sel)      # [Q,T,L]
        gy = torch.gather(iy[:, t0:t1].long(), 2, idx_sel)
        gx = (gx[:, :, None, None, :] + dx[:, None, None] + px).clamp(
            0, wp - 1)
        gy = (gy[:, :, None, None, :] + dy[None, :, None] + py).clamp(
            0, hp - 1)
        flat = base[:, None, None, None, None] + gy * wp + gx  # [Q,T,X,Y,L]
        del gx, gy
        flat = torch.where(wsel[:, None, None, None, :] != 0, flat,
                           torch.zeros_like(flat)).reshape(-1, n_live)
        flat = flat.contiguous()
        psw = wsel[:, None, None, None, :].expand(
            q, t1 - t0, wxn, wyn, n_live).reshape(-1, n_live).contiguous()

        def run():
            return f.embedding_bag(flat, table, mode="sum",
                                   per_sample_weights=psw)

        outs.append(run().reshape(q, t1 - t0, wxn, wyn))
        total_ms += time_ms(torch, run, iters=3)
        del flat, psw
    return total_ms, torch.cat(outs, dim=1)


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


def share(bound, ms):
    return bound / ms if ms > 0 else None


def recorded_calls(sources, index):
    """(phase, path, M, Q, args, kwargs, launches) of kernel ``index`` (0:
    K1, 1: K2) for every (path, M, Q) key that a run of ``sources``, a list
    of (phase, recorders), recorded. The inputs are those of the last call
    at that key in the first phase that recorded it; ``launches`` maps
    each phase to its calls at that key."""
    keys = sorted({key for _, rec in sources for key in rec[index].calls})
    for key in keys:
        by_phase = [(phase, rec[index]) for phase, rec in sources
                    if key in rec[index].calls]
        phase, r = by_phase[0]
        args, kw = r.calls[key]
        yield (phase, *key, args, kw,
               {p: x.counts[key] for p, x in by_phase})


def phase_times(torch, sources, slam, errs):
    """Per main-path shape of each kernel, on the inputs of the last call
    at that shape in the run that recorded it (``sources``, see
    :func:`recorded_calls`): the kernel against its plain version (held to
    phase 3's tolerances; K2 bit-equal) and against its own relaunch
    (bit-equal); its time back to back, queued, and alone with a cold L2;
    the plain version's time; K1's library yardstick; the bound and its
    share; and the floor of an empty launch."""
    from my_lidar_graph_slam_tpu_torch.ops.cuda import correlate, greedy_cost

    floor_ms, floor_queued_ms, floor_cold_ms = launch_floor(torch)
    log(f"  launch floor (empty kernel, ctypes, current stream): "
        f"{floor_ms:.5f} ms back to back, {floor_queued_ms:.5f} ms queued, "
        f"{floor_cold_ms:.5f} ms alone")
    common = {"launch_floor_ms": floor_ms,
              "launch_floor_queued_ms": floor_queued_ms,
              "launch_floor_cold_ms": floor_cold_ms}
    rows = []
    for phase, path, m, q, args, kw, launches in recorded_calls(sources, 0):
        vm, ix, iy, w, wx, wy, *rest = args
        map_idx = rest[0] if rest else kw.get("map_idx")

        def kernel():
            return correlate.window_scores(vm, ix, iy, w, wx, wy, map_idx)

        shape_name = f"{path} Q={q}" if m == 1 else f"{path} M={m} Q={q}"
        name = f"{shape_name} ({phase} inputs)"
        out, again = kernel(), kernel()
        ref = correlate.window_scores_plain(vm, ix, iy, w, wx, wy, map_idx)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError(f"K1 {name}: two launches differ")
        err = check_k1(name, out, ref, torch)
        lib_ms, lib_out = k1_library(torch, vm, ix, iy, w, wx, wy, map_idx)
        check_k1(name + " library yardstick", lib_out, ref, torch)
        del lib_out
        _, nt, nb = ix.shape
        live = (w != 0)[:, None, :].expand_as(ix)
        n_live = int(live.sum())                # live (q, theta, beam)
        cells = (2 * wx + 1) * (2 * wy + 1)
        ops = 2.0 * n_live * cells              # one multiply-add each
        read = cells_read(torch, vm, map_idx, [(ix, iy, live, wx, wy)])
        moved = 4 * read + 8 * n_live + nbytes(w, map_idx, out)
        b, by = bound_ms(moved, ops)
        ms, ms_queued = time_ms(torch, kernel), time_ms(torch, kernel,
                                                        queued=True)
        g = correlate.launch_geometry(nb, wx, wy)
        rows.append({
            "name": f"window_scores[{shape_name}]", "route": "cuda",
            "source": "my_lidar_graph_slam_tpu_torch/csrc/correlate.cu",
            "replaces": "my_lidar_graph_slam_tpu/ops/pallas/"
                        "correlate_mxu.py:191",
            "launches": sum(launches.values()),
            "launches_by_phase": launches, "phase": phase,
            "max_abs_err": err,
            "edge_cases_max_abs_err": errs["window_scores"],
            "bit_equal_on_relaunch": True,
            "ms": ms, "ms_queued": ms_queued,
            "cold_ms": time_cold_ms(torch, kernel),
            "plain_ms": time_ms(torch, lambda: correlate.window_scores_plain(
                vm, ix, iy, w, wx, wy, map_idx), iters=3),
            "bound_ms": b, "bound_by": by, "bound_share": share(b, ms),
            "bound_share_queued": share(b, ms_queued),
            "library_ms": lib_ms,
            "library": "torch.nn.functional.embedding_bag(mode='sum', "
                       "per_sample_weights) over a zero-padded map",
            **common,
            "shape": {"M": m, "Q": q, "NT": nt, "NB": nb,
                      "live_beams": n_live,
                      "window": [2 * wx + 1, 2 * wy + 1],
                      "map": list(vm.shape[-2:]), "map_cells_read": read,
                      "geometry": g._asdict()}})

    # The robust settings share the default's cost groups, so the slice's
    # greedy parameters serve phase 6's rows as well.
    res = slam.builder.config.resolution
    for phase, path, m, q, args, kw, launches in recorded_calls(sources, 1):
        vm, cells, mask, table, k, thr, *rest = args
        map_idx = rest[0] if rest else kw.get("map_idx")
        gp = dict(slam.frontend.matcher.greedy_params
                  if path.startswith("frontend")
                  else slam.backend.detector.greedy_params)
        scaling = gp.get("scaling_factor", 0.05)

        def kernel():
            return greedy_cost.greedy_cost_core(vm, cells, mask, table, k,
                                                thr, map_idx)

        shape_name = f"{path} Q={q}" if m == 1 else f"{path} M={m} Q={q}"
        name = f"{shape_name} ({phase} inputs)"
        raw, again = kernel(), kernel()
        raw_ref = greedy_cost.greedy_cost_core_plain(vm, cells, mask, table,
                                                     k, thr, map_idx)
        torch.cuda.synchronize()
        if not (torch.equal(raw, raw_ref) and torch.equal(raw, again)):
            raise AssertionError(f"K2 {name}: not bit-equal to the plain "
                                 "core or to its own relaunch")
        err = check_k2(name, greedy_cost._epilogue(raw, res, scaling),
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
        ms, ms_queued = time_ms(torch, kernel), time_ms(torch, kernel,
                                                        queued=True)
        rows.append({
            "name": f"greedy_cost[{shape_name}]", "route": "cuda",
            "source": "my_lidar_graph_slam_tpu_torch/csrc/greedy_cost.cu",
            "replaces": "my_lidar_graph_slam_tpu/ops/pallas/"
                        "greedy_cost_mxu.py:233",
            "launches": sum(launches.values()),
            "launches_by_phase": launches, "phase": phase,
            "max_abs_err": err,
            "edge_cases_max_abs_err": errs["greedy_cost"],
            "bit_equal_to_plain": True, "bit_equal_on_relaunch": True,
            "ms": ms, "ms_queued": ms_queued,
            "cold_ms": time_cold_ms(torch, kernel),
            "plain_ms": time_ms(torch, lambda:
                                greedy_cost.greedy_cost_core_plain(
                                    vm, cells, mask, table, k, thr,
                                    map_idx), iters=5),
            "bound_ms": b, "bound_by": by, "bound_share": share(b, ms),
            "bound_share_queued": share(b, ms_queued),
            "library_ms": None,
            "library": "none: a minimum over each beam's usable cells, then "
                       "a histogram of the minima per pose, is no single "
                       "PyTorch call",
            **common,
            "shape": {"M": m, "Q": q, "NB": nb, "masked_beams": n_masked,
                      "kernel_size": k, "map": list(vm.shape[-2:]),
                      "map_cells_read": read}})
    return rows + k3_rows(torch, sources, common)


def cast_cells(torch, a):
    """(distinct cells, walk slots): what the cast with arguments ``a``
    touches, from the plain walk (``trace_cells_batched``), scan by
    scan."""
    from my_lidar_graph_slam_tpu_torch.ops import raycast
    from my_lidar_graph_slam_tpu_torch.utils import se2

    m, h, w = a["log_odds"].shape
    dev = a["log_odds"].device
    touched = torch.zeros(m * h * w, dtype=torch.bool, device=dev)
    offset = (torch.arange(m, device=dev) * (h * w))[:, None]
    sensor = se2.compound(a["node_poses"], a["rel_sensor_poses"])
    slots = 0
    for j in range(sensor.shape[1]):
        valid = a["scan_valid"][:, j]
        if a["scan_active"] is not None:
            valid = valid & a["scan_active"][:, j, None]
        mf, mo, hf, ho = raycast.trace_cells_batched(
            (h, w), a["origins"], a["resolution"], sensor[:, j],
            a["scan_ranges"][:, j], a["scan_angles"][:, j], valid,
            a["usable_range_min"][:, j], a["usable_range_max"][:, j],
            a["max_steps"])
        touched[(mf + offset)[mo]] = True
        touched[(hf + offset)[ho]] = True
        slots += int(mo.sum()) + int(ho.sum())
    return int(touched.sum()), slots


def k3_rows(torch, sources, common):
    """K3 per path of the cast (see :class:`CastRecorder`), on the copied
    arguments of the widest call at that path in the first phase that
    recorded it: the cast on the card against the plain cast (``observed``
    equal, log-odds within ``raycast.kernel_tolerance``) and against its
    own relaunch (bit-equal); then the kernel alone (``ops/cuda/raycast.
    integrate``, in place on a copy of the maps: the cells it walks do not
    depend on their values) back to back, queued and with a cold L2; the
    plain cast's time; and the bound: 9 bytes (log-odds read and written,
    ``observed`` written) for each distinct cell the call touches plus its
    scan inputs once, or 6 operations a walk slot and phase."""
    from my_lidar_graph_slam_tpu_torch.ops import grid as gridops
    from my_lidar_graph_slam_tpu_torch.ops import raycast
    from my_lidar_graph_slam_tpu_torch.ops.cuda import raycast as k3
    from my_lidar_graph_slam_tpu_torch.utils import se2

    rows = []
    for path in ("local", "latest", "rebuild", "scans"):
        by_phase = [(phase, rec[2]) for phase, rec in sources
                    if path in rec[2].calls]
        if not by_phase:
            continue
        phase, r = by_phase[0]
        a = r.calls[path]
        m, h, w = a["log_odds"].shape
        _, k, nb = a["scan_ranges"].shape
        shape_name = f"{path} M={m} K={k} {h}x{w}"
        name = f"{shape_name} ({phase} inputs)"
        out, again = raycast.integrate_scans_stacked(**a), \
            raycast.integrate_scans_stacked(**a)
        ref = raycast.integrate_scans_stacked_plain(**a)
        torch.cuda.synchronize()
        if not (torch.equal(out[0], again[0]) and
                torch.equal(out[1], again[1])):
            raise AssertionError(f"K3 {name}: two launches differ")
        if not torch.equal(out[1], ref[1]):
            raise AssertionError(f"K3 {name}: observed differs from the "
                                 "plain cast")
        tol = raycast.kernel_tolerance(**a)
        err = float((out[0] - ref[0]).abs().max())
        if not err <= tol:
            raise AssertionError(f"K3 {name}: log-odds {err} from the "
                                 f"plain cast, beyond {tol}")
        del out, again, ref
        touched, slots = cast_cells(torch, a)
        dev = a["log_odds"].device
        sensor = se2.compound(a["node_poses"],
                              a["rel_sensor_poses"]).contiguous()
        scan = [None if a[n] is None else a[n].contiguous() for n in (
            "origins", "scan_ranges", "scan_angles", "scan_valid",
            "scan_active", "usable_range_min", "usable_range_max")]
        kin = (a["log_odds"].clone(memory_format=torch.contiguous_format),
               a["observed"].clone(memory_format=torch.contiguous_format),
               scan[0], sensor, *scan[1:],
               gridops.logit(gridops.scalar(a["prob_miss"], dev)),
               gridops.logit(gridops.scalar(a["prob_hit"], dev)),
               float(a["resolution"]), a["max_steps"], gridops.LOG_ODDS_MAX)

        def kernel():
            k3.integrate(*kin)

        moved = 9 * touched + nbytes(*kin[2:10])
        b, by = bound_ms(moved, 12.0 * slots)
        ms, ms_queued = time_ms(torch, kernel), time_ms(torch, kernel,
                                                        queued=True)
        rows.append({
            "name": f"raycast[{shape_name}]", "route": "cuda",
            "source": "my_lidar_graph_slam_tpu_torch/csrc/raycast.cu",
            "replaces": "XLA's scatter-add in my_lidar_graph_slam_tpu/ops/"
                        "raycast.py (no Pallas kernel)",
            "launches": sum(x.counts[path] for _, x in by_phase),
            "launches_by_phase": {p: x.counts[path] for p, x in by_phase},
            "phase": phase, "max_abs_err": err, "tolerance": tol,
            "observed_equal_to_plain": True, "bit_equal_on_relaunch": True,
            "ms": ms, "ms_queued": ms_queued,
            "cold_ms": time_cold_ms(torch, kernel),
            "plain_ms": time_ms(torch, lambda:
                                raycast.integrate_scans_stacked_plain(**a),
                                iters=3),
            "bound_ms": b, "bound_by": by, "bound_share": share(b, ms),
            "bound_share_queued": share(b, ms_queued),
            "library_ms": None,
            "library": "none: the plain cast (plain_ms) is PyTorch's "
                       "index_put_(accumulate=True) scatter",
            **common,
            "shape": {"M": m, "K": k, "NB": nb, "map": [h, w],
                      "max_steps": a["max_steps"],
                      "cells_touched": touched, "walk_slots": slots}})
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
    log(f"[1/11] device: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {kind}")

    t0 = time.perf_counter()
    loader.build_all()
    log(f"[2/11] build: {time.perf_counter() - t0:.2f} s")
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
        log(f"[3/11] kernels vs plain: ok in {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        stats, rec, slam, records, truth = phase_slice(torch, dev, workdir)
        log(f"[4/11] slice: ok in {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        launcher_stats, rec6 = phase_launcher(torch, workdir)
        log(f"[6/11] launcher, robust settings, replay: ok in "
            f"{time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        async_stats, rec7 = phase_async(torch, dev, records)
        log(f"[7/11] async against blocking: ok in "
            f"{time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        bb_stats, rec8 = phase_bb_frontend(torch, dev, workdir)
        log(f"[8/11] bb_frontend settings, online: ok in "
            f"{time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        solver_stats, rec9 = phase_solver(torch, dev, slam, records, *truth)
        log(f"[9/11] device pose-graph solver: ok in "
            f"{time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        rtc_stats, rec10 = phase_correlative(torch, dev, workdir)
        log(f"[10a/11] correlative loop detector, launcher: ok in "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        pruned_stats, rec10b = phase_pruned(torch, dev, records)
        log(f"[10b/11] pruned frontend against the sweep: ok in "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        reader_stats = phase_native_reader(workdir)
        log(f"[10c/11] native CARMEN reader: ok in "
            f"{time.perf_counter() - t0:.1f} s")

        t11 = t0 = time.perf_counter()
        mesh_solver_rows = phase_mesh_solvers(torch, dev, slam)
        log(f"[11a/11] sharded solvers over {MESH_SHARDS} shards of the "
            f"card: ok in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        mesh_stats, rec11, fanout = phase_mesh_launcher(torch, workdir)
        log(f"[11b/11] launcher with a mesh: ok in "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        process_stats = phase_mesh_processes(torch, dev, workdir, slam,
                                             fanout)
        log(f"[11c/11] gloo and NCCL processes: ok in "
            f"{time.perf_counter() - t0:.1f} s (phase 11: "
            f"{time.perf_counter() - t11:.1f} s)")

    t0 = time.perf_counter()
    sources = [("slice", rec), ("launcher", rec6), ("async", rec7),
               ("bb_frontend", rec8), ("device_solver", rec9),
               ("correlative", rec10), ("pruned", rec10b), ("mesh", rec11)]
    rows = phase_times(torch, sources, slam, errs)
    for r in rows:
        lib = "n/a" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms"
        log(f"  {r['name']}: {r['ms']:.5f} ms back to back, "
            f"{r['ms_queued']:.5f} ms queued, "
            f"{r['cold_ms']:.5f} ms cold L2 (plain {r['plain_ms']:.3f} ms, "
            f"library {lib}, bound {r['bound_ms']:.5f} ms by "
            f"{r['bound_by']} = {r['bound_share']:.3f} of the time back to "
            f"back, {r['bound_share_queued']:.3f} queued, "
            f"launch floor {r['launch_floor_ms']:.5f} ms back to back, "
            f"{r['launch_floor_queued_ms']:.5f} ms queued), "
            f"{r['launches']} launches {json.dumps(r['launches_by_phase'])}"
            f", inputs of the {r['phase']} run, max|err| vs plain "
            f"{r['max_abs_err']:.3g} {json.dumps(r['shape'])}")
    log(f"[5/11] times: ok in {time.perf_counter() - t0:.1f} s")

    print(json.dumps({"kernels": rows, "slice": stats,
                      "launcher": launcher_stats, "async": async_stats,
                      "bb_frontend": bb_stats, "solver": solver_stats,
                      "correlative": rtc_stats, "pruned": pruned_stats,
                      "native_reader": reader_stats,
                      "mesh": {"solvers": mesh_solver_rows,
                               "launcher": mesh_stats,
                               "processes": process_stats}}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-worker"]:
        sys.path.insert(0, REPO)
        sys.exit(mesh_worker(sys.argv[2:]))
    sys.exit(main())
