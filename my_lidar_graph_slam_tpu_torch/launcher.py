"""SLAM launcher CLI of the PyTorch/CUDA port.

Counterpart of ``my_lidar_graph_slam_tpu/launcher.py`` (the reference's
``slam_launch``, slam_launcher.cpp:927-1026)::

    python -m my_lidar_graph_slam_tpu_torch.launcher LOG SETTINGS [OUT]

loads a CARMEN log, builds the SLAM object graph from the JSON settings
(the reference's settings files work verbatim), runs every scan through
the pipeline — online, pipelined (``--stream-async``) or chunked replay
(``--replay-chunk K``) — and writes the JAX launcher's artifacts under the
same names: the global map and the latest map (PNG + JSON), the pose-graph
JSON and PNG, the metrics JSON and a state checkpoint. It takes every flag
of the JAX launcher and prints the same stats line on stderr.

The maps live on the CUDA card unless ``--platform cpu`` is given. Every
CUDA kernel is built before the timed loop, so ``nvcc`` never lands in
``elapsed_s``. ``--profile DIR`` writes a ``torch.profiler`` trace of the
scan loop, with the program's spans in it as ``record_function`` ranges
and in the metrics JSON's ``Spans`` (``utils/metrics.py``). ``--mesh-devices N`` runs the backend over a mesh of N shards
in this process (the first N cards, or N CPU shards under ``--platform
cpu``); ``--multihost`` joins a ``torch.distributed`` process group from
``torchrun``'s variables (NCCL with one card per process, gloo under
``--platform cpu``) and spans the mesh over every process, each running
the whole launcher on the same log. With a mesh the backend solves every
graph with the node-sharded LM and the BranchBound detector runs
branch-and-bound fanned out over the shards (``parallel/``).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from my_lidar_graph_slam_tpu_torch.io import carmen, map_io, viz
from my_lidar_graph_slam_tpu_torch.models.loop_closure import LoopCandidate
from my_lidar_graph_slam_tpu_torch.models.replay import ReplayRunner
from my_lidar_graph_slam_tpu_torch.sensor.data import OdometryData, RawScan
from my_lidar_graph_slam_tpu_torch.utils import ate
from my_lidar_graph_slam_tpu_torch.utils import config as config_mod
from my_lidar_graph_slam_tpu_torch.utils import device as device_mod
from my_lidar_graph_slam_tpu_torch.utils.metrics import MetricManager


def resolve_platform(platform: str) -> torch.device:
    """``--platform``: empty, ``gpu`` or ``cuda`` mean the card, ``cpu``
    the plain PyTorch versions on the CPU."""
    if platform in ("", "gpu", "cuda"):
        return device_mod.resolve(None)
    if platform == "cpu":
        return device_mod.resolve("cpu")
    raise ValueError(f"unknown platform {platform!r} (use cpu or gpu)")


def build_kernels(device: torch.device) -> None:
    """Build and load every CUDA kernel (one ``nvcc`` per source, in
    parallel) before anything is timed."""
    if device.type != "cuda":
        return
    from my_lidar_graph_slam_tpu_torch.ops.cuda import loader
    loader.build_all()
    for name in loader.SOURCES:
        loader.library(name)


def _warm_backend(warm_obj):
    """Drive the detector at the production candidate widths (3 and 5
    nodes), the stacked multi-map path when the config
    searches several maps, and a full rebuild of every local map, on a
    throwaway pipeline (``_warm_backend_programs`` of the JAX launcher).
    Results are discarded."""
    b = warm_obj.builder
    g = warm_obj.graph
    if not b.local_maps or g.num_nodes < 2:
        return
    lm = b.local_maps[0]
    was_finished = lm.finished
    lm.finished = True
    n = g.num_nodes
    for width in (3, 5):
        nodes = list(range(max(0, n - width), n))
        cand = [LoopCandidate(node_indices=nodes, local_map_idx=0,
                              local_map_node_idx=nodes[0])]
        warm_obj.backend.detector.detect(g, b, cand)
    kmaps = getattr(warm_obj.backend.searcher, "num_candidate_maps", 1)
    if kmaps > 1:
        nodes = list(range(max(0, n - 5), n))
        for count in {2, min(kmaps, 3)}:
            cands = [LoopCandidate(node_indices=nodes, local_map_idx=0,
                                   local_map_node_idx=nodes[0])] * count
            warm_obj.backend.detector.detect(g, b, cands)
    lm.finished = was_finished
    for lmm in b.local_maps:
        lmm.built_poses = None  # force the full rebuild
    b.after_loop_closure(g)


def _attach_odometry(records):
    """Stamp pose-less RAWLASER scans with the most recent ODOM pose (an
    extension: the reference leaves them zero, carmen_reader.cpp:163-236
    and slam_launcher.cpp:966-976)."""
    last_odom = None
    for r in records:
        if isinstance(r, OdometryData):
            last_odom = r
        elif isinstance(r, RawScan) and last_odom is not None and \
                not np.any(r.odom_pose):
            r.odom_pose = last_odom.pose.copy()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(log_path: str, settings_path: str, output: str,
        threaded_backend: bool = True,
        max_scans: int = 0,
        gui_interval: int = 0,
        gt_path: str = "",
        save_local_maps: bool = False,
        save_pyramid_maps: bool = False,
        multihost: bool = False,
        mesh_devices: int = 0,
        profile_dir: str = "",
        platform: str = "",
        replay_chunk: int = 0,
        attach_odom: bool = False,
        warmup: int = 0,
        stream_async: bool = False) -> dict:
    """Run the full pipeline; returns the stats dictionary of the JAX
    launcher (``num_scans``, ``num_nodes``, ``num_edges``,
    ``num_loop_closures``, ``elapsed_s``, ``scans_per_s`` and, with
    ``gt_path``, ``ate_rmse_m``).

    ``multihost`` joins the process group (``parallel/multihost.py``,
    coordinator and ranks from torchrun's variables) and spans the mesh
    over every process's device; the backend then runs synchronously,
    since every rank must reach the backend's collectives in the same
    order, which a worker thread's timing does not promise. The group is
    left at the end. ``mesh_devices`` > 0 builds a one-process mesh over
    N local shards instead."""
    device = resolve_platform(platform)
    opts = dict(max_scans=max_scans, gui_interval=gui_interval,
                gt_path=gt_path, save_local_maps=save_local_maps,
                save_pyramid_maps=save_pyramid_maps, profile_dir=profile_dir,
                replay_chunk=replay_chunk, attach_odom=attach_odom,
                warmup=warmup, stream_async=stream_async)
    if not multihost:
        mesh = None
        if mesh_devices:
            from my_lidar_graph_slam_tpu_torch.parallel import mesh as mesh_mod
            mesh = mesh_mod.make_mesh(mesh_devices, axis="shard",
                                      device=device)
        return _run(log_path, settings_path, output, device, mesh,
                    threaded_backend, **opts)
    import torch.distributed as dist

    from my_lidar_graph_slam_tpu_torch.parallel import multihost as mh
    mh.initialize(device=device)
    try:
        return _run(log_path, settings_path, output, device,
                    mh.global_mesh("shard", device=device), False, **opts)
    finally:
        dist.destroy_process_group()


def _run(log_path, settings_path, output, device, mesh, threaded_backend, *,
         max_scans, gui_interval, gt_path, save_local_maps,
         save_pyramid_maps, profile_dir, replay_chunk, attach_odom, warmup,
         stream_async) -> dict:
    """The pipeline of :func:`run` on ``device``, with the backend over
    ``mesh`` when it is not None."""
    metrics = MetricManager.instance()
    cfg = config_mod.load(settings_path)
    if replay_chunk:
        # Replay is a synchronous batch pipeline: backend passes coalesce
        # to chunk boundaries (models/replay.py).
        threaded_backend = False
    slam_obj = config_mod.create_slam(cfg, device=device,
                                      threaded_backend=threaded_backend,
                                      mesh=mesh)
    if stream_async:
        slam_obj.frontend.async_pipeline = True

    records = carmen.load(log_path)
    if attach_odom:
        _attach_odometry(records)
    scan_records = [r for r in records if isinstance(r, RawScan)]
    if max_scans:
        scan_records = scan_records[:max_scans]
    if not scan_records:
        print(f"no scan records in {log_path}", file=sys.stderr)
        return {}

    build_kernels(device)

    if warmup:
        # Drive the first N scans through a THROWAWAY pipeline, so that
        # one-off costs (allocator growth, library initialisation) land
        # before the timed run.
        print(f"[launcher] warmup over first {warmup} scans...",
              file=sys.stderr)
        t0 = time.time()
        warm_obj = config_mod.create_slam(cfg, device=device,
                                          threaded_backend=False, mesh=mesh)
        warm_scans = scan_records[:warmup]
        if replay_chunk:
            ReplayRunner(warm_obj, chunk=replay_chunk).run(warm_scans)
        else:
            for scan in warm_scans:
                warm_obj.process_scan(scan, scan.odom_pose)
            warm_obj.frontend.flush(warm_obj)
        if warm_obj.backend is not None:
            warm_obj.backend.run_once(warm_obj)
            _warm_backend(warm_obj)
        del warm_obj
        _sync(device)
        MetricManager.reset_instance()
        metrics = MetricManager.instance()
        print(f"[launcher] warmup done in {time.time() - t0:.1f}s",
              file=sys.stderr)

    profiler = None
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.__enter__()

    slam_obj.start_backend()
    _sync(device)
    t0 = time.time()
    if replay_chunk:
        runner = ReplayRunner(slam_obj, chunk=replay_chunk)

        def progress(count):
            if gui_interval and count % gui_interval < replay_chunk:
                viz.draw_pose_graph(slam_obj.graph, output + ".live.png")

        runner.run(scan_records, progress_cb=progress)
        metrics.counters("ProcessedScans").increment(len(scan_records))
    else:
        for scan in scan_records:
            t1 = time.time()
            updated = slam_obj.process_scan(scan, scan.odom_pose)
            if updated:
                metrics.distributions("FrontendScanTime").observe(
                    time.time() - t1)
                if gui_interval and \
                        slam_obj.process_count % gui_interval == 0:
                    viz.draw_pose_graph(slam_obj.graph, output + ".live.png")
            metrics.counters("ProcessedScans").increment()
    _sync(device)
    elapsed = time.time() - t0
    slam_obj.stop_backend()
    if profiler is not None:
        profiler.__exit__(None, None, None)
        profiler.export_chrome_trace(os.path.join(profile_dir,
                                                  "trace.json"))
        print(f"profiler trace written to {profile_dir}", file=sys.stderr)

    # Save artifacts (slam_launcher.cpp:995-1020).
    graph = slam_obj.graph
    builder = slam_obj.builder
    poses = graph.node_poses()

    global_map = builder.construct_global_map(graph)
    map_io.save_map(global_map, output, node_poses=poses,
                    node_idx_min=0, node_idx_max=graph.num_nodes - 1)
    if builder.latest_map is not None:
        # The reference draws the scans into the latest map
        # (slam_launcher.cpp:1018, drawScans=true).
        pts, origins = map_io.scan_endpoints(
            graph, slam_obj.scans, builder.latest_scan_idx_min,
            builder.latest_scan_idx_max)
        map_io.save_map(builder.latest_map, output + "-latest",
                        node_poses=poses,
                        node_idx_min=builder.latest_scan_idx_min,
                        node_idx_max=builder.latest_scan_idx_max,
                        scan_points=pts, scan_poses=origins)
    if save_local_maps:
        map_io.save_local_maps(builder, graph, output)
    if save_pyramid_maps and builder.local_maps:
        map_io.save_pyramid_maps(builder, builder.local_maps[0], output)
    map_io.save_pose_graph(graph, slam_obj.scans, output)
    viz.draw_pose_graph(graph, output + "-posegraph.png")
    map_io.save_checkpoint(output + ".ckpt.npz", graph, slam_obj.scans)

    closures = slam_obj.backend.num_loop_closures if slam_obj.backend else 0
    metrics.gauges("TotalElapsedSeconds").set(elapsed)
    metrics.gauges("NumPoseGraphNodes").set(graph.num_nodes)
    metrics.gauges("NumPoseGraphEdges").set(graph.num_edges)
    metrics.gauges("NumLoopClosures").set(closures)
    metrics.save_json(output + ".metrics.json")

    stats = {
        "num_scans": len(scan_records),
        "num_nodes": graph.num_nodes,
        "num_edges": graph.num_edges,
        "num_loop_closures": closures,
        "elapsed_s": elapsed,
        "scans_per_s": len(scan_records) / elapsed if elapsed > 0 else 0.0,
    }
    if gt_path:
        gt = np.load(gt_path)
        node_times = slam_obj.scans.timestamps[
            graph.scan_ids[:graph.num_nodes]]
        stats["ate_rmse_m"] = ate.ate_rmse(
            poses, gt["true_poses"], est_times=node_times,
            gt_times=gt["timestamps"])
        metrics.gauges("AteRmseMeters").set(stats["ate_rmse_m"])
    print(f"processed {stats['num_scans']} scans "
          f"({stats['num_nodes']} nodes, {stats['num_edges']} edges, "
          f"{stats['num_loop_closures']} loop closures) "
          f"in {elapsed:.1f}s = {stats['scans_per_s']:.1f} scans/s"
          + (f", ATE RMSE {stats['ate_rmse_m']:.3f} m"
             if "ate_rmse_m" in stats else ""),
          file=sys.stderr)
    return stats


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="LiDAR graph SLAM launcher (PyTorch/CUDA port)")
    parser.add_argument("log", help="CARMEN log file")
    parser.add_argument("settings", help="JSON settings file")
    parser.add_argument("output", nargs="?", default=None,
                        help="output name (default: log stem)")
    parser.add_argument("--max-scans", type=int, default=0)
    parser.add_argument("--no-backend-thread", action="store_true")
    parser.add_argument("--gui-interval", type=int, default=0,
                        help="rewrite a live pose-graph PNG every N frames")
    parser.add_argument("--gt", default="",
                        help="ground-truth npz (true_poses, timestamps) "
                             "for ATE RMSE")
    parser.add_argument("--save-local-maps", action="store_true",
                        help="dump one PNG+JSON per local map")
    parser.add_argument("--save-pyramid-maps", action="store_true",
                        help="dump the first local map's coarse pyramid")
    parser.add_argument("--multihost", action="store_true",
                        help="initialize torch.distributed and span the "
                             "backend mesh across all processes")
    parser.add_argument("--mesh-devices", type=int, default=0,
                        help="single-process mesh over N local devices")
    parser.add_argument("--profile", default="",
                        help="write a torch.profiler trace of the scan "
                             "loop to this directory")
    parser.add_argument("--platform", default="",
                        help="cpu for the plain versions on the CPU; "
                             "default: the CUDA card")
    parser.add_argument("--replay-chunk", type=int, default=0,
                        help="chunked replay: run K keyframes' match chain "
                             "on the device at a time (backend passes "
                             "coalesce to chunk boundaries)")
    parser.add_argument("--attach-odom", action="store_true",
                        help="stamp pose-less RAWLASER scans with the "
                             "most recent ODOM pose (extension; the "
                             "reference leaves them zero)")
    parser.add_argument("--warmup", type=int, default=0,
                        help="pre-drive the first N scans through a "
                             "throwaway pipeline before the timed run")
    parser.add_argument("--stream-async", action="store_true",
                        help="pipelined online frontend: resolve each "
                             "keyframe's match at the next keyframe")
    args = parser.parse_args(argv)

    output = args.output or os.path.splitext(os.path.basename(args.log))[0]
    run(args.log, args.settings, output,
        threaded_backend=not args.no_backend_thread,
        max_scans=args.max_scans,
        gui_interval=args.gui_interval,
        gt_path=args.gt,
        save_local_maps=args.save_local_maps,
        save_pyramid_maps=args.save_pyramid_maps,
        multihost=args.multihost,
        mesh_devices=args.mesh_devices,
        profile_dir=args.profile,
        platform=args.platform,
        replay_chunk=args.replay_chunk,
        attach_odom=args.attach_odom,
        warmup=args.warmup,
        stream_async=args.stream_async)


if __name__ == "__main__":
    main()
