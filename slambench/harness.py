"""The benchmark's core: one run of one cell.

A run makes its log from the seed (``traffic.py``), builds the SLAM
through the launcher's normal path, sets up as the cell's workload file
says (a prefix of the log through the same SLAM, or a throwaway warm-up
pipeline), then hands the log's scans to ``process_scan`` one after the
other, each as soon as the last returns (a closed loop), for
``--seconds``. The window ends with ``torch.cuda.synchronize()``. With
``--trace 1`` the same window runs under ``torch.profiler``. After the
window the backend is stopped, the check (``check.py``) compares the
window's answers with the reference, and one JSON line is printed.

Everything that belongs to a cell, a configuration or a metric is a file
of its own that this module finds by name: ``workloads/<cell>.json``,
``configs/<config>.json`` (with the settings file it names) and
``metrics/<metric>.py``; ``BENCHMARK.json`` says which metrics a cell
reports.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import tempfile
import threading
import time
import traceback

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# Top-level modules that no run may load (compared whole, the part of a
# module's name before the first dot).
FORBIDDEN = ("jax", "jaxlib", "flax", "my_lidar_graph_slam_tpu")


def forbidden_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)} &
                  set(FORBIDDEN))


def _load_json(path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """A cell's workload file, its configuration and the metrics it
    reports, found by name under ``bench_dir``."""

    def __init__(self, name: str, root: str = ROOT,
                 bench_dir: str = BENCH_DIR):
        self.name = name
        self.bench_dir = bench_dir
        self.workload = _load_json(os.path.join(bench_dir, "workloads",
                                                name + ".json"))
        cfg_dir = os.path.join(bench_dir, "configs")
        self.config = _load_json(os.path.join(
            cfg_dir, self.workload["config"] + ".json"))
        self.settings_path = os.path.join(cfg_dir, self.config["settings"])
        bench = _load_json(os.path.join(root, "BENCHMARK.json"))
        entry = [w for w in bench["workloads"] if w["name"] == name]
        self.chips = entry[0]["chips"] if entry else 1
        e2e = [m for m in bench["end_to_end"] if self._reports(m)]
        e2e_names = {m["name"] for m in e2e}
        self.metrics = {
            0: e2e,
            1: [m for m in bench["per_layer"] if self._reports(m) and
                m["moves"] in e2e_names]}

    def _reports(self, metric) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def reader(self, metric_name: str):
        path = os.path.join(self.bench_dir, "metrics", metric_name + ".py")
        spec = importlib.util.spec_from_file_location(
            "slambench_metric_" + metric_name.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


class Run:
    """What a run measured, for the metric readers."""

    def __init__(self):
        self.setup_s = 0.0
        self.window_s = 0.0
        self.scans = 0
        self.keyframe_ms = []
        self.counters = {}
        self.spans = None
        self.trace = None
        self.kernel_calls = {}

    @property
    def keyframes(self) -> int:
        return len(self.keyframe_ms)


def _settings_tree(cell: Cell, overrides: dict) -> dict:
    tree = _load_json(cell.settings_path)
    for path, value in overrides.items():
        node = tree
        parts = path.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def _device_info(torch, dev):
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu", "count": 1}
    if dev.type == "cuda":
        import subprocess
        try:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=power.limit",
                 "--format=csv,noheader,nounits", "-i",
                 str(dev.index or 0)], capture_output=True, text=True,
                timeout=20)
            info["power_limit_w"] = float(out.stdout.strip())
        except (OSError, ValueError, subprocess.SubprocessError):
            info["power_limit_w"] = None
    return info


def run_cell(name: str, seed: int, seconds: float, trace: bool, t0: float,
             root: str = ROOT, bench_dir: str = BENCH_DIR,
             rehearsal: dict = None, control: bool = False) -> dict:
    """One run; returns the result line's fields. ``rehearsal`` (tests
    only; the command line cannot set it) runs on the CPU at a smaller
    size: ``settings`` overrides, ``scans`` (a cut of the log),
    ``prefix_scans``, ``warmup_scans`` and ``check`` overrides."""
    import torch

    rehearsal = rehearsal or {}
    cell = Cell(name, root, bench_dir)
    w = cell.workload
    dev = torch.device(rehearsal.get("device", "cuda"))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if dev.type == "cuda" and cards < cell.chips:
        raise SystemExit(f"{name} needs {cell.chips} CUDA device(s); "
                         f"{cards} available")
    from my_lidar_graph_slam_tpu_torch import launcher
    from my_lidar_graph_slam_tpu_torch.io import carmen
    from my_lidar_graph_slam_tpu_torch.sensor.data import RawScan
    from my_lidar_graph_slam_tpu_torch.utils import config as config_mod
    from my_lidar_graph_slam_tpu_torch.utils.metrics import MetricManager

    from slambench import check, probes, traffic
    from slambench import trace as trace_mod
    from slambench.reference import scans as ref_scans
    from slambench.reference import settings as ref_settings

    launcher.build_kernels(dev)

    # The log: made from the seed, written into TMPDIR, read back by the
    # program's reader.
    text, gt_poses, _ = traffic.make_log(cell.config["site"],
                                         cell.config["sensor"], w["laps"],
                                         seed)
    fd, log_path = tempfile.mkstemp(suffix=".clf")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        records = carmen.load(log_path)
    finally:
        os.unlink(log_path)
    scans = [r for r in records if isinstance(r, RawScan)]
    if "scans" in rehearsal:
        scans = scans[:rehearsal["scans"]]

    tree = _settings_tree(cell, rehearsal.get("settings", {}))
    cfg = config_mod.Config(tree)

    warmup = rehearsal.get("warmup_scans", w["warmup_scans"])
    if warmup:
        # The launcher's --warmup: a throwaway pipeline, its backend
        # driven at the production widths, then discarded.
        warm = config_mod.create_slam(cfg, device=dev,
                                      threaded_backend=False)
        for scan in scans[:warmup]:
            warm.process_scan(scan, scan.odom_pose)
        warm.frontend.flush(warm)
        warm.backend.run_once(warm)
        launcher._warm_backend(warm)
        del warm
        gc.collect()

    slam = config_mod.create_slam(cfg, device=dev, threaded_backend=True)
    spans = probes.Spans()
    check_cfg = dict(w["check"], **rehearsal.get("check", {}))
    cap = check.Capture(seed, check_cfg)
    probes.install(slam, spans, cap)

    def hand(i):
        cap.current_raw = i
        updated = slam.process_scan(scans[i], scans[i].odom_pose)
        if updated:
            cap.raw_of_scan[slam.scans.count - 1] = i
        return updated

    prefix = rehearsal.get("prefix_scans", w["prefix_scans"])
    slam.start_backend()
    try:
        for i in range(prefix):
            hand(i)
        slam.wait_for_backend()
        _sync(torch, dev)

        run = Run()
        kernels = probes.record_kernels(spans) if trace else {}
        prof = None
        if trace:
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        MetricManager.reset_instance()
        main_ident = threading.get_ident()

        # The window.
        _sync(torch, dev)
        mark0 = time.perf_counter_ns()
        run.setup_s = time.time() - t0
        spans.active = trace
        cap.active = True
        t_start = time.perf_counter()
        deadline = t_start + seconds
        i = prefix
        while i < len(scans) and time.perf_counter() < deadline:
            t1 = time.perf_counter()
            if hand(i):
                run.keyframe_ms.append((time.perf_counter() - t1) * 1e3)
            i += 1
        _sync(torch, dev)
        t_end = time.perf_counter()
        mark1 = time.perf_counter_ns()
        spans.active = False
        cap.active = False
        if i >= len(scans):
            print(f"{name}: the log ended inside the window after "
                  f"{i - prefix} scans; the window stops there",
                  file=sys.stderr)
        run.window_s = t_end - t_start
        run.scans = i - prefix
        run.counters = MetricManager.instance().to_dict()
        print("window counters: " + json.dumps(
            {k: v["value"] for k, v in run.counters.get("Counters",
                                                          {}).items()}),
              file=sys.stderr)
        memory_peak = torch.cuda.max_memory_allocated(dev) \
            if dev.type == "cuda" else 0
        if prof is not None:
            prof.__exit__(None, None, None)
    finally:
        slam.stop_backend()
    for k in kernels.values():
        k.restore()

    if trace:
        path = os.path.join(tempfile.gettempdir(),
                            f"slambench-trace-{os.getpid()}.json")
        prof.export_chrome_trace(path)
        del prof
        try:
            run.trace = trace_mod.summarize(path, spans, main_ident,
                                            (mark0, mark1))
        finally:
            os.unlink(path)
        print(f"trace: stopped, written and read in "
              f"{time.perf_counter() - t_end:.1f} s", file=sys.stderr)
        run.spans = spans
        run.kernel_calls = kernels
    else:
        run.spans = spans

    # The check, after the window and the memory reading.
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ref = ref_settings.read(tree)
    book = ref_scans.ScanBook(ref_scans.parse_flaser(text),
                              ref["interpolator"])
    found = check.compare(slam, cap, book, ref, gt_poses, dev)
    correct, lines = check.verdict(found["numbers"], w["limits"])
    out = {"correct": correct, "attempted": run.scans, "failed": 0,
           "ate_m": found["ate_m"], "checks": lines}
    if control:
        out["control"] = check.compare(slam, cap, book, ref, gt_poses, dev,
                                       control=True)["numbers"]

    metrics = {}
    for m in cell.metrics[1 if trace else 0]:
        value = cell.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = _device_info(torch, dev)
    device["memory_peak_bytes"] = int(memory_peak)
    if trace:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
    out.update(metrics=metrics, device=device)
    if trace:
        out["breakdown"] = trace_mod.breakdown(run.trace)
    return out


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def print_result(out: dict) -> None:
    """Each compared number beside its limit on standard error, then the
    result line, its ``checks`` key last."""
    checks = out.pop("checks")
    for k, v in checks.items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r}, "
              f"n={v['n']})", file=sys.stderr)
    line = {k: out[k] for k in ("correct", "attempted", "failed", "metrics",
                                "device")}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["ate_m"] = out["ate_m"]
    line["checks"] = checks
    print(json.dumps(line), flush=True)


def main(argv, t0: float) -> int:
    parser = argparse.ArgumentParser(prog="slambench/run.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    try:
        out = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace), t0)
    except SystemExit as exc:
        print(f"slambench: {exc}", file=sys.stderr)
        return 2
    except Exception:  # a failed run prints its traceback and no result
        traceback.print_exc()
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"slambench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    print_result(out)
    return 0
