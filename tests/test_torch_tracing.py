"""The port's tracing on the CPU: spans (``MetricManager.span``), the
host-sync counters (``utils/device.py``, ``HostSyncs.<layer>``) and the
device timers.

A short SLAM runs on the small robust settings and mini log of
``tests/test_torch_launcher.py``, with the threaded backend, once without
and once inside a ``torch.profiler`` session. Every call of the two sync
helpers is tallied by its layer as the Python stack shows it (a matcher's
``match_async``/``resolve_async``, the map builder's ``append_scan``/
``after_loop_closure``, the backend's ``run_once``), independently of the
spans that the counters read.
"""

import collections
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from my_lidar_graph_slam_tpu_torch.io import carmen, synth
from my_lidar_graph_slam_tpu_torch.models import map_builder as mb
from my_lidar_graph_slam_tpu_torch.models import slam as slam_mod
from my_lidar_graph_slam_tpu_torch.models.scan_matchers import AsyncMatcher
from my_lidar_graph_slam_tpu_torch.sensor.data import RawScan
from my_lidar_graph_slam_tpu_torch.utils import config as config_mod
from my_lidar_graph_slam_tpu_torch.utils import device as device_mod
from my_lidar_graph_slam_tpu_torch.utils import metrics
from my_lidar_graph_slam_tpu_torch.utils.metrics import MetricManager
from tests.test_torch_launcher import _small_robust_settings
from tests.test_torch_matcher import one_torch_thread  # noqa: F401

FRONTEND_SPANS = {"keyframe", "frontend.match", "frontend.resolve",
                  "lock_wait", "map_builder.update", "sync"}
BACKEND_SPANS = {"backend.pass", "backend.detect", "backend.solve",
                 "map_builder.rebuild"}


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    """The launcher tests' mini log (the port's copy of the generator)
    and small robust settings; returns (scans, settings path)."""
    tmp = tmp_path_factory.mktemp("tracing")
    scans, gt = synth.simulate(
        world=synth.mini_world(), waypoints=synth.mini_loop_waypoints(),
        config=synth.SimConfig(step=0.25, max_range=8.0, seed=4))
    log = str(tmp / "mini.clf")
    synth.write_carmen_log(log, scans, max_range=8.0)
    settings = str(tmp / "settings.json")
    _small_robust_settings(settings, gt[0])
    return [r for r in carmen.load(log) if isinstance(r, RawScan)], settings


def _stack_layer() -> str:
    """The layer of the calling helper as the Python stack shows it."""
    frame = sys._getframe(2)
    while frame is not None:
        name = frame.f_code.co_name
        owner = frame.f_locals.get("self")
        if name in ("match_async", "resolve_async") and \
                isinstance(owner, AsyncMatcher):
            return "frontend"
        if name in ("append_scan", "after_loop_closure") and \
                isinstance(owner, mb.GridMapBuilder):
            return "map_builder"
        if name == "run_once" and isinstance(owner, slam_mod.Backend):
            return "backend"
        frame = frame.f_back
    return "other"


def _run(mini, monkeypatch, profile: bool):
    """One threaded SLAM run; returns (metrics dict, helper calls by
    layer, the SLAM, the profiler or None, perf_counter_ns bounds, the
    frontend's thread id)."""
    scans, settings = mini
    calls = collections.Counter()
    lock = threading.Lock()

    def tallied(fn):
        def call(*args, **kwargs):
            layer = _stack_layer()
            with lock:
                calls[layer] += 1
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(device_mod, "upload", tallied(device_mod.upload))
    monkeypatch.setattr(device_mod, "sync", tallied(device_mod.sync))
    slam = config_mod.create_slam(config_mod.load(settings), device="cpu",
                                  threaded_backend=True)
    MetricManager.reset_instance()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU]) if profile else None
    t0 = time.perf_counter_ns()
    if prof is not None:
        prof.__enter__()
    slam.start_backend()
    try:
        for scan in scans:
            slam.process_scan(scan, scan.odom_pose)
    finally:
        slam.stop_backend()
        if prof is not None:
            prof.__exit__(None, None, None)
    t1 = time.perf_counter_ns()
    monkeypatch.undo()
    return (MetricManager.instance().to_dict(), calls, slam, prof, (t0, t1),
            threading.get_ident())


def _host_syncs(d):
    return {k[len("HostSyncs."):]: v["value"]
            for k, v in d["Counters"].items() if k.startswith("HostSyncs.")}


@pytest.fixture(scope="module")
def traced(mini):
    mp = pytest.MonkeyPatch()
    try:
        return _run(mini, mp, True)
    finally:
        mp.undo()


def test_off_records_no_span(mini, monkeypatch):
    """Without a profiler session: no span, no record_function range, no
    CUDA event; the host syncs are counted all the same."""
    ranges = []
    events = []
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda *a, **k: ranges.append(a))
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda *a, **k: events.append(a))
    assert not metrics.tracing()
    d, calls, slam, _, _, _ = _run(mini, pytest.MonkeyPatch(), False)
    assert "Spans" not in d
    assert MetricManager.instance().span_rows() == []
    assert "MapBuilderRaycastBytes" not in d["Counters"]
    assert ranges == [] and events == []
    assert slam.frontend.process_count > 20
    assert _host_syncs(d) == dict(calls)


def test_spans_nest_under_their_keyframe(traced):
    d, _, slam, _, (t0, t1), main = traced
    rows = d["Spans"]
    names = collections.Counter(r[0] for r in rows)
    assert set(names) == FRONTEND_SPANS | BACKEND_SPANS, names
    graph = slam.graph
    keyframes = {r[5] for r in rows if r[0] == "keyframe"}
    assert keyframes == set(graph.scan_ids[:graph.num_nodes].tolist())
    assert names["keyframe"] == graph.num_nodes
    assert names["frontend.match"] == names["frontend.resolve"] == \
        graph.num_nodes - 1 == names["map_builder.update"] - 1
    for r in rows:
        name, thread, start, end, parent, kf, attrs = r
        assert t0 <= start <= end <= t1
        assert (name == "sync") == ("site" in attrs)
        root = r
        while root[4] >= 0:
            up = rows[root[4]]
            assert up[1] == thread and up[2] <= start and end <= up[3]
            root = up
        if name in BACKEND_SPANS or root[0] == "backend.pass":
            assert thread != main and root[0] == "backend.pass"
        else:
            assert thread == main and root[0] == "keyframe"
        assert kf == root[5]
    passes = sorted(r[5] for r in rows if r[0] == "backend.pass")
    assert passes == list(range(1, slam.backend.num_passes + 1))


def test_host_syncs_are_the_helper_calls_of_each_layer(traced):
    d, calls, slam, _, _, _ = traced
    syncs = _host_syncs(d)
    assert syncs == dict(calls)
    assert sum(r[0] == "sync" for r in d["Spans"]) == sum(syncs.values())
    # Per keyframe: 7 scan uploads, the pose and the resolve's wait; the
    # map update's 6 + 7 uploads and the latest map's origin.
    matches = d["Counters"]["FrontendMatches"]["value"]
    assert matches == slam.graph.num_nodes - 1
    assert syncs["frontend"] == 9 * matches
    assert syncs["map_builder"] >= 14 * slam.graph.num_nodes
    assert syncs["backend"] > 0
    assert d["Counters"]["MapBuilderRaycastBytes"]["value"] > \
        5 * 192 * 192 * slam.graph.num_nodes


def test_ranges_reach_the_profiler(traced):
    """The frontend thread's spans are record_function ranges in the
    profiler's events (this torch records ranges on the thread that
    entered the profiler only)."""
    d, _, _, prof, _, _ = traced
    names = collections.Counter(e.name for e in prof.events())
    rows = collections.Counter(r[0] for r in d["Spans"]
                               if r[0] in FRONTEND_SPANS)
    for name in FRONTEND_SPANS:
        assert names[name] >= 1, name
    assert names["keyframe"] == rows["keyframe"]


def test_export_survives_save_json(traced, tmp_path):
    d = traced[0]
    m = MetricManager()
    m._spans = [list(r) for r in d["Spans"]]
    path = str(tmp_path / "m.json")
    m.save_json(path)
    with open(path) as f:
        assert json.load(f)["Spans"] == json.loads(json.dumps(d["Spans"]))


def test_span_rows_drop_what_an_instance_did_not_see(monkeypatch):
    """A span open across a reset belongs to the old instance: its child
    in the new one has no parent but keeps its keyframe; an open span is
    not exported; nothing is recorded after the session."""
    MetricManager.reset_instance()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with MetricManager.span("keyframe", keyframe=7):
            MetricManager.reset_instance()
            with MetricManager.span("frontend.match"):
                assert metrics.current_layer() == "frontend"
                with MetricManager.span("sync", site="x"):
                    pass
            outer = MetricManager.span("map_builder.update")
            outer.__enter__()
            rows = MetricManager.instance().span_rows()
            outer.__exit__(None, None, None)
    assert metrics.current_layer() == "other"
    assert [r[0] for r in rows] == ["frontend.match", "sync"]
    assert [(r[4], r[5]) for r in rows] == [(-1, 7), (0, 7)]
    with MetricManager.span("keyframe", keyframe=8):
        pass
    assert len(MetricManager.instance().span_rows()) == 3


def test_device_timer_on_the_cpu_is_the_host_clock():
    m = MetricManager()
    with m.device_timer("T", torch.device("cpu")):
        time.sleep(0.01)
    d = m.to_dict()["Distributions"]["T"]
    assert d["num_samples"] == 1 and d["min"] >= 0.01


def test_upload_and_sync_copy_as_before():
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)[:, ::2]
    got = device_mod.upload(arr, "cpu", site="t")
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), arr)
    scalar = device_mod.upload([0.1], "cpu", torch.float32, site="t")
    assert scalar.dtype == torch.float32 and float(scalar[0]) == \
        float(np.float32(0.1))
    t = torch.ones(3)
    assert device_mod.sync(t, site="t") is t
    assert device_mod.sync(None, site="t") is None


@pytest.mark.parametrize("chunked", [False, True], ids=["append_scan",
                                                         "chunk"])
def test_built_poses_are_copies(mini, chunked):
    """No local map's recorded poses share memory with the pose graph
    after ``append_scan`` or ``append_scans_chunk`` opens it."""
    scans, settings = mini
    slam = config_mod.create_slam(config_mod.load(settings), device="cpu")
    graph = slam.graph
    if chunked:
        for scan in scans[:60]:
            slam.process_scan(scan, scan.odom_pose)
        builder = mb.GridMapBuilder(slam.builder.config, slam.scans,
                                    device="cpu")
        steps = [lambda n=n: builder.append_scans_chunk(graph, n, 1)
                 for n in range(graph.num_nodes)]
    else:
        builder = slam.builder
        steps = [lambda s=s: slam.process_scan(s, s.odom_pose)
                 for s in scans[:60]]
    for step in steps:
        step()
        for lm in builder.local_maps:
            assert not np.shares_memory(lm.built_poses, graph.poses)
    assert len(builder.local_maps) >= 2


def test_closure_between_a_maps_first_two_keyframes_rebuilds_it(mini):
    """A closure that moves a new local map's only node must rebuild the
    map (the JAX package keeps a view and skips it)."""
    scans, settings = mini
    slam = config_mod.create_slam(config_mod.load(settings), device="cpu")
    builder, graph = slam.builder, slam.graph
    for scan in scans:
        maps = len(builder.local_maps)
        slam.process_scan(scan, scan.odom_pose)
        if maps and len(builder.local_maps) > maps:
            break
    lm = builder.local_maps[-1]
    assert lm.node_idx_min == lm.node_idx_max == graph.num_nodes - 1
    before = lm.grid
    MetricManager.reset_instance()
    graph.poses[lm.node_idx_min, :2] += 0.3     # in place, as write-back
    builder.after_loop_closure(graph)
    assert lm.grid is not before
    np.testing.assert_array_equal(lm.built_poses,
                                  graph.poses[lm.node_idx_min][None])
    counters = MetricManager.instance().to_dict()["Counters"]
    assert counters["LocalMapRebuilds"]["value"] >= 1
