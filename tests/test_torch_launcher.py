"""The port's launcher and its artifact writers against the JAX package on
the CPU.

Unit cases hold the copied modules (metrics, ATE), the map renderer, the
pose-graph JSON, the checkpoints (read both ways), the PNG codec and the
pyramid's windowed max against the JAX package. The end-to-end case runs
both launchers on one small synthetic log with a settings file derived
from ``configs/launcher_settings_robust.json`` (0.1 m cells, small maps, a
small loop window, several candidate maps); the JAX frontend and detector
are put on their Pallas sweep paths (interpret mode) by wrapping
``config.create_slam`` here, so both packages run the same algorithm.
Tolerances: poses 1e-3 and ATE 0.02 m (tests/test_torch_slice.py:35-36),
JSON numbers 1e-9, ATE functions 1e-12, rendered pixels 1 gray level.
"""

import contextlib
import io
import json
import os
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from my_lidar_graph_slam_tpu import launcher as jlauncher
from my_lidar_graph_slam_tpu.io import map_io as jmap_io
from my_lidar_graph_slam_tpu.io import synth as jsynth
from my_lidar_graph_slam_tpu.models import map_builder as jmb
from my_lidar_graph_slam_tpu.models.pose_graph import PoseGraph as JGraph
from my_lidar_graph_slam_tpu.ops import grid as jgrid
from my_lidar_graph_slam_tpu.ops import pyramid as jpyramid
from my_lidar_graph_slam_tpu.sensor.data import RawScan as JRawScan
from my_lidar_graph_slam_tpu.utils import ate as jate
from my_lidar_graph_slam_tpu.utils import config as jconfig
from my_lidar_graph_slam_tpu.utils import metrics as jmetrics
from my_lidar_graph_slam_tpu_torch import interop
from my_lidar_graph_slam_tpu_torch import launcher as tlauncher
from my_lidar_graph_slam_tpu_torch.io import map_io as tmap_io
from my_lidar_graph_slam_tpu_torch.io import png, viz
from my_lidar_graph_slam_tpu_torch.models import loop_closure as tlc
from my_lidar_graph_slam_tpu_torch.models import map_builder as tmb
from my_lidar_graph_slam_tpu_torch.models.pose_graph import PoseGraph as TGraph
from my_lidar_graph_slam_tpu_torch.ops import pyramid as tpyramid
from my_lidar_graph_slam_tpu_torch.parallel import distributed as tdist
from my_lidar_graph_slam_tpu_torch.sensor.data import RawScan as TRawScan
from my_lidar_graph_slam_tpu_torch.utils import ate as tate
from my_lidar_graph_slam_tpu_torch.utils import metrics as tmetrics
from tests.test_torch_matcher import one_torch_thread  # noqa: F401

ROBUST = "configs/launcher_settings_robust.json"


# --------------------------------------------------------------------------
# Metrics and ATE (copies)
# --------------------------------------------------------------------------


def _observe(m):
    """The observations of tests/test_aux.py:20-55 on one manager."""
    d = m.distributions("d")
    for v in [1.0, 2.0, 3.0, 4.0, 10.0]:
        d.observe(v)
    h = m.histograms("h", boundaries=[0.0, 0.25, 0.5, 0.75, 1.0])
    for v in [-0.5, 0.1, 0.3, 0.9, 5.0]:
        h.observe(v)
    m.counters("scans").increment(5)
    m.gauges("nodes").set(42)
    m.distributions("match_time").observe(0.1)
    m.value_sequences("seq").observe(3.5)
    return m.to_dict()


def test_metric_manager_matches_jax():
    assert _observe(tmetrics.MetricManager()) == \
        _observe(jmetrics.MetricManager())
    for mod in (tmetrics, jmetrics):
        e = mod.Histogram.create_exponential("e", 1.0, 3)
        u = mod.Histogram.create_uniform("u", 0.0, 1.0, 0.25)
        for v in [0.5, 1.5, 3.0, 100.0]:
            e.observe(v)
            u.observe(v)
    assert tmetrics.Histogram.create_exponential("e", 1.0, 3).boundaries \
        == jmetrics.Histogram.create_exponential("e", 1.0, 3).boundaries
    assert tmetrics.Histogram.create_uniform("u", 0.0, 1.0, 0.25).boundaries \
        == jmetrics.Histogram.create_uniform("u", 0.0, 1.0, 0.25).boundaries


def test_ate_matches_jax():
    """The trajectory of tests/test_aux.py:172-192."""
    rng = np.random.default_rng(0)
    t = np.linspace(0, 10, 101)
    gt = np.stack([np.cos(t), np.sin(t), t], axis=-1)
    ang = 0.7
    r = np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
    est_t = t[::3] + 0.01
    sub = np.stack([np.cos(est_t), np.sin(est_t), est_t], axis=-1)
    est = np.concatenate([sub[:, :2] @ r.T + [5.0, -2.0] +
                          rng.normal(0, 0.01, (len(est_t), 2)),
                          sub[:, 2:]], axis=1)
    for a, b in zip(tate.associate(est_t, t), jate.associate(est_t, t)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tate.align_se2(est[:, :2], sub[:, :2]),
                    jate.align_se2(est[:, :2], sub[:, :2])):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    for aligned in (True, False):
        got = tate.ate_rmse(est, gt, est_times=est_t, gt_times=t,
                            aligned=aligned)
        ref = jate.ate_rmse(est, gt, est_times=est_t, gt_times=t,
                            aligned=aligned)
        assert abs(got - ref) <= 1e-12
    assert tate.ate_rmse(est, gt, est_times=est_t, gt_times=t) < 0.05


# --------------------------------------------------------------------------
# Map rendering, PNG, pose graph, checkpoints, pyramid
# --------------------------------------------------------------------------


def _scene():
    """A map with walls, free space and unknown cells; a short trajectory
    and scans (JAX package and port, on the same values)."""
    rng = np.random.default_rng(1)
    g = jgrid.empty(96, 80, 0.05, center=np.array([0.2, -0.1]))
    lo = np.zeros((96, 80), np.float32)
    lo[30:34, 10:70] = 2.5
    lo[40:80, 20:60] = rng.uniform(-3.0, 3.0, (40, 40))
    obs = np.zeros((96, 80), bool)
    obs[25:85, 8:72] = True
    g = g._replace(log_odds=jnp.asarray(lo), observed=jnp.asarray(obs))
    poses = np.array([[0.0, 0.0, 0.0], [0.4, 0.3, 0.5], [0.9, 0.2, 1.0]])
    return g, poses


def _graph_and_scans(gcls, scls, rcls, n=5, cap=32, seed=0):
    rng = np.random.default_rng(seed)
    graph, scans = gcls(), scls(beam_capacity=cap)
    for i in range(n):
        sid = scans.append(rcls(
            "F", float(i), np.zeros(3), np.zeros(3), np.zeros(3), 0.0, 20.0,
            -1.0, 1.0, np.linspace(-1, 1, 16), rng.uniform(1, 5, 16)))
        graph.append_node(rng.uniform(-1, 1, 3), sid)
        if i:
            graph.append_edge(i - 1, i, rng.uniform(-1, 1, 3),
                              np.diag(rng.uniform(1, 50, 3)))
    graph.append_edge(0, n - 1, rng.uniform(-1, 1, 3), np.eye(3) * 7.0)
    return graph, scans


def test_save_map_matches_jax(tmp_path):
    g, poses = _scene()
    tg = interop.grid_from_numpy(g.log_odds, g.observed, g.origin, 0.05,
                                 "cpu")
    graph, scans = _graph_and_scans(TGraph, tmb.ScanStore, TRawScan)
    pts, origins = tmap_io.scan_endpoints(graph, scans, 0, 2)
    kw = dict(node_poses=poses, node_idx_max=2, scan_points=pts,
              scan_poses=origins)
    jmap_io.save_map(g, str(tmp_path / "j"), **kw)
    tmap_io.save_map(tg, str(tmp_path / "t"), **kw)
    ref = np.asarray(Image.open(tmp_path / "j.png").convert("RGB"),
                     np.int32)
    got = png.read_png(str(tmp_path / "t.png")).astype(np.int32)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1
    via_pil = np.asarray(Image.open(tmp_path / "t.png"), np.int32)
    np.testing.assert_array_equal(via_pil, got)
    mj = json.load(open(tmp_path / "j.json"))
    mt = json.load(open(tmp_path / "t.json"))
    assert mj.keys() == mt.keys() and mj["Map"].keys() == mt["Map"].keys()
    for k in ("Resolution", "WidthInGridCells", "HeightInGridCells",
              "PoseGraphNodeIdxMin", "PoseGraphNodeIdxMax"):
        assert mj["Map"][k] == mt["Map"][k], k
    for k in ("BottomLeft", "TopRight"):
        for c in "XY":
            assert abs(mj["Map"][k][c] - mt["Map"][k][c]) < 1e-6


def test_png_codec_round_trips_with_pil(tmp_path):
    """The port's PNGs read back through PIL and through the port's reader;
    a damaged chunk and a PNG the port does not write are refused."""
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    png.write_png(str(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")),
                                  img)
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "a.png")), img)
    data = bytearray(open(tmp_path / "a.png", "rb").read())
    data[40] ^= 0xFF
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(bytes(data))
    Image.fromarray(img[..., 0], "L").save(tmp_path / "gray.png")
    with pytest.raises(ValueError, match="unsupported"):
        png.read_png(str(tmp_path / "gray.png"))


def test_pose_graph_json_matches_jax(tmp_path):
    jg, js = _graph_and_scans(JGraph, jmb.ScanStore, JRawScan)
    tg, ts = _graph_and_scans(TGraph, tmb.ScanStore, TRawScan)
    jmap_io.save_pose_graph(jg, js, str(tmp_path / "j"))
    tmap_io.save_pose_graph(tg, ts, str(tmp_path / "t"))
    a = json.load(open(tmp_path / "t.posegraph.json"))
    b = json.load(open(tmp_path / "j.posegraph.json"))

    def flat(x, prefix=""):
        if isinstance(x, dict):
            out = {}
            for k, v in x.items():
                out.update(flat(v, f"{prefix}/{k}"))
            return out
        if isinstance(x, list):
            out = {}
            for i, v in enumerate(x):
                out.update(flat(v, f"{prefix}/{i}"))
            return out
        return {prefix: x}

    fa, fb = flat(a), flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert abs(fa[k] - fb[k]) <= 1e-9, k
    # Each package loads the other's file.
    for path, load in ((tmp_path / "j.posegraph.json",
                        tmap_io.load_pose_graph),
                       (tmp_path / "t.posegraph.json",
                        jmap_io.load_pose_graph)):
        g = load(str(path))
        assert (g.num_nodes, g.num_edges) == (tg.num_nodes, tg.num_edges)
        np.testing.assert_allclose(g.edge_info[:g.num_edges],
                                   tg.edge_info[:tg.num_edges], atol=1e-9)
        np.testing.assert_array_equal(g.edge_is_odom[:g.num_edges],
                                      tg.edge_is_odom[:tg.num_edges])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_loads_both_ways(tmp_path, writer):
    src = (_graph_and_scans(JGraph, jmb.ScanStore, JRawScan)
           if writer == "jax" else
           _graph_and_scans(TGraph, tmb.ScanStore, TRawScan))
    save = jmap_io.save_checkpoint if writer == "jax" else \
        tmap_io.save_checkpoint
    path = str(tmp_path / "ckpt.npz")
    save(path, *src)
    for load in (tmap_io.load_checkpoint, jmap_io.load_checkpoint):
        g, s = load(path, beam_capacity=32)
        assert (g.num_nodes, g.num_edges, s.count) == (5, 5, 5)
        np.testing.assert_array_equal(g.poses[:5], src[0].poses[:5])
        np.testing.assert_array_equal(g.edge_rel[:5], src[0].edge_rel[:5])
        np.testing.assert_array_equal(g.edge_is_odom[:5],
                                      src[0].edge_is_odom[:5])
        for name in ("ranges", "angles", "valid", "min_range", "max_range",
                     "rel_sensor_pose", "raw_beams", "timestamps"):
            np.testing.assert_array_equal(getattr(s, name)[:5],
                                          getattr(src[1], name)[:5])


@pytest.mark.parametrize("h", range(5))
def test_windowed_max_is_exact(h):
    rng = np.random.default_rng(h)
    vals = rng.uniform(0, 1, (37, 45)).astype(np.float32)
    vals[rng.uniform(size=vals.shape) < 0.3] = 0.0
    got = tpyramid.windowed_max(torch.from_numpy(vals), 1 << h).numpy()
    ref = np.asarray(jpyramid.windowed_max(jnp.asarray(vals), 1 << h))
    np.testing.assert_array_equal(got, ref)
    pyr = tpyramid.build_pyramid(torch.from_numpy(vals), h).numpy()
    np.testing.assert_array_equal(pyr[h], ref)


def test_pose_graph_png(tmp_path):
    graph, _ = _graph_and_scans(TGraph, tmb.ScanStore, TRawScan)
    viz.draw_pose_graph(graph, str(tmp_path / "pg.png"))
    img = png.read_png(str(tmp_path / "pg.png"))
    assert img.shape == (viz.SIZE, viz.SIZE, 3)
    colors = {tuple(c) for c in img.reshape(-1, 3)}
    assert {viz.RED, viz.BLACK, viz.BLUE, (255, 255, 255)} <= colors

    def bresenham(x0, y0, x1, y1):
        """The textbook integer loop (all octants)."""
        dx, dy = abs(x1 - x0), -abs(y1 - y0)
        sx, sy = (1 if x0 < x1 else -1), (1 if y0 < y1 else -1)
        err, pts = dx + dy, []
        while True:
            pts.append((x0, y0))
            if (x0, y0) == (x1, y1):
                return pts
            e2 = 2 * err
            if e2 >= dy:
                err += dy
                x0 += sx
            if e2 <= dx:
                err += dx
                y0 += sy

    rng = np.random.default_rng(3)
    for _ in range(200):
        x0, y0, x1, y1 = (int(v) for v in rng.integers(-30, 30, 4))
        xs, ys = viz.segment_pixels(x0, y0, x1, y1)
        got = list(zip(xs.tolist(), ys.tolist()))
        ref = bresenham(x0, y0, x1, y1)
        assert got[0] == (x0, y0) and got[-1] == (x1, y1)
        assert len(got) == len(ref) == max(abs(x1 - x0), abs(y1 - y0)) + 1
        # Same cells up to the tie rule (a half-way minor step).
        assert max(abs(a - c) + abs(b - d)
                   for (a, b), (c, d) in zip(got, ref)) <= 1


# --------------------------------------------------------------------------
# The launcher
# --------------------------------------------------------------------------


def _flags(main):
    """The long options that ``main``'s ``--help`` lists."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
        main()
    return set(re.findall(r"--[a-z][a-z-]+", out.getvalue()))


def test_launcher_takes_every_jax_flag(monkeypatch, launcher_runs,
                                      tmp_path):
    """Every flag of the JAX launcher; ``--mesh-devices 8`` under
    ``--platform cpu`` runs the small settings' log with the node-sharded
    solve at every closure and the branch-and-bound fan-out detector (no
    sweep), and ``--multihost`` without a coordinator raises."""
    monkeypatch.setattr(sys, "argv", ["launcher", "--help"])
    ref = _flags(jlauncher.main)
    got = _flags(lambda: tlauncher.main(["--help"]))
    assert got == ref
    tmp, _, _ = launcher_runs
    calls = {"solves": 0, "fanouts": 0, "sweeps": 0}

    def count(key, fn):
        def counted(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return counted

    bb = tlc.LoopDetectorBranchBound
    monkeypatch.setattr(tdist, "optimize_sharded_nodes",
                        count("solves", tdist.optimize_sharded_nodes))
    monkeypatch.setattr(bb, "_detect_fanout",
                        count("fanouts", bb._detect_fanout))
    monkeypatch.setattr(bb, "_detect_multi", count("sweeps", bb._detect_multi))
    monkeypatch.setattr(bb, "_detect_single",
                        count("sweeps", bb._detect_single))
    tmetrics.MetricManager.reset_instance()
    stats = tlauncher.run(str(tmp / "mini.clf"), str(tmp / "settings.json"),
                          str(tmp_path / "mesh"), platform="cpu",
                          mesh_devices=8, threaded_backend=False,
                          gt_path=str(tmp / "gt.npz"))
    assert stats["num_loop_closures"] >= 1
    assert calls["solves"] == stats["num_loop_closures"]
    assert calls["fanouts"] >= 1 and calls["sweeps"] == 0
    assert np.isfinite(stats["ate_rmse_m"])
    assert os.path.exists(str(tmp_path / "mesh.ckpt.npz"))
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        tlauncher.run("log", ROBUST, "out", platform="cpu", multihost=True)
    assert tlauncher.resolve_platform("cpu").type == "cpu"
    with pytest.raises(ValueError):
        tlauncher.resolve_platform("tpu")


def _small_robust_settings(path, gt0):
    """The robust settings at CI scale: 0.1 m cells, 256^2 local and 192^2
    latest maps, a +-1 m x +-1 m x 0.5 rad loop window, 8 m ranges."""
    d = json.load(open(ROBUST))
    gm = d["GridMapBuilder"]
    gm["Map"].update(Resolution=0.1, NumOfScansForLatestMap=5,
                     TravelDistThresholdForLocalMap=6.0)
    gm["UsableRangeMax"] = 8.0
    d["Tpu"] = dict(LocalMapSize=256, LatestMapSize=192, BeamCapacity=256,
                    MaxRaySteps=128)
    fe = d["Frontend"]
    fe.update(UseScanInterpolator=False, UpdateThresholdAngle=0.3)
    fe["InitialPose"] = dict(X=float(gt0[0]), Y=float(gt0[1]),
                             Theta=float(gt0[2]))
    d["ScanMatcherRealTimeCorrelative"]["ScanRangeMax"] = 8.0
    d["CostGreedyEndpoint"]["UsableRangeMax"] = 8.0
    bb = d["LoopDetectorBranchBound"]
    bb["ScoreThreshold"] = 0.5
    bb["ScanMatcher"].update(SearchRangeX=2.0, SearchRangeY=2.0,
                             SearchRangeTheta=0.5, ScanRangeMax=8.0,
                             NodeHeightMax=4)
    bb["CostGreedyEndpoint"]["UsableRangeMax"] = 8.0
    bb["ScorePixelAccurate"]["UsableRangeMax"] = 8.0
    d["LoopSearcherNearest"].update(TravelDistThreshold=5.0,
                                    PoseGraphNodeDistMax=3.0)
    with open(path, "w") as f:
        json.dump(d, f)


@pytest.fixture(scope="module")
def launcher_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("launcher")
    scans, gt = jsynth.simulate(
        world=jsynth.mini_world(), waypoints=jsynth.mini_loop_waypoints(),
        config=jsynth.SimConfig(step=0.25, max_range=8.0, seed=4))
    log = str(tmp / "mini.clf")
    jsynth.write_carmen_log(log, scans, max_range=8.0)
    gt_path = str(tmp / "gt.npz")
    np.savez(gt_path, true_poses=gt,
             timestamps=np.array([s.timestamp for s in scans]))
    settings = str(tmp / "settings.json")
    _small_robust_settings(settings, gt[0])

    passes = []
    multi = tlc.LoopDetectorBranchBound._detect_multi

    def counted(self, graph, builder, cands):
        passes.append(len(cands))
        return multi(self, graph, builder, cands)

    create = jconfig.create_slam

    def create_on_sweep(*a, **kw):
        s = create(*a, **kw)
        s.frontend.matcher.use_mxu = True
        s.frontend.matcher.mxu_interpret = True
        s.backend.detector.use_mxu = True
        s.backend.detector.mxu_interpret = True
        return s

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(tlc.LoopDetectorBranchBound, "_detect_multi", counted)
        mp.setattr(jconfig, "create_slam", create_on_sweep)
        out = {}
        for name, mod, kw in (("torch", tlauncher, dict(platform="cpu")),
                              ("jax", jlauncher, {})):
            (tmetrics if name == "torch" else jmetrics
             ).MetricManager.reset_instance()
            stats = mod.run(log, settings, str(tmp / name),
                            threaded_backend=False, gt_path=gt_path, **kw)
            out[name] = stats
    finally:
        mp.undo()
    return tmp, out, passes


def test_launcher_matches_jax(launcher_runs):
    tmp, stats, passes = launcher_runs
    t, j = stats["torch"], stats["jax"]
    assert t.keys() == j.keys()
    for k in ("num_scans", "num_nodes", "num_edges", "num_loop_closures"):
        assert t[k] == j[k], k
    assert t["num_loop_closures"] >= 1
    assert any(n >= 2 for n in passes)
    assert abs(t["ate_rmse_m"] - j["ate_rmse_m"]) < 0.02
    tg, _ = tmap_io.load_checkpoint(str(tmp / "torch.ckpt.npz"), 256)
    jg, _ = jmap_io.load_checkpoint(str(tmp / "jax.ckpt.npz"), 256)
    np.testing.assert_allclose(tg.node_poses(), jg.node_poses(), rtol=0,
                               atol=1e-3)


def test_launcher_writes_the_jax_artifacts(launcher_runs):
    tmp, _, _ = launcher_runs
    names = {n: sorted(f[len(n):] for f in os.listdir(tmp)
                       if f.startswith(n + ".") or f.startswith(n + "-"))
             for n in ("torch", "jax")}
    assert names["torch"] == names["jax"]
    assert ".metrics.json" in names["torch"]
    mt = json.load(open(tmp / "torch.metrics.json"))
    mj = json.load(open(tmp / "jax.metrics.json"))
    assert mt.keys() == mj.keys()
    for family in mt:
        names = set(mt[family])
        if family == "Counters":
            # The port's own counters, beside the JAX package's names.
            names -= {n for n in names if n.startswith("HostSyncs.")}
            names.remove("FrontendMatches")
        assert names == set(mj[family]), family
    assert mt["Counters"]["FrontendMatches"] == \
        mt["Counters"]["FrontendMxuMatches"]
    for name in ("FrontendMxuMatches", "LoopDetectMxuQueries",
                 "LoopClosingEdges"):
        assert mt["Counters"][name] == mj["Counters"][name], name
    # The port pads only ragged folds, the JAX package up to powers of two.
    padded = "LoopDetectMxuPaddedQueries"
    assert mt["Counters"][padded]["value"] <= mj["Counters"][padded]["value"]
    img = png.read_png(str(tmp / "torch.png"))
    ref = np.asarray(Image.open(tmp / "jax.png").convert("RGB"))
    assert img.shape == ref.shape


def test_launcher_cli_on_the_cpu(launcher_runs, tmp_path):
    """``python -m ... LOG SETTINGS OUT --platform cpu`` in replay mode,
    with the optional artifacts."""
    tmp, stats, _ = launcher_runs
    tmetrics.MetricManager.reset_instance()
    out = str(tmp_path / "cli")
    tlauncher.main([str(tmp / "mini.clf"), str(tmp / "settings.json"), out,
                    "--platform", "cpu", "--replay-chunk", "8",
                    "--gt", str(tmp / "gt.npz"), "--save-local-maps",
                    "--save-pyramid-maps", "--max-scans", "60",
                    "--warmup", "20"])
    g = tmap_io.load_pose_graph(out + ".posegraph.json")
    gc, sc = tmap_io.load_checkpoint(out + ".ckpt.npz", 256)
    assert g.num_nodes == gc.num_nodes > 10
    for f in (out + ".png", out + "-latest.png", out + "-posegraph.png",
              out + "-local-map-0.png", out + "-1.png", out + "-64.png"):
        assert png.read_png(f).ndim == 3
