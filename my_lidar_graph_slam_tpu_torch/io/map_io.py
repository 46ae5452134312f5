"""Map and pose-graph export + checkpoint/resume.

Counterpart of ``my_lidar_graph_slam_tpu/io/map_io.py``, with the same
file names, JSON keys and ``.npz`` fields, so each package reads the
other's pose graphs and checkpoints. PNGs are written by the port's own
encoder (``io/png.py``) instead of PIL; the pixels are computed as in the
JAX package.

PNG/JSON export with reference parity (map_saver.cpp):

 * occupancy image: grayscale ``(1 - p) * 255``, unknown cells gray 192,
   image flipped vertically (map_saver.cpp:277-317, 453-463);
 * trajectory polyline in red, scan overlay in blue, sensor pose in green
   (map_saver.cpp:320-410);
 * map metadata JSON (map_saver.cpp:499-532) and pose-graph JSON with
   per-edge upper-triangular information matrices (map_saver.cpp:56-120).

The reference has no loader for its own output; pose-graph JSON loading
and full-state checkpointing (graph + scan store) are extensions.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np

from my_lidar_graph_slam_tpu_torch.io import png
from my_lidar_graph_slam_tpu_torch.models import map_builder as mb
from my_lidar_graph_slam_tpu_torch.models.pose_graph import PoseGraph
from my_lidar_graph_slam_tpu_torch.ops import grid as gridops
from my_lidar_graph_slam_tpu_torch.ops import pyramid
from my_lidar_graph_slam_tpu_torch.utils import se2

UNKNOWN_GRAY = 192


def _resolution(grid: gridops.GridMap) -> float:
    """The cell size as the float32 the maps are built with (the JAX
    package keeps it as a float32 scalar), so pixels and metadata match."""
    return float(np.float32(grid.resolution))


def render_values(vals: np.ndarray, observed: np.ndarray,
                  origin: np.ndarray, resolution: float,
                  node_poses: Optional[np.ndarray] = None,
                  scan_points: Optional[np.ndarray] = None,
                  scan_poses: Optional[np.ndarray] = None,
                  crop: bool = True):
    """Render a raw occupancy-value array to RGB (core of SaveMapCore).

    ``scan_points``: world-frame beam endpoints [M, 2] drawn as 2x2 blue
    squares; ``scan_poses``: scan origins [K, 2] drawn as 3x3 green squares
    (DrawScan, map_saver.cpp:365-410). Returns (flipped image, bottom_left,
    top_right, (x0, y0) crop offset).
    """
    h, w = vals.shape
    if crop and observed.any():
        ys, xs = np.where(observed)
        y0, y1 = int(ys.min()), int(ys.max()) + 1
        x0, x1 = int(xs.min()), int(xs.max()) + 1
    else:
        y0, y1, x0, x1 = 0, h, 0, w
    sub = vals[y0:y1, x0:x1]
    sub_obs = observed[y0:y1, x0:x1]

    gray = ((1.0 - sub) * 255.0).astype(np.uint8)
    img = np.stack([gray, gray, gray], axis=-1)
    img[~sub_obs] = UNKNOWN_GRAY

    res = float(resolution)
    origin = np.asarray(origin)
    bottom_left = origin + res * np.array([x0, y0])
    top_right = origin + res * np.array([x1, y1])
    hh, ww = img.shape[:2]

    def to_img(px, py):
        return (np.floor((px - origin[0]) / res).astype(int) - x0,
                np.floor((py - origin[1]) / res).astype(int) - y0)

    if scan_points is not None and len(scan_points) > 0:
        ix, iy = to_img(scan_points[:, 0], scan_points[:, 1])
        keep = (ix >= 0) & (ix < ww - 1) & (iy >= 0) & (iy < hh - 1)
        for px, py in zip(ix[keep], iy[keep]):
            img[py:py + 2, px:px + 2] = (0, 0, 255)

    if node_poses is not None and len(node_poses) > 0:
        ix, iy = to_img(node_poses[:, 0], node_poses[:, 1])
        for k in range(1, len(ix)):
            n = max(abs(ix[k] - ix[k - 1]), abs(iy[k] - iy[k - 1]), 1)
            xs_l = np.round(np.linspace(ix[k - 1], ix[k], n + 1)).astype(int)
            ys_l = np.round(np.linspace(iy[k - 1], iy[k], n + 1)).astype(int)
            for px, py in zip(xs_l, ys_l):
                img[max(0, py - 1):py + 1, max(0, px - 1):px + 1] = \
                    (255, 0, 0)

    if scan_poses is not None and len(scan_poses) > 0:
        ix, iy = to_img(scan_poses[:, 0], scan_poses[:, 1])
        keep = (ix >= 0) & (ix < ww - 2) & (iy >= 0) & (iy < hh - 2)
        for px, py in zip(ix[keep], iy[keep]):
            img[py:py + 3, px:px + 3] = (0, 255, 0)

    # PNG is written flipped upside down (map_saver.cpp:453-463).
    return img[::-1], bottom_left, top_right, (x0, y0)


def render_map(grid: gridops.GridMap,
               node_poses: Optional[np.ndarray] = None,
               scan_points: Optional[np.ndarray] = None,
               scan_poses: Optional[np.ndarray] = None,
               crop: bool = True):
    """Render an occupancy grid to an RGB array (bottom row = min y)."""
    return render_values(
        gridops.values(grid).cpu().numpy(), grid.observed.cpu().numpy(),
        grid.origin.cpu().numpy(), _resolution(grid),
        node_poses=node_poses, scan_points=scan_points,
        scan_poses=scan_poses, crop=crop)


def scan_endpoints(graph: PoseGraph, scans: mb.ScanStore,
                   node_idx_min: int, node_idx_max: int) -> tuple:
    """World-frame beam endpoints + sensor origins for a node span
    (the DrawScan inputs, map_saver.cpp:387-410)."""
    pts, origins = [], []
    for i in range(node_idx_min, node_idx_max + 1):
        sid = int(graph.scan_ids[i])
        if sid < 0:
            continue
        n = int(scans.raw_beams[sid])
        sp = se2.compound_np(graph.poses[i],
                             scans.rel_sensor_pose[sid].astype(np.float64))
        a = sp[2] + scans.angles[sid, :n]
        r = scans.ranges[sid, :n]
        keep = r < scans.max_range[sid]
        pts.append(np.stack([sp[0] + r[keep] * np.cos(a[keep]),
                             sp[1] + r[keep] * np.sin(a[keep])], axis=-1))
        origins.append(sp[:2])
    if not pts:
        return np.zeros((0, 2)), np.zeros((0, 2))
    return np.concatenate(pts, axis=0), np.asarray(origins)


def save_map(grid: gridops.GridMap, filename: str,
             node_poses: Optional[np.ndarray] = None,
             draw_trajectory: bool = True,
             save_metadata: bool = True,
             node_idx_min: int = 0, node_idx_max: int = 0,
             scan_points: Optional[np.ndarray] = None,
             scan_poses: Optional[np.ndarray] = None):
    """SaveMapCore equivalent: ``<filename>.png`` + ``<filename>.json``."""
    img, bottom_left, top_right, _ = render_map(
        grid, node_poses if draw_trajectory else None,
        scan_points=scan_points, scan_poses=scan_poses)
    png.write_png(filename + ".png", img)
    if save_metadata:
        h, w = img.shape[:2]
        meta = {"Map": {
            "Resolution": _resolution(grid),
            "WidthInGridCells": int(w),
            "HeightInGridCells": int(h),
            "BottomLeft": {"X": float(bottom_left[0]),
                           "Y": float(bottom_left[1])},
            "TopRight": {"X": float(top_right[0]),
                         "Y": float(top_right[1])},
            "PoseGraphNodeIdxMin": int(node_idx_min),
            "PoseGraphNodeIdxMax": int(node_idx_max),
        }}
        with open(filename + ".json", "w") as f:
            json.dump(meta, f, indent=2)


def save_local_maps(builder: mb.GridMapBuilder, graph: PoseGraph,
                    filename: str):
    """One PNG+JSON per local map: ``<filename>-local-map-<i>``
    (MapSaver::SaveLocalMaps, map_saver.cpp:123-156)."""
    poses = graph.node_poses()
    for lm in builder.local_maps:
        save_map(lm.grid, f"{filename}-local-map-{lm.idx}",
                 node_poses=poses[lm.node_idx_min:lm.node_idx_max + 1],
                 node_idx_min=lm.node_idx_min,
                 node_idx_max=lm.node_idx_max)


def save_pyramid_maps(builder: mb.GridMapBuilder, lm, filename: str,
                      height_max: int = 6):
    """One PNG per precomputed coarse level: ``<filename>-<winsize>``
    (MapSaver::SavePrecomputedGridMaps, map_saver.cpp:231-275)."""
    pyr = pyramid.build_pyramid(builder.values_for(lm),
                                height_max).cpu().numpy()
    observed = lm.grid.observed.cpu().numpy()
    origin = lm.grid.origin.cpu().numpy()
    for h in range(pyr.shape[0]):
        win = 1 << h
        img, _, _, _ = render_values(
            pyr[h], observed | (pyr[h] != gridops.UNKNOWN), origin,
            _resolution(lm.grid))
        png.write_png(f"{filename}-{win}.png", img)


def save_pose_graph(graph: PoseGraph, scans: mb.ScanStore, filename: str):
    """Pose-graph JSON with the reference's schema (map_saver.cpp:56-120):
    nodes (index, pose, timestamp) and edges (node indices, relative pose,
    upper-triangular information matrix)."""
    nodes = []
    for i in range(graph.num_nodes):
        scan_id = int(graph.scan_ids[i])
        nodes.append({
            "Index": i,
            "Pose": {"X": float(graph.poses[i, 0]),
                     "Y": float(graph.poses[i, 1]),
                     "Theta": float(graph.poses[i, 2])},
            "TimeStamp": float(scans.timestamps[scan_id])
            if scan_id >= 0 else 0.0,
        })
    edges = []
    for e in range(graph.num_edges):
        info = graph.edge_info[e]
        upper = [float(info[i, j]) for i in range(3) for j in range(i, 3)]
        edges.append({
            "StartNodeIdx": int(graph.edge_i[e]),
            "EndNodeIdx": int(graph.edge_j[e]),
            "RelativePose": {"X": float(graph.edge_rel[e, 0]),
                             "Y": float(graph.edge_rel[e, 1]),
                             "Theta": float(graph.edge_rel[e, 2])},
            "InformationMatrix": upper,
        })
    with open(filename + ".posegraph.json", "w") as f:
        json.dump({"PoseGraph": {"Nodes": nodes, "Edges": edges}}, f,
                  indent=2)


def load_pose_graph(path: str) -> PoseGraph:
    """Load a pose graph saved by :func:`save_pose_graph` (no reference
    equivalent — the reference can only write)."""
    with open(path) as f:
        data = json.load(f)["PoseGraph"]
    graph = PoseGraph()
    for n in data["Nodes"]:
        pose = np.array([n["Pose"]["X"], n["Pose"]["Y"], n["Pose"]["Theta"]])
        graph.append_node(pose, scan_id=-1)
    for e in data["Edges"]:
        upper = e["InformationMatrix"]
        info = np.zeros((3, 3))
        k = 0
        for i in range(3):
            for j in range(i, 3):
                info[i, j] = upper[k]
                info[j, i] = upper[k]
                k += 1
        rel = np.array([e["RelativePose"]["X"], e["RelativePose"]["Y"],
                        e["RelativePose"]["Theta"]])
        graph.append_edge(int(e["StartNodeIdx"]), int(e["EndNodeIdx"]),
                          rel, info)
    return graph


def save_checkpoint(path: str, graph: PoseGraph, scans: mb.ScanStore):
    """Full functional-state checkpoint: pose graph + scan tensors.

    Together these are sufficient to rebuild every grid map (maps are pure
    functions of poses + scans), so resume = load + rebuild.
    """
    n, e, c = graph.num_nodes, graph.num_edges, scans.count
    np.savez_compressed(
        path,
        poses=graph.poses[:n],
        scan_ids=graph.scan_ids[:n],
        edge_i=graph.edge_i[:e],
        edge_j=graph.edge_j[:e],
        edge_rel=graph.edge_rel[:e],
        edge_info=graph.edge_info[:e],
        edge_is_odom=graph.edge_is_odom[:e],
        scan_ranges=scans.ranges[:c],
        scan_angles=scans.angles[:c],
        scan_valid=scans.valid[:c],
        scan_min_range=scans.min_range[:c],
        scan_max_range=scans.max_range[:c],
        scan_rel_pose=scans.rel_sensor_pose[:c],
        scan_raw_beams=scans.raw_beams[:c],
        scan_timestamps=scans.timestamps[:c],
    )


def load_checkpoint(path: str, beam_capacity: int = 1024):
    """Restore (PoseGraph, ScanStore) from a checkpoint."""
    data = np.load(path)
    graph = PoseGraph()
    for i in range(data["poses"].shape[0]):
        graph.append_node(data["poses"][i], int(data["scan_ids"][i]))
    for e in range(data["edge_i"].shape[0]):
        graph.append_edge(int(data["edge_i"][e]), int(data["edge_j"][e]),
                          data["edge_rel"][e], data["edge_info"][e])
    scans = mb.ScanStore(beam_capacity=beam_capacity)
    c = data["scan_ranges"].shape[0]
    nb = data["scan_ranges"].shape[1]
    scans._grow(c)
    scans.ranges[:c, :nb] = data["scan_ranges"]
    scans.angles[:c, :nb] = data["scan_angles"]
    scans.valid[:c, :nb] = data["scan_valid"]
    scans.min_range[:c] = data["scan_min_range"]
    scans.max_range[:c] = data["scan_max_range"]
    scans.rel_sensor_pose[:c] = data["scan_rel_pose"]
    scans.raw_beams[:c] = data["scan_raw_beams"]
    scans.timestamps[:c] = data["scan_timestamps"]
    scans.count = c
    return graph, scans
