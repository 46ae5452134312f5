"""Hand state built elsewhere to the port's objects, as NumPy arrays.

This system has no weights: its state is maps, the pose graph and the
scans. These functions build the port's objects from plain arrays, such as
the fields of the JAX package's ``GridMap``, ``PoseGraph``, ``ScanStore``
and ``LocalMap`` read back with ``numpy.asarray``, so the port can be run
on exactly the state another implementation built. Nothing here imports
that implementation.
"""

from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np
import torch

from my_lidar_graph_slam_tpu_torch.models import map_builder as mb
from my_lidar_graph_slam_tpu_torch.models.pose_graph import PoseGraph
from my_lidar_graph_slam_tpu_torch.ops import grid as gridops
from my_lidar_graph_slam_tpu_torch.utils import device as device_mod


def grid_from_numpy(log_odds, observed, origin, resolution,
                    device=None) -> gridops.GridMap:
    """GridMap from f32[H, W] log-odds, bool[H, W] observed, f32[2]
    origin and the cell size, on ``device`` (``None`` means ``cuda``)."""
    device = device_mod.resolve(device)
    return gridops.GridMap(
        log_odds=torch.tensor(np.asarray(log_odds, np.float32),
                              device=device),
        observed=torch.tensor(np.asarray(observed, bool), device=device),
        origin=torch.tensor(np.asarray(origin, np.float32), device=device),
        resolution=float(resolution))


def pose_graph_from_arrays(poses, scan_ids, edge_i, edge_j, edge_rel,
                           edge_info) -> PoseGraph:
    """PoseGraph holding ``len(poses)`` nodes and ``len(edge_i)`` edges
    (odometric iff j == i + 1, as ``append_edge`` decides)."""
    graph = PoseGraph()
    for pose, sid in zip(np.asarray(poses, np.float64),
                         np.asarray(scan_ids)):
        graph.append_node(pose, int(sid))
    for i, j, rel, info in zip(np.asarray(edge_i), np.asarray(edge_j),
                               np.asarray(edge_rel, np.float64),
                               np.asarray(edge_info, np.float64)):
        graph.append_edge(int(i), int(j), rel, info)
    return graph


def scan_store_from_arrays(ranges, angles, valid, min_range, max_range,
                           rel_sensor_pose, raw_beams,
                           timestamps) -> mb.ScanStore:
    """ScanStore holding the N scans given as [N, B] beam arrays and [N]
    or [N, 3] per-scan arrays (B is the beam capacity)."""
    ranges = np.asarray(ranges, np.float32)
    n, cap = ranges.shape
    store = mb.ScanStore(beam_capacity=cap)
    store._grow(n)
    store.ranges[:n] = ranges
    store.angles[:n] = np.asarray(angles, np.float32)
    store.valid[:n] = np.asarray(valid, bool)
    store.min_range[:n] = np.asarray(min_range, np.float32)
    store.max_range[:n] = np.asarray(max_range, np.float32)
    store.rel_sensor_pose[:n] = np.asarray(rel_sensor_pose, np.float32)
    store.raw_beams[:n] = np.asarray(raw_beams, np.int32)
    store.timestamps[:n] = np.asarray(timestamps, np.float64)
    store.count = n
    return store


def set_local_maps(builder: mb.GridMapBuilder,
                   maps: Iterable[Mapping], accum_travel_dist: float = 0.0
                   ) -> mb.GridMapBuilder:
    """Replace ``builder``'s local maps with ``maps``, each a mapping with
    ``log_odds``, ``observed``, ``origin``, ``node_idx_min``,
    ``node_idx_max``, ``finished`` and optionally ``built_poses``, on the
    builder's device; set its accumulated travel distance. Returns the
    builder."""
    res = builder.config.resolution
    builder.local_maps = []
    for i, m in enumerate(maps):
        origin = np.asarray(m["origin"], np.float32)
        built = m.get("built_poses")
        builder.local_maps.append(mb.LocalMap(
            idx=i,
            grid=grid_from_numpy(m["log_odds"], m["observed"], origin, res,
                                 builder.device),
            node_idx_min=int(m["node_idx_min"]),
            node_idx_max=int(m["node_idx_max"]),
            finished=bool(m["finished"]),
            built_poses=None if built is None else
            np.asarray(built, np.float64).copy(),
            origin=origin.copy()))
    builder.accum_travel_dist = float(accum_travel_dist)
    return builder
