"""Pose graph: functional state with host-side growable storage.

Copy of ``my_lidar_graph_slam_tpu/models/pose_graph.py`` (NumPy only).

Replaces the reference's append-only node/edge object lists behind a mutex
(pose_graph.hpp:73-234) with capacity-padded NumPy arrays: "taking a
snapshot" for the backend (lidar_graph_slam.cpp:52-65) is a free array view,
and the optimizer consumes the arrays directly as a pytree.

Poses are float64 on the host (matching the reference's double bookkeeping);
device programs cast to float32.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np


class GraphArrays(NamedTuple):
    """Padded snapshot for device programs."""

    poses: np.ndarray        # f32[N_cap, 3]
    node_mask: np.ndarray    # bool[N_cap]
    edge_i: np.ndarray       # i32[E_cap]
    edge_j: np.ndarray       # i32[E_cap]
    edge_rel: np.ndarray     # f32[E_cap, 3]
    edge_info: np.ndarray    # f32[E_cap, 3, 3]
    edge_mask: np.ndarray    # bool[E_cap]

    @property
    def num_nodes(self) -> int:
        return int(self.node_mask.sum())


def _round_capacity(n: int, minimum: int = 64) -> int:
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


@dataclasses.dataclass
class PoseGraph:
    """Append-only pose graph (pose_graph.hpp:73-234).

    ``scan_ids[i]`` holds the index of the scan associated with node ``i``
    (the scan tensors themselves live in the scan store of the map builder).
    """

    num_nodes: int = 0
    num_edges: int = 0

    def __post_init__(self):
        cap = 64
        self.poses = np.zeros((cap, 3), np.float64)
        self.scan_ids = np.full((cap,), -1, np.int64)
        ecap = 64
        self.edge_i = np.zeros((ecap,), np.int32)
        self.edge_j = np.zeros((ecap,), np.int32)
        self.edge_rel = np.zeros((ecap, 3), np.float64)
        self.edge_info = np.zeros((ecap, 3, 3), np.float64)
        self.edge_is_odom = np.zeros((ecap,), bool)

    # -- capacity management -------------------------------------------------

    def _grow_nodes(self, need: int):
        if need <= self.poses.shape[0]:
            return
        cap = _round_capacity(need)
        self.poses = np.resize(self.poses, (cap, 3))
        self.scan_ids = np.resize(self.scan_ids, (cap,))

    def _grow_edges(self, need: int):
        if need <= self.edge_i.shape[0]:
            return
        cap = _round_capacity(need)
        self.edge_i = np.resize(self.edge_i, (cap,))
        self.edge_j = np.resize(self.edge_j, (cap,))
        self.edge_rel = np.resize(self.edge_rel, (cap, 3))
        self.edge_info = np.resize(self.edge_info, (cap, 3, 3))
        self.edge_is_odom = np.resize(self.edge_is_odom, (cap,))

    # -- mutation ------------------------------------------------------------

    def append_node(self, pose: np.ndarray, scan_id: int) -> int:
        """Append a node; returns its index (pose_graph.cpp AppendNode)."""
        idx = self.num_nodes
        self._grow_nodes(idx + 1)
        self.poses[idx] = pose
        self.scan_ids[idx] = scan_id
        self.num_nodes += 1
        return idx

    def append_edge(self, i: int, j: int, rel_pose: np.ndarray,
                    info: np.ndarray) -> int:
        """Append an edge; odometric iff j == i + 1
        (pose_graph.hpp:165-169)."""
        idx = self.num_edges
        self._grow_edges(idx + 1)
        self.edge_i[idx] = i
        self.edge_j[idx] = j
        self.edge_rel[idx] = rel_pose
        self.edge_info[idx] = info
        self.edge_is_odom[idx] = (j == i + 1)
        self.num_edges += 1
        return idx

    # -- access --------------------------------------------------------------

    def latest_pose(self) -> np.ndarray:
        assert self.num_nodes > 0
        return self.poses[self.num_nodes - 1].copy()

    def node_poses(self) -> np.ndarray:
        return self.poses[:self.num_nodes]

    def snapshot(self, node_cap: Optional[int] = None,
                 edge_cap: Optional[int] = None) -> GraphArrays:
        """Padded float32 arrays for the device optimizer."""
        n, e = self.num_nodes, self.num_edges
        ncap = node_cap or _round_capacity(n)
        ecap = edge_cap or _round_capacity(e)
        poses = np.zeros((ncap, 3), np.float32)
        poses[:n] = self.poses[:n]
        node_mask = np.zeros((ncap,), bool)
        node_mask[:n] = True
        ei = np.zeros((ecap,), np.int32)
        ej = np.zeros((ecap,), np.int32)
        er = np.zeros((ecap, 3), np.float32)
        # Padded edges self-loop on node 0 with zero information: no-ops.
        einfo = np.zeros((ecap, 3, 3), np.float32)
        emask = np.zeros((ecap,), bool)
        ei[:e] = self.edge_i[:e]
        ej[:e] = self.edge_j[:e]
        er[:e] = self.edge_rel[:e]
        einfo[:e] = self.edge_info[:e]
        emask[:e] = True
        return GraphArrays(poses, node_mask, ei, ej, er, einfo, emask)

    def write_back_poses(self, poses: np.ndarray, count: int):
        """Overwrite the first ``count`` node poses (AfterLoopClosure path,
        lidar_graph_slam.cpp:326-332)."""
        self.poses[:count] = poses[:count]
