"""Multi-process runtime: process-group initialization and global meshes.

Counterpart of ``my_lidar_graph_slam_tpu/parallel/multihost.py``. The
JAX package initializes ``jax.distributed`` and lays a global mesh over
every process's devices; the port initializes a ``torch.distributed``
process group and gives each process its shards of one global
:class:`~my_lidar_graph_slam_tpu_torch.parallel.mesh.Mesh`.

Processes run SPMD: every process runs the whole program on the same
inputs and reaches every collective in the same order with the same
shapes (``mesh.check_same`` raises where they do not). The process group
has a finite timeout, so a rank that waits for a collective no other
rank reaches fails instead of hanging. On the CPU the processes talk over
gloo (``tests/test_torch_multihost.py`` runs two of them with four CPU
shards each, as ``tests/test_multihost.py`` does with JAX); on cards over
NCCL, one card per process (``LOCAL_RANK``), as ``torchrun`` starts them.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from my_lidar_graph_slam_tpu_torch.models.pose_graph import GraphArrays
from my_lidar_graph_slam_tpu_torch.parallel import mesh as mesh_mod
from my_lidar_graph_slam_tpu_torch.parallel.mesh import Mesh, ShardedArray
from my_lidar_graph_slam_tpu_torch.utils import device as device_mod

# Seconds a collective may wait for the other ranks.
DEFAULT_TIMEOUT_S = 600.0


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value is None else int(value)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None,
               backend: Optional[str] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the default ``torch.distributed`` process group.

    Arguments left ``None`` come from what ``torchrun`` sets:
    ``MASTER_ADDR`` and ``MASTER_PORT`` (the coordinator ``host:port``),
    ``WORLD_SIZE`` and ``RANK``; explicit arguments win, as in the JAX
    package. ``device`` (``None`` means ``cuda``) picks the backend, NCCL
    for cards and gloo for the CPU, unless ``backend`` names one (gloo on
    CUDA tensors, for several processes on one card). Under NCCL the
    process takes card ``LOCAL_RANK`` (modulo the card count)."""
    dev = device_mod.resolve(device)
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError(
            "multihost.initialize needs the coordinator address, the number "
            "of processes and this process's id (arguments, or MASTER_ADDR/"
            "MASTER_PORT, WORLD_SIZE and RANK as torchrun sets them)")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(_local_card())
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))


def _local_card() -> int:
    return (_env_int("LOCAL_RANK") or 0) % torch.cuda.device_count()


def global_mesh(axis: str = "shard", device=None,
                shards_per_process: int = 1) -> Mesh:
    """This process's shards of the mesh over every process of the
    default group: ``shards_per_process`` shards each, on card
    ``LOCAL_RANK`` (``device=None``, ``cuda``) or on the CPU. Every
    process must pass the same count."""
    if not dist.is_initialized():
        raise RuntimeError("call multihost.initialize first")
    dev = device_mod.resolve(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", _local_card())
    world, rank = dist.get_world_size(), dist.get_rank()
    mesh = Mesh(devices=[dev] * shards_per_process, axis=axis,
                group=dist.group.WORLD, first_shard=rank * shards_per_process,
                num_shards=world * shards_per_process)
    mesh_mod.check_same(mesh, "global_mesh", shards_per_process)
    return mesh


def host_local_to_global(mesh: Mesh, spec: Optional[str],
                         local_array) -> ShardedArray:
    """A global array from this process's part of it. ``spec`` is the
    mesh axis (``P(axis)`` in the JAX package: ``local_array`` is this
    process's equal slice along axis 0, split here over its shards) or
    ``None`` (``P()``: ``local_array`` is the whole array, the same on
    every process)."""
    x = torch.as_tensor(np.asarray(local_array))
    if spec is None:
        return ShardedArray(mesh, [x.to(d) for d in mesh.devices], None)
    if spec != mesh.axis:
        raise ValueError(f"unknown mesh axis {spec!r}")
    n = len(mesh.devices)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over {n} shards")
    per = x.shape[0] // n
    return ShardedArray(mesh, [x[s * per:(s + 1) * per].to(d)
                               for s, d in enumerate(mesh.devices)], 0)


def fetch_global(tree):
    """Bring a tree of results fully to the host as NumPy: a
    :class:`ShardedArray` split over the mesh is gathered over every
    process (``process_allgather(tiled=True)``), a replicated one read
    from its first shard; tensors are read, NumPy arrays and scalars pass
    through; NamedTuples, lists, tuples and dicts are mapped."""
    if isinstance(tree, ShardedArray):
        if tree.dim is None:
            return tree.shards[0].cpu().numpy()
        dev0 = tree.mesh.devices[0]
        block = torch.cat([s.to(dev0) for s in tree.shards], dim=tree.dim)
        return mesh_mod.gather(tree.mesh, block, tree.dim).cpu().numpy()
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(fetch_global(x) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(fetch_global(x) for x in tree)
    if isinstance(tree, dict):
        return {k: fetch_global(v) for k, v in tree.items()}
    return np.asarray(tree)


def replicate(mesh: Mesh, tree):
    """Every array of ``tree`` (NamedTuples, lists and tuples mapped)
    replicated on every shard."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(replicate(mesh, x) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(mesh, x) for x in tree)
    return host_local_to_global(mesh, None, tree)


def shard_edges_global(mesh: Mesh, axis: str,
                       graph_arrays: GraphArrays) -> GraphArrays:
    """A ``GraphArrays`` snapshot placed for the edge-sharded solver
    (``distributed.optimize_sharded``): poses and node mask replicated,
    the edge arrays split evenly over the global shards. Every process
    passes the FULL snapshot and keeps its own processes' edges; the edge
    capacity must divide by the global shard count."""
    e = np.asarray(graph_arrays.edge_i).shape[0]
    if e % mesh.num_shards:
        raise ValueError(f"edge capacity {e} does not divide by the "
                         f"{mesh.num_shards} shards of the mesh")
    nproc = mesh.num_shards // len(mesh.devices)
    per = e // nproc
    pid = mesh.first_shard // len(mesh.devices)

    def edges(x):
        return host_local_to_global(
            mesh, axis, np.asarray(x)[pid * per:(pid + 1) * per])

    return GraphArrays(
        poses=replicate(mesh, np.asarray(graph_arrays.poses, np.float32)),
        node_mask=replicate(mesh, np.asarray(graph_arrays.node_mask, bool)),
        edge_i=edges(np.asarray(graph_arrays.edge_i, np.int64)),
        edge_j=edges(np.asarray(graph_arrays.edge_j, np.int64)),
        edge_rel=edges(np.asarray(graph_arrays.edge_rel, np.float32)),
        edge_info=edges(np.asarray(graph_arrays.edge_info, np.float32)),
        edge_mask=edges(np.asarray(graph_arrays.edge_mask, bool)))
