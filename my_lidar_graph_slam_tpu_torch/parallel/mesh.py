"""Meshes of shards and their collectives.

Counterpart of ``my_lidar_graph_slam_tpu/parallel/mesh.py``. JAX lays its
sharded programs over a ``jax.sharding.Mesh`` of devices; PyTorch has no
such object, and no way to fake N devices in one process as the JAX
tests do (``tests/conftest.py``). The port's :class:`Mesh` is a list of
SHARDS held by this process, each on a ``torch.device`` (a device may
repeat: four shards on one card, eight on the CPU), plus, when the mesh
spans processes, the ``torch.distributed`` process group that joins them.
Every process holds the same number of shards, in global order from
``first_shard``.

A sharded function runs its per-shard work in a Python loop over the
local shards and meets the other shards only in the collectives below:

 * :func:`psum` (``jax.lax.psum``): the local partials are summed on the
   first local device in shard order, then one ``all_reduce`` sums over
   processes; every shard gets the total on its own device;
 * :func:`gather` (``process_allgather(tiled=True)``): this process's
   block, all-gathered over processes in global shard order;
 * :func:`agree`: host-side loop decisions, all-reduced with MAX so that
   every rank leaves a loop at the same step;
 * :func:`check_same`: a fingerprint of the call (node count, edge
   capacity, ...) all-reduced with MIN and MAX before each sharded call;
   ranks that disagree raise instead of waiting in a collective.

Under gloo the collectives run on host copies (gloo reduces host
tensors); under NCCL on the tensors' own cards. ``psum_calls`` and
``psum_bytes`` count every :func:`psum` and the bytes it reduces.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from my_lidar_graph_slam_tpu_torch.utils import device as device_mod


@dataclasses.dataclass(eq=False)
class Mesh:
    """This process's shards of a 1-D mesh (see the module docstring).

    ``group`` is ``None`` when the mesh lies in one process.
    ``num_shards`` is the global shard count (``len(devices)`` in one
    process); ``shape`` reads ``{axis: num_shards}`` as JAX's does."""

    devices: Sequence[torch.device]
    axis: str = "shard"
    group: Optional[object] = None
    first_shard: int = 0
    num_shards: int = 0
    psum_calls: int = 0
    psum_bytes: int = 0

    def __post_init__(self):
        self.devices = tuple(torch.device(d) for d in self.devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
        if not self.num_shards:
            self.num_shards = len(self.devices)
        if self.group is None and self.num_shards != len(self.devices):
            raise ValueError("a one-process mesh holds all of its shards")

    @property
    def shape(self) -> dict:
        return {self.axis: self.num_shards}

    @property
    def local_shards(self) -> range:
        """Global indices of this process's shards."""
        return range(self.first_shard, self.first_shard + len(self.devices))


@dataclasses.dataclass(eq=False)
class ShardedArray:
    """A global array over ``mesh``: one tensor per local shard. ``dim``
    is the axis split over the global shards (each shard holds an equal
    block, in global shard order), or ``None`` when every shard holds the
    whole array (replicated)."""

    mesh: Mesh
    shards: List[torch.Tensor]
    dim: Optional[int] = 0


def make_mesh(n_devices: Optional[int] = None, axis: str = "shard",
              device=None) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` devices, in this process.

    On ``cuda`` (``device=None``) the shards are the first ``n`` cards
    (all of them when ``n_devices`` is None) and asking for more cards
    than there are raises ``ValueError``, as JAX does. On ``cpu`` they are
    ``n`` shards of the CPU (one when ``n_devices`` is None), the
    counterpart of the JAX tests' forced host device count."""
    dev = device_mod.resolve(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        n = n_devices or count
        if n > count:
            raise ValueError(f"requested {n} devices, only {count} available")
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        n = n_devices or 1
        devices = [dev] * n
    return Mesh(devices=devices, axis=axis)


def _backend(mesh: Mesh) -> str:
    return dist.get_backend(mesh.group)


def _all_reduce(mesh: Mesh, tensor: torch.Tensor, op) -> torch.Tensor:
    """``tensor`` all-reduced over the mesh's processes (a new tensor on
    ``tensor``'s device)."""
    if _backend(mesh) == "gloo":
        host = tensor.cpu().clone()
        dist.all_reduce(host, op=op, group=mesh.group)
        return host.to(tensor.device)
    out = tensor.clone()
    dist.all_reduce(out, op=op, group=mesh.group)
    return out


def psum(mesh: Mesh, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Sum of one partial per local shard over every shard of the mesh,
    returned on each local shard's device (``jax.lax.psum``). Shards on
    one device share the result tensor: callers do not modify it in
    place."""
    if len(parts) != len(mesh.devices):
        raise ValueError("psum takes one partial per local shard")
    dev0 = mesh.devices[0]
    total = parts[0].to(dev0)
    for p in parts[1:]:
        total = total + p.to(dev0)
    if mesh.group is not None:
        total = _all_reduce(mesh, total, dist.ReduceOp.SUM)
    mesh.psum_calls += 1
    mesh.psum_bytes += total.numel() * total.element_size()
    return [total.to(d) for d in mesh.devices]


def gather(mesh: Mesh, block: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This process's ``block`` concatenated along ``dim`` with every
    other process's, in process (= global shard) order. Every process
    passes a block of the same shape."""
    if mesh.group is None:
        return block
    src = block.cpu() if _backend(mesh) == "gloo" else block
    src = src.contiguous()
    out = [torch.empty_like(src)
           for _ in range(dist.get_world_size(mesh.group))]
    dist.all_gather(out, src, group=mesh.group)
    return torch.cat(out, dim=dim)


def agree(mesh: Mesh, values: Sequence[int]) -> List[int]:
    """The largest of each host value over the mesh's processes, so that
    a loop that continues while any flag is set stops at the same step on
    every rank (all-reduced results are equal on every rank, but this
    makes the decision itself a collective)."""
    values = [int(v) for v in values]
    if mesh.group is None:
        return values
    t = torch.tensor(values, dtype=torch.int64, device=mesh.devices[0])
    return _all_reduce(mesh, t, dist.ReduceOp.MAX).tolist()


def check_same(mesh: Mesh, what: str, *values: int) -> None:
    """Raise unless every process calls ``what`` with the same integers
    (a fingerprint of its shapes). One MIN and one MAX all-reduce; on a
    mismatch an all-gather names the ranks."""
    if mesh.group is None:
        return
    t = torch.tensor([int(v) for v in values], dtype=torch.int64,
                     device=mesh.devices[0])
    lo = _all_reduce(mesh, t, dist.ReduceOp.MIN)
    hi = _all_reduce(mesh, t, dist.ReduceOp.MAX)
    if torch.equal(lo, hi):
        return
    every = gather(mesh, t[None]).tolist()
    ranks = {r: v for r, v in enumerate(every)}
    raise RuntimeError(f"{what}: the ranks disagree on {ranks} "
                       "(rank: fingerprint); every rank must make the same "
                       "sharded calls with the same shapes")
