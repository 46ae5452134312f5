"""The K3 ray-cast kernel's wrapper (``csrc/raycast.cu``).

:func:`integrate` casts K scans into each of M maps in one launch, in
place, scans in order; ``ops/raycast.py::integrate_scans_stacked`` calls
it for CUDA tensors and keeps its plain PyTorch path for the CPU and as
the yardstick.

No Pallas counterpart: the JAX package casts with XLA's scatter-add.
"""

from __future__ import annotations

import ctypes

import torch

from my_lidar_graph_slam_tpu_torch.ops.cuda import loader
from my_lidar_graph_slam_tpu_torch.utils.metrics import MetricManager

# Misses and hits of a cell in one scan share a 32-bit count, 16 bits each;
# a scan touches a cell at most once per beam for each.
MAX_BEAMS = 0xFFFF


def _need(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(what)


def _check(tensors, shapes):
    """Types, shapes and contiguity first, then one CUDA device: all
    before the library is loaded. ``shapes`` maps a name to its shape."""
    for name, t in tensors.items():
        if t is None:
            continue
        dtype = torch.bool if name in ("observed", "valid", "active") else \
            torch.float32
        _need(t.dtype == dtype, f"{name} must be {dtype}")
        _need(tuple(t.shape) == shapes[name],
              f"{name} must have shape {shapes[name]}")
        _need(t.is_contiguous(), f"{name} must be contiguous")
    devices = {t.device for t in tensors.values() if t is not None}
    _need(len(devices) == 1, "all inputs must be on one device")
    dev = devices.pop()
    _need(dev.type == "cuda", f"the ray-cast kernel runs on CUDA, not {dev}")


def integrate(log_odds, observed, origins, sensor_poses, ranges, angles,
              valid, active, range_min, range_max, lo_miss, lo_hit,
              resolution: float, max_steps: int, lo_max: float) -> None:
    """Cast scan k of every map, for k in order, into ``log_odds``
    f32[M, H, W] and ``observed`` bool[M, H, W] in place, clamping each
    touched cell to ``+-lo_max`` after each scan. ``origins`` f32[M, 2];
    ``sensor_poses`` f32[M, K, 3]; ``ranges``/``angles`` f32 and ``valid``
    bool [M, K, NB]; ``active`` bool[M, K] or None (every row);
    ``range_min``/``range_max`` f32[M, K]; ``lo_miss``/``lo_hit`` 0-d f32.
    Every tensor is contiguous on one CUDA device; anything else raises
    before the library is loaded."""
    _need(log_odds.dim() == 3, "log_odds must be [M, H, W]")
    _need(ranges.dim() == 3, "ranges must be [M, K, NB]")
    m, h, w = log_odds.shape
    _, k, nb = ranges.shape
    _need(nb <= MAX_BEAMS, f"at most {MAX_BEAMS} beams a scan")
    shapes = dict(log_odds=(m, h, w), observed=(m, h, w), origins=(m, 2),
                  sensor_poses=(m, k, 3), ranges=(m, k, nb),
                  angles=(m, k, nb), valid=(m, k, nb), active=(m, k),
                  range_min=(m, k), range_max=(m, k), lo_miss=(), lo_hit=())
    _check(dict(log_odds=log_odds, observed=observed, origins=origins,
                sensor_poses=sensor_poses, ranges=ranges, angles=angles,
                valid=valid, active=active, range_min=range_min,
                range_max=range_max, lo_miss=lo_miss, lo_hit=lo_hit),
           shapes)
    _need(h * w < 2 ** 31, "a map must have fewer than 2^31 cells")
    if m == 0 or k == 0:
        return
    stream = loader.stream_handle(ranges)
    counts = loader.zeroed_scratch("raycast", ranges.device, stream,
                                   m * h * w)
    status = _lib().raycast_f32(
        log_odds.data_ptr(), observed.data_ptr(), origins.data_ptr(),
        sensor_poses.data_ptr(), ranges.data_ptr(), angles.data_ptr(),
        valid.data_ptr(), None if active is None else active.data_ptr(),
        range_min.data_ptr(), range_max.data_ptr(), lo_miss.data_ptr(),
        lo_hit.data_ptr(), m, k, nb, h, w, resolution, max_steps, lo_max,
        counts.data_ptr(), stream)
    loader.check(status, "raycast")
    counters = MetricManager.instance().counters
    counters("RaycastKernelLaunches").increment()
    counters("RaycastKernelScans").increment(m * k)


def _lib():
    lib = loader.library("raycast")
    if lib.raycast_f32.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.raycast_f32.restype = ctypes.c_int
        lib.raycast_f32.argtypes = [p] * 12 + [i] * 5 + [f, i, f, p, p]
    return lib
