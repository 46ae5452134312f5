"""Correlative window scores: the K1 kernel's wrapper and plain version.

Counterpart of ``my_lidar_graph_slam_tpu/ops/scoring.py::window_scores``
(the plain version) and of the Pallas TPU kernel
``my_lidar_graph_slam_tpu/ops/pallas/correlate_mxu.py::window_scores_mxu``
with its wide-window block assembly
(``ops/matchers_mxu.py::window_scores_mxu_wide``), which the CUDA kernel in
``csrc/correlate.cu`` replaces. The kernel takes any window size directly.

``score[q, t, a, b] = sum_b w[q, b] * M[iy[q, t, b] + dy, ix[q, t, b] + dx]``
with ``dx = a - win_x``, ``dy = b - win_y``; off-map cells read the Unknown
sentinel 0 (score_function_pixel_accurate.cpp:51-53), and a zero-weight
beam contributes nothing wherever its cells lie.
"""

from __future__ import annotations

import ctypes

import torch

from my_lidar_graph_slam_tpu_torch.ops.cuda import loader


def _check_inputs(value_map, ix, iy, beam_weight, map_idx):
    if value_map.dtype != torch.float32 or value_map.dim() not in (2, 3):
        raise ValueError("value_map must be float32 [H, W] or [M, H, W]")
    if ix.dtype != torch.int32 or iy.dtype != torch.int32:
        raise ValueError("ix/iy must be int32")
    if ix.dim() != 3 or iy.shape != ix.shape:
        raise ValueError("ix/iy must both be [Q, NT, NB]")
    q, _, nb = ix.shape
    if beam_weight.dtype != torch.float32 or \
            tuple(beam_weight.shape) != (q, nb):
        raise ValueError("beam_weight must be float32 [Q, NB]")
    if (value_map.dim() == 3) != (map_idx is not None):
        raise ValueError("a stacked [M, H, W] map needs map_idx, and "
                         "map_idx needs a stacked map")
    if map_idx is not None and (map_idx.dtype != torch.int32 or
                                tuple(map_idx.shape) != (q,)):
        raise ValueError("map_idx must be int32 [Q]")
    devices = {t.device for t in (value_map, ix, iy, beam_weight)
               if t is not None}
    if map_idx is not None:
        devices.add(map_idx.device)
    if len(devices) != 1:
        raise ValueError("all inputs must be on one device")


def window_scores_plain(value_map, ix, iy, beam_weight, win_x: int,
                        win_y: int, map_idx=None) -> torch.Tensor:
    """Plain PyTorch version: f32[Q, NT, 2*win_x+1, 2*win_y+1].

    Memory is bounded by looping over the dx rows of the window, so a
    41 x 41 window never materialises a [Q, NT, NB, 41, 41] tensor. Off-map
    reads land in a zero ring padded around each map (as in
    ``scoring.window_scores`` of the JAX package).
    """
    _check_inputs(value_map, ix, iy, beam_weight, map_idx)
    maps = value_map if value_map.dim() == 3 else value_map[None]
    _, h, w = maps.shape
    q, nt, nb = ix.shape
    pad_y, pad_x = win_y + 1, win_x + 1
    padded = torch.nn.functional.pad(maps, (pad_x, pad_x, pad_y, pad_y))
    hp, wp = h + 2 * pad_y, w + 2 * pad_x
    flat = padded.reshape(-1)
    base = torch.zeros((q, 1, 1, 1), dtype=torch.int64, device=ix.device)
    if map_idx is not None:
        base = (map_idx.long() * (hp * wp)).reshape(q, 1, 1, 1)

    dy = torch.arange(-win_y, win_y + 1, device=ix.device)
    gy = (iy.long()[..., None] + dy + pad_y).clamp(0, hp - 1)  # [Q,NT,NB,WY]
    wgt = beam_weight[:, None, :, None]
    rows = []
    for dx in range(-win_x, win_x + 1):
        gx = (ix.long()[..., None] + dx + pad_x).clamp(0, wp - 1)
        vals = flat[base + gy * wp + gx]                        # [Q,NT,NB,WY]
        rows.append((vals * wgt).sum(dim=2))                    # [Q,NT,WY]
    return torch.stack(rows, dim=2)                             # [Q,NT,WX,WY]


def window_scores(value_map, ix, iy, beam_weight, win_x: int, win_y: int,
                  map_idx=None) -> torch.Tensor:
    """Window scores. CPU tensors take :func:`window_scores_plain`; CUDA
    tensors launch the kernel in ``csrc/correlate.cu`` (and raise if it
    cannot be built or launched)."""
    if value_map.device.type == "cpu":
        return window_scores_plain(value_map, ix, iy, beam_weight, win_x,
                                   win_y, map_idx)
    _check_inputs(value_map, ix, iy, beam_weight, map_idx)
    if value_map.device.type != "cuda":
        raise ValueError(f"unsupported device {value_map.device}")
    q, nt, nb = ix.shape
    if nt > 65535 or q > 65535:
        raise ValueError("NT and Q must each be at most 65535")
    value_map, ix, iy, beam_weight = (t.contiguous() for t in
                                      (value_map, ix, iy, beam_weight))
    if map_idx is not None:
        map_idx = map_idx.contiguous()
    h, w = value_map.shape[-2:]
    out = torch.empty((q, nt, 2 * win_x + 1, 2 * win_y + 1),
                      dtype=torch.float32, device=ix.device)
    lib = _lib()
    status = lib.window_scores_f32(
        value_map.data_ptr(), h, w, ix.data_ptr(), iy.data_ptr(),
        beam_weight.data_ptr(),
        None if map_idx is None else map_idx.data_ptr(),
        q, nt, nb, win_x, win_y, out.data_ptr(),
        torch.cuda.current_stream(ix.device).cuda_stream)
    loader.check(status, "window_scores")
    window_scores.launches += 1
    return out


window_scores.launches = 0


def _lib():
    lib = loader.library("correlate")
    fn = lib.window_scores_f32
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.restype = ctypes.c_int
        fn.argtypes = [p, i, i, p, p, p, p, i, i, i, i, i, p, p]
    return lib
