"""The least time the card could take for a call of K1 or K2.

Frozen copy of ``chip_smoke.py``'s arithmetic at commit 8e18ecb
(``bound_ms``, ``cells_read`` and the byte and operation counts of
``phase_times``), with ``cells_read`` taking the map's shape instead of
the map: the bytes of the distinct map cells the call reads, plus each
other input and the output once, over the card's memory bandwidth, or
its operations over the float32 rate outside the tensor cores,
whichever is larger. Published peaks of one NVIDIA H100 SXM (NVIDIA's
data sheet, dense, at its 700 W limit).
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound_s(bytes_moved: float, ops: float) -> float:
    return max(bytes_moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def cells_read(shape, device, map_idx, centers) -> int:
    """Distinct in-map cells of a map of ``shape`` ([H, W] or [M, H, W]
    with ``map_idx`` i32[Q]) within rx columns and ry rows of any center.
    ``centers``: list of (ix, iy, keep, rx, ry)."""
    m = 1 if len(shape) == 2 else shape[0]
    h, w = shape[-2:]
    pad = max(max(rx, ry) for *_, rx, ry in centers)
    read = torch.zeros((m, h, w), dtype=torch.bool, device=device)
    for ix, iy, keep, rx, ry in centers:
        hit = torch.zeros((m, h + 2 * pad, w + 2 * pad), dtype=torch.float32,
                          device=device)
        px, py = ix.long() + pad, iy.long() + pad
        ok = keep & (px >= 0) & (px < w + 2 * pad) & (py >= 0) & \
            (py < h + 2 * pad)
        q = ix.shape[0]
        mi = torch.zeros(q, dtype=torch.long, device=ix.device) \
            if map_idx is None else map_idx.long()
        mi = mi.reshape((q,) + (1,) * (ix.dim() - 1)).expand_as(ix)
        hit[mi[ok], py[ok], px[ok]] = 1.0
        near = torch.nn.functional.max_pool2d(
            hit[:, None], (2 * ry + 1, 2 * rx + 1), stride=1,
            padding=(ry, rx))[:, 0]
        read |= near[:, pad:pad + h, pad:pad + w] > 0
    return int(read.sum())


def window_scores_bound_s(args, kwargs) -> float:
    """K1 ``window_scores(value_map, ix, iy, weight, win_x, win_y,
    map_idx)``, the map given by its shape and device: one multiply-add
    per live (query, theta, beam) and window cell; the map cells read, 8
    bytes of cell index per live beam, the weights, ``map_idx`` and the
    output."""
    vm, ix, iy, w, wx, wy, *rest = args
    map_idx = rest[0] if rest else kwargs.get("map_idx")
    q, nt, _ = ix.shape
    live = (w != 0)[:, None, :].expand_as(ix)
    n_live = int(live.sum())
    ops = 2.0 * n_live * (2 * wx + 1) * (2 * wy + 1)
    read = cells_read(vm.shape, vm.device, map_idx,
                      [(ix, iy, live, wx, wy)])
    out_bytes = 4 * q * nt * (2 * wx + 1) * (2 * wy + 1)
    moved = 4 * read + 8 * n_live + nbytes(w, map_idx) + out_bytes
    return bound_s(moved, ops)


def greedy_cost_bound_s(args, kwargs) -> float:
    """K2 ``greedy_cost_core(value_map, cells, mask, table, k, threshold,
    map_idx)``, the map given by its shape and device: per masked beam
    the (2k+3)^2 patches around the base hit and missed cells and the
    (2k+1)^2 kernels of the 4 theta cells, 6 operations a read; the cells
    read, 48 bytes of cells per masked beam, the mask, table, ``map_idx``
    and the [Q, 7] output."""
    vm, cells, mask, table, k, _thr, *rest = args
    map_idx = rest[0] if rest else kwargs.get("map_idx")
    n_masked = int(mask.sum())
    reads = 2 * (2 * k + 3) ** 2 + 4 * (2 * k + 1) ** 2
    ops = n_masked * reads * 6.0
    read = cells_read(vm.shape, vm.device, map_idx, [
        (cells[:, j, 0], cells[:, j + 1, 0], mask, k + 1, k + 1)
        for j in (0, 2)] + [
        (cells[:, j, a], cells[:, j + 1, a], mask, k, k)
        for a in (1, 2) for j in (0, 2)])
    moved = 4 * read + 4 * 12 * n_masked + nbytes(mask, table, map_idx) + \
        4 * cells.shape[0] * 7
    return bound_s(moved, ops)
