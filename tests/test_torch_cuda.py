"""The port's CUDA kernels against their plain versions, on a card.

Marked ``cuda``: on a machine without a card (or without ``nvcc``) each
test skips from inside. Run on the card with
``python -m pytest --noconftest tests/test_torch_cuda.py`` (the suite's
conftest imports JAX, which that machine need not have).
"""

import os
import shutil

import pytest
import torch

from my_lidar_graph_slam_tpu_torch.ops.cuda import correlate, greedy_cost

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if shutil.which("nvcc") is None and \
            not os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("no nvcc to build the kernels")
    return torch.device("cuda")


def _cells(gen, q, nt, nb, h, w):
    bx = torch.randint(8, w - 8, (q, 1, nb), generator=gen)
    by = torch.randint(8, h - 8, (q, 1, nb), generator=gen)
    ix = bx + torch.randint(-1, 2, (q, nt, nb), generator=gen).cumsum(1)
    iy = by + torch.randint(-1, 2, (q, nt, nb), generator=gen).cumsum(1)
    return ix.int(), iy.int()


@pytest.mark.parametrize("win", [1, 2, 7])
def test_window_scores_kernel_matches_plain(dev, win):
    gen = torch.Generator().manual_seed(win)
    h, w, q, nt, nb = 120, 140, 3, 17, 70
    vm = torch.rand((2, h, w), generator=gen)
    ix, iy = _cells(gen, q, nt, nb, h, w)
    ix[:, :, ::7] = 2_000_000_000          # far off, weight 0
    wgt = torch.rand((q, nb), generator=gen)
    wgt[:, ::7] = 0.0
    midx = torch.tensor([1, 0, 1], dtype=torch.int32)
    args = (vm, ix, iy, wgt, win, win, midx)
    ref = correlate.window_scores_plain(*args)
    before = correlate.window_scores.launches
    got = correlate.window_scores(*(a.to(dev) if torch.is_tensor(a) else a
                                    for a in args))
    torch.cuda.synchronize()
    assert correlate.window_scores.launches == before + 1
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("kernel_size", [1, 2])
def test_greedy_cost_kernel_matches_plain(dev, kernel_size):
    gen = torch.Generator().manual_seed(kernel_size)
    occ = (torch.rand((200, 200), generator=gen) < 0.2).float()
    vm = torch.where(occ > 0, torch.full_like(occ, 0.8),
                     torch.full_like(occ, 0.05))
    q, nb = 5, 90
    origin = torch.tensor([-5.0, -5.0])
    poses = torch.stack([torch.rand(q, generator=gen) * 4 - 2,
                         torch.rand(q, generator=gen) * 4 - 2,
                         torch.rand(q, generator=gen) * 6 - 3], 1)
    ranges = 0.3 + 6.0 * torch.rand((q, nb), generator=gen)
    angles = torch.linspace(-1.5, 1.5, nb).expand(q, nb).contiguous()
    mask = torch.rand((q, nb), generator=gen) < 0.9
    # Both versions on the card: the cell preparation (cos, sin, floor) is
    # shared PyTorch code, and the CPU's and the card's last bits differ.
    args = [a.to(dev) if torch.is_tensor(a) else a
            for a in (vm, origin, poses, ranges, angles, mask, 0.05)]
    ref = greedy_cost.greedy_cost_cov_plain(*args, kernel_size=kernel_size)
    before = greedy_cost.greedy_cost_core.launches
    got = greedy_cost.greedy_cost_cov(*args, kernel_size=kernel_size)
    torch.cuda.synchronize()
    assert greedy_cost.greedy_cost_core.launches == before + 1
    # Both versions sum exact per-class counts in one order: equal bits.
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=1e-4)
    torch.testing.assert_close(got[1], ref[1], rtol=1e-4, atol=1e-8)


# --------------------------------------------------------------------------
# Edge cases of the kernels' launch geometry (beam records staged in shared
# memory, beam splits, row groups, the last-block epilogue of K2).
# --------------------------------------------------------------------------

K1_RTOL, K1_ATOL = 1e-5, 1e-3


def _k1_case(case, gen):
    """(value_map, ix, iy, weight, win_x, win_y, map_idx) on the CPU."""
    h, w = 300, 340
    q, nt, nb, win_x, win_y, midx = 2, 17, 384, 2, 2, None
    if case == "nb1024_detection_window":
        q, nt, nb, win_x, win_y = 2, 9, 1024, 20, 20
    elif case == "nb1500_two_chunks":
        nb = 1500
    elif case == "nt_odd_201":
        q, nt = 1, 201
    elif case == "nt_1":
        nt = 1
    elif case == "non_square_window":
        win_x, win_y = 3, 10
    elif case == "wide_window_many_passes":
        q, nt, nb, win_x, win_y = 1, 3, 64, 40, 30
    elif case == "map_idx_two_maps":
        q = 4
        midx = torch.tensor([1, 0, 0, 1], dtype=torch.int32)
    elif case.endswith("detection_window"):
        # The default config's 41 x 41 loop-detection window.
        q, nt, win_x, win_y = 2, 9, 20, 20
        if case == "map_idx_detection_window":
            q = 4
            midx = torch.tensor([1, 0, 0, 1], dtype=torch.int32)
    vm = torch.rand((2, h, w) if midx is not None else (h, w), generator=gen)
    ix, iy = _cells(gen, q, nt, nb, h, w)
    # Interior windows, some touching an edge of the map.
    ix = ix.clamp(win_x, w - win_x - 1)
    iy = iy.clamp(win_y, h - win_y - 1)
    wgt = (torch.rand((q, nb), generator=gen) < 0.5).float() * \
        torch.rand((q, nb), generator=gen)
    if case == "all_weights_zero":
        wgt.zero_()
    elif case == "live_not_multiple_of_split":
        wgt.zero_()
        wgt[:, torch.randperm(nb, generator=gen)[:13]] = 1.0
    elif case.startswith(("all_border", "interior_and_border")):
        # Cells within the window of an edge: every window crosses it.
        edge = torch.tensor([-win_x, 0, w - 1, w - 1 + win_x])
        pick = torch.randint(0, 4, (q, nt, nb), generator=gen)
        bx = edge[pick]
        if case.startswith("interior_and_border"):
            half = torch.rand((q, 1, nb), generator=gen) < 0.5
            bx = torch.where(half.expand_as(bx), ix.long(), bx)
        ix = bx.int()
        # Some beams wholly off the map, alive: they must add nothing.
        ix[:, :, ::11] = w + win_x + 5
    return vm, ix, iy, wgt, win_x, win_y, midx


K1_CASES = ["nb384_frontend_window", "nb1024_detection_window",
            "nb1500_two_chunks", "nt_odd_201", "nt_1", "non_square_window",
            "wide_window_many_passes", "map_idx_two_maps",
            "all_weights_zero", "live_not_multiple_of_split", "all_border",
            "interior_and_border", "all_border_detection_window",
            "interior_and_border_detection_window",
            "map_idx_detection_window"]


@pytest.mark.parametrize("case", K1_CASES)
def test_window_scores_kernel_edge_cases(dev, case):
    gen = torch.Generator().manual_seed(K1_CASES.index(case))
    args = [a.to(dev) if torch.is_tensor(a) else a
            for a in _k1_case(case, gen)]
    ref = correlate.window_scores_plain(*args)
    got = correlate.window_scores(*args)
    again = correlate.window_scores(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again), "two launches differ"
    if case == "all_weights_zero":
        assert bool((got == 0).all())
    torch.testing.assert_close(got, ref, rtol=K1_RTOL, atol=K1_ATOL)
    # First-maximum argmax equal wherever the top two are separated.
    flat_g = got.reshape(got.shape[0] * got.shape[1], -1)
    flat_r = ref.reshape(flat_g.shape)
    if flat_r.shape[1] > 1:
        top2 = flat_r.topk(2, dim=1).values
        clear = (top2[:, 0] - top2[:, 1]) > K1_ATOL
        same = flat_g.argmax(1) == flat_r.argmax(1)
        assert bool((same | ~clear).all())


@pytest.mark.parametrize("kernel_size,q", [(1, 1), (1, 8), (2, 1), (2, 8),
                                           (3, 1), (3, 8)])
def test_greedy_cost_core_bit_equal_and_self_clearing(dev, kernel_size, q):
    """The core equals the plain version bit for bit at kernel_size 1 and 2
    (compile-time bodies) and 3 (the run-time body), and two calls in a
    row give the same bits, so the kernel's scratch clears itself."""
    gen = torch.Generator().manual_seed(10 * kernel_size + q)
    occ = (torch.rand((260, 260), generator=gen) < 0.2).float()
    vm = torch.where(occ > 0, torch.full_like(occ, 0.8),
                     torch.full_like(occ, 0.05)).to(dev)
    nb = 384
    origin = torch.tensor([-6.5, -6.5], device=dev)
    poses = torch.stack([torch.rand(q, generator=gen) * 4 - 2,
                         torch.rand(q, generator=gen) * 4 - 2,
                         torch.rand(q, generator=gen) * 6 - 3], 1).to(dev)
    ranges = (0.3 + 8.0 * torch.rand((q, nb), generator=gen)).to(dev)
    angles = torch.linspace(-1.6, 1.6, nb).expand(q, nb).contiguous().to(dev)
    mask = (torch.rand((q, nb), generator=gen) < 0.6).to(dev)
    cells = greedy_cost.prepare_cells(origin, poses, ranges, angles, 0.05,
                                      0.075)
    table = greedy_cost.class_table(0.05, kernel_size, 0.05, dev)
    args = (vm, cells, mask, table, kernel_size, 0.1)
    ref = greedy_cost.greedy_cost_core_plain(*args)
    got = greedy_cost.greedy_cost_core(*args)
    again = greedy_cost.greedy_cost_core(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert torch.equal(again, got)
