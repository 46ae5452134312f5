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
