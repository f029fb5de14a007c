"""The counts behind the roofline shares and the step's share of the peak,
against hand counts on a scene of a few Gaussians and one tile."""

from __future__ import annotations

import pytest
import torch

from benchmark import counts
from benchmark.reference import raster


def one_tile(opacities, conic=(1e-6, 0.0, 1e-6)):
    """Gaussians centred on a 16 x 16 image, all in its one tile, front to
    back in the given order."""
    n = len(opacities)
    rows = torch.zeros((n, 9))
    rows[:, 0:2] = 8.0
    rows[:, 2:5] = torch.tensor(conic)
    rows[:, 5:8] = 0.5
    rows[:, 8] = torch.tensor(opacities)
    return rows, torch.arange(n), torch.tensor([0, n]), 1, 1


@pytest.mark.parametrize("opacities,visited,contributing", [
    ([0.5], 256, 256),
    # T after k entries of alpha 0.95 is 0.05^k: the third leaves 1.25e-4,
    # the fourth would leave 6.25e-6 < 1e-4, so it is visited, stops the
    # pixel and contributes nothing; the fifth is not visited.
    ([0.95] * 5, 4 * 256, 3 * 256),
    # Under 1/255 everywhere: visited, never contributing.
    ([0.003, 0.5], 2 * 256, 256),
])
def test_pair_counts_by_hand(opacities, visited, contributing):
    rows, gid, starts, ntx, nty = one_tile(opacities)
    color, alpha, v, c = raster.blend(rows, gid, starts, ntx, nty, 16, 16)
    assert (v, c) == (visited, contributing)
    assert color.shape == (16, 16, 3) and float(alpha.max()) <= 1.0


def test_pixels_past_the_image_visit_nothing():
    rows, gid, starts, ntx, nty = one_tile([0.5, 0.5])
    _, _, v, c = raster.blend(rows, gid, starts, ntx, nty, 10, 16)
    assert (v, c) == (2 * 160, 2 * 160)


def test_blend_bound_by_hand():
    # forward: 16 * 1000 + 15 * 600 = 25,000 flops; bytes 4 (3 * 11 + 5 + 2)
    # + 4 * 5 * 256 = 5,280.
    fwd = counts.blend_bound("forward", visited=1000, contributing=600, rows=3, entries=5, n_tiles=1)
    assert fwd == pytest.approx(max(25_000 / 67e12, 5_280 / 3.35e12))
    # backward: 16 * 1000 + 55 * 600 = 49,000; bytes 160 + 4 (6 * 256 + 5 * 10) = 6,504.
    bwd = counts.blend_bound("backward", visited=1000, contributing=600, rows=3, entries=5, n_tiles=1)
    assert bwd == pytest.approx(max(49_000 / 67e12, 6_504 / 3.35e12))


def test_bound_is_by_operations_when_pairs_dominate():
    pairs = 10**9
    t = counts.blend_bound("forward", pairs, pairs, rows=1000, entries=10**6, n_tiles=3888)
    assert t == pytest.approx(31 * pairs / counts.PEAK_F32_FLOPS)


def test_step_flops_by_hand():
    # 2 Gaussians at SH 3: (231 + 140) * 3 + 12 * 59 = 1,821 each; blends
    # 2 * 16 * 10 + 70 * 4 = 600; 5 pixels * 738 * 3 = 11,070.
    assert counts.step_flops(2, 3, 10, 4, 5) == 2 * 1821 + 600 + 11_070
