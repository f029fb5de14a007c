"""Ragged tile binning against dogs_tpu's static-shape build_tile_bins.

The JAX binning keeps a sentinel tail and sorts with lax.sort, which is not
stable; the port sorts exactly the valid entries with a stable sort. So per
tile the two hold the same id set, and the same order wherever the packed
(tile, quantized depth) keys are distinct. The stable sort's permutation is
also what the gradient reduce reads each Gaussian's entries through.
"""

import numpy as np
import pytest
import torch

from dogs_tpu.core.camera import look_at_camera as j_look_at
from dogs_tpu.raster.binning import build_tile_bins as j_bins
from dogs_tpu.raster.projection import project_gaussians as j_project
from dogs_tpu_torch.core import look_at_camera, params_from_numpy
from dogs_tpu_torch.data import synthetic
from dogs_tpu_torch.raster.binning import build_tile_bins, depth_bits_for
from dogs_tpu_torch.raster.projection import project_gaussians
from dogs_tpu_torch.raster.reduce import gaussian_runs
from tests.test_torch_core import jax_params


def compare_bins(arrays, view, mt, culling=True, deg=2):
    h, w = view["height"], view["width"]
    jp = j_project(jax_params(arrays), j_look_at(**view), active_sh_degree=deg)
    jb = j_bins(jp, h, w, max_tiles_per_gaussian=mt, tile_culling=culling)
    tp = project_gaussians(params_from_numpy(arrays, "cpu"), look_at_camera(**view, device="cpu"),
                           active_sh_degree=deg)
    tb = build_tile_bins(tp, h, w, max_tiles_per_gaussian=mt, tile_culling=culling)

    starts = np.asarray(jb.tile_starts)
    np.testing.assert_array_equal(tb.tile_starts.numpy(), starts)
    assert tb.num_valid == int(jb.num_valid) == starts[-1]
    assert tb.num_truncated == int(jb.num_truncated)

    n_tiles = starts.shape[0] - 1
    depth_bits = depth_bits_for(n_tiles)
    dq = np.maximum(np.asarray(jp.depth), 1e-12).view(np.int32) >> (31 - depth_bits)
    j_idx = np.asarray(jb.sorted_idx)[: tb.num_valid]
    t_idx = tb.sorted_idx.numpy()
    np.testing.assert_array_equal(tb.sorted_tile.numpy(), np.asarray(jb.sorted_tile)[: tb.num_valid])
    for t in range(n_tiles):
        a, b = j_idx[starts[t] : starts[t + 1]], t_idx[starts[t] : starts[t + 1]]
        assert sorted(a.tolist()) == sorted(b.tolist()), t
        keys = dq[b]
        distinct = np.ones(len(b), bool)
        distinct[1:] &= keys[1:] != keys[:-1]
        distinct[:-1] &= keys[:-1] != keys[1:]
        np.testing.assert_array_equal(a[distinct], b[distinct])
        assert (np.diff(keys) >= 0).all()
    return tb


@pytest.mark.parametrize("seed", [0, 3])
def test_binning_matches_flat_budget(seed):
    tb = compare_bins(synthetic.random_scene_arrays(seed=seed), synthetic.RANDOM_SCENE_VIEW, mt=36)
    assert tb.num_valid > 0


def test_binning_rect_truncation_matches():
    tb = compare_bins(synthetic.random_scene_arrays(seed=1), synthetic.RANDOM_SCENE_VIEW, mt=4)
    assert tb.num_truncated > 0


def test_binning_without_culling_matches():
    compare_bins(synthetic.random_scene_arrays(seed=2), synthetic.RANDOM_SCENE_VIEW, mt=36,
                 culling=False)


def test_binning_saturation_scene_ties():
    """Dense overlapping stack: many equal quantized keys per tile."""
    compare_bins(synthetic.saturation_scene_arrays(), synthetic.SATURATION_SCENE_VIEW, mt=36, deg=1)


@pytest.mark.parametrize(
    "arrays, view, mt, culling, deg",
    [
        (lambda: synthetic.random_scene_arrays(seed=0), synthetic.RANDOM_SCENE_VIEW, 36, True, 2),
        (lambda: synthetic.random_scene_arrays(seed=1), synthetic.RANDOM_SCENE_VIEW, 4, True, 2),
        (lambda: synthetic.random_scene_arrays(seed=2), synthetic.RANDOM_SCENE_VIEW, 36, False, 2),
        (synthetic.saturation_scene_arrays, synthetic.SATURATION_SCENE_VIEW, 36, True, 1),
    ],
    ids=["random", "truncated", "no_culling", "saturation_ties"],
)
def test_key_order_groups_each_gaussian_in_tile_order(arrays, view, mt, culling, deg):
    """The inverse of the key sort's permutation lists each Gaussian's
    entries as one run of ascending sorted positions: the runs a stable sort
    of sorted_idx gives, which the gradient reduce reads without sorting."""
    params = params_from_numpy(arrays(), "cpu")
    proj = project_gaussians(params, look_at_camera(**view, device="cpu"), active_sh_degree=deg)
    bins = build_tile_bins(proj, view["height"], view["width"], max_tiles_per_gaussian=mt,
                           tile_culling=culling)
    n = params.capacity
    src, starts = gaussian_runs(bins.order, bins.sorted_idx, n)
    assert bins.num_valid > n
    assert starts[0] == 0 and starts[-1] == bins.num_valid
    idx = bins.sorted_idx.numpy()
    src_np, starts_np = src.numpy(), starts.numpy()
    for g in range(n):
        run = src_np[starts_np[g] : starts_np[g + 1]]
        assert (idx[run] == g).all(), g
        assert (np.diff(run) > 0).all(), g
    stable = torch.sort(bins.sorted_idx, stable=True).indices
    assert torch.equal(src.long(), stable)
