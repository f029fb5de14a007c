"""The port's plain blend backward against the TPU kernels K2 (pallas_stream)
and K5 (pallas_blend), both in interpret mode, and against the VJP of the
XLA blend of dogs_tpu, on the same sorted entries and the same cotangent.

The JAX kernels take the transposed, chunk-padded (16, K_pad) layout and
give (16, K_pad) gradients; the comparison is on the K in-range entries and
the 10 live columns. The port's plain version is what runs here; the CUDA
kernel is held against it on the card (chip_smoke.py, tests/test_torch_cuda.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dogs_tpu.core.camera import look_at_camera as j_look_at
from dogs_tpu.raster import pallas_blend, pallas_stream
from dogs_tpu.raster.binning import build_tile_bins as j_bins
from dogs_tpu.raster.projection import project_gaussians as j_project
from dogs_tpu.raster.tiled import RasterConfig as JRasterConfig
from dogs_tpu.raster.tiled import _blend_with_vjp
from dogs_tpu_torch.data import synthetic
from dogs_tpu_torch.raster import blend
from tests.test_torch_blend import SCENES as FWD_SCENES
from tests.test_torch_blend import identity_idx, in_image, permuted_rows
from tests.test_torch_core import jax_params

ATOL = 2e-3  # max-normalized gradient bar of tests/test_pallas_blend.py:58-61
TS = 16
MT = 36

# scene -> (arrays, view, SH degree, depth_threshold)
SCENES = {
    "random_seed0": FWD_SCENES["random_seed0"] + (0.0,),
    "random_seed3": FWD_SCENES["random_seed3"] + (0.0,),
    "saturation": FWD_SCENES["saturation"] + (0.0,),
    "empty_tiles": FWD_SCENES["empty_tiles"] + (0.0,),
    "non_aligned_100x37": (
        lambda: synthetic.random_scene_arrays(n=48, seed=4),
        dict(synthetic.RANDOM_SCENE_VIEW, width=100, height=37, fx=60.0, fy=60.0), 2, 0.0,
    ),
    # Depths here are ~2.8-5.2: the damping scales most mean gradients.
    "depth_threshold": FWD_SCENES["random_seed0"] + (4.5,),
}


@functools.lru_cache(maxsize=None)
def case(scene):
    """Sorted entries (JAX layout: column 11 is the constant 1 the Pallas
    forward reads), bins, grid, the cotangent (T, 8, P) built from a numpy
    draw and the forward totals, and the port's plain backward."""
    make, view, deg, thr = SCENES[scene]
    h, w = view["height"], view["width"]
    proj = j_project(jax_params(make()), j_look_at(**view), active_sh_degree=deg)
    bins = j_bins(proj, h, w, tile_size=TS, max_tiles_per_gaussian=MT)
    visible = proj.radius > 0.0
    dsafe = jnp.where(visible, proj.depth, 1.0)
    n = proj.depth.shape[0]
    ent_n = jnp.concatenate(
        [
            proj.means2d, proj.conic, proj.color,
            jnp.where(visible, proj.opacity, 0.0)[:, None],
            jnp.where(visible, 1.0 / dsafe, 0.0)[:, None],
            dsafe[:, None], jnp.ones((n, 1)), jnp.zeros((n, 4)),
        ],
        axis=1,
    )
    k = int(bins.num_valid)
    ent = np.array(ent_n[bins.sorted_idx[:k]])
    nty, ntx = -(-h // TS), -(-w // TS)
    grid = (nty, ntx, w, h)
    starts = torch.from_numpy(np.array(bins.tile_starts))
    ent_t, idx = torch.from_numpy(ent), identity_idx(k)
    fwd = blend.blend_forward_reference(ent_t, idx, starts, *grid).numpy()

    # Cotangent of (image, alpha, invdepth) per tile pixel, zero past the
    # image edge (where untile crops); background 0, so gA_eff = cot_a.
    rng = np.random.RandomState(7)
    t = nty * ntx
    mask = in_image(*grid)
    cot_img = (rng.randn(t, TS * TS, 3) * mask[..., None]).astype(np.float32)
    cot_a = (rng.randn(t, TS * TS) * mask).astype(np.float32)
    cot_d = (rng.randn(t, TS * TS) * mask).astype(np.float32)
    cot_rgb = cot_img.transpose(0, 2, 1)
    g_tot = (cot_rgb * fwd[:, 0:3]).sum(1) + cot_a * fwd[:, 3] + cot_d * fwd[:, 4]
    cot = np.concatenate(
        [cot_rgb, cot_a[:, None], cot_d[:, None], g_tot[:, None], np.zeros((t, 2, TS * TS))], axis=1
    ).astype(np.float32)
    got = blend.blend_backward_reference(
        ent_t, idx, starts, torch.from_numpy(cot), *grid, depth_threshold=thr
    ).numpy()
    return ent, bins, ent_n, grid, thr, (cot_img, cot_a, cot_d, cot), got


def tpu_backward(scene, which):
    """(K, 10) per-entry gradients from one of dogs_tpu's backwards."""
    ent, bins, ent_n, (nty, ntx, w, h), thr, (cot_img, cot_a, cot_d, cot) = case(scene)[:6]
    k = ent.shape[0]
    if which == "xla":
        cfg = JRasterConfig(
            tile_size=TS, max_tiles_per_gaussian=MT, tile_batch=8, chunk=16, depth_threshold=thr
        )
        t = nty * ntx
        t_pad = -(-t // cfg.tile_batch) * cfg.tile_batch

        def pad(x):
            return jnp.asarray(np.concatenate([x, np.zeros((t_pad - t,) + x.shape[1:], x.dtype)]))

        sorted_ent = ent_n[bins.sorted_idx]
        _, vjp = jax.vjp(
            lambda e: _blend_with_vjp(bins, e, jnp.zeros(3), nty, ntx, cfg), sorted_ent
        )
        (d_ent,) = vjp((pad(cot_img), pad(cot_a), pad(cot_d)))
        return np.asarray(d_ent)[:k, :10]
    k_pad = -(-max(k, 1) // 128) * 128
    ent_t = jnp.asarray(np.pad(ent, ((0, k_pad - k), (0, 0))).T)
    kw = dict(depth_threshold=thr, interpret=True)
    if which == "k2_stream":
        d = pallas_stream.blend_backward_stream(
            ent_t, bins.tile_starts, jnp.asarray(cot), nty, ntx, TS, ch=128, **kw
        )
    else:
        d = pallas_blend.blend_backward_pallas(
            ent_t, bins.tile_starts, jnp.asarray(cot), nty, ntx, TS, ch=32, g_tiles=4, **kw
        )
    return np.asarray(d).T[:k, :10]


@pytest.mark.parametrize("which", ["k2_stream", "k5_pertile", "xla"])
@pytest.mark.parametrize("scene", list(SCENES))
def test_blend_backward_reference_matches_tpu_backwards(scene, which):
    got = case(scene)[-1]
    want = tpu_backward(scene, which)
    assert got.shape[1] == blend.ENT_WIDTH
    np.testing.assert_array_equal(got[:, 10:], 0.0)
    names = ["mux", "muy", "ca", "cb", "cc", "r", "g", "b", "opa", "invd"]
    for c, name in enumerate(names):
        scale = np.abs(want[:, c]).max() + 1e-6
        np.testing.assert_allclose(got[:, c] / scale, want[:, c] / scale, atol=ATOL, err_msg=name)


def test_blend_backward_reference_gives_zero_rows_past_saturation():
    """Saturated tiles stop early: entries behind the stop get exact zeros
    (the kernel's zero-filled rows), and the scene does saturate."""
    ent, bins, _, grid, _, cots, got = case("saturation")
    starts = np.array(bins.tile_starts)
    fwd = blend.blend_forward_reference(
        torch.from_numpy(ent), identity_idx(ent.shape[0]), torch.from_numpy(starts), *grid
    )
    assert float(fwd[:, 3].max()) > 0.999  # some pixel reached T < 1e-4
    zero_rows = (got[:, :10] == 0).all(1)
    assert zero_rows.sum() > 0
    assert not zero_rows.all()


@pytest.mark.parametrize("scene", ["random_seed0", "saturation", "depth_threshold"])
def test_blend_backward_reference_reads_rows_through_sorted_idx(scene):
    """The N-space rows in a random order with the matching sorted_idx give
    the gradients of the sorted entries, bit for bit."""
    ent, bins, ent_n, grid, thr, (_, _, _, cot), want = case(scene)
    rows, idx = permuted_rows(ent_n, bins.sorted_idx[: ent.shape[0]], seed=6)
    starts = torch.from_numpy(np.array(bins.tile_starts))
    got = blend.blend_backward_reference(
        rows, idx, starts, torch.from_numpy(cot), *grid, depth_threshold=thr
    ).numpy()
    np.testing.assert_array_equal(got, want)


def test_blend_backward_reference_checks_cot_layout():
    ent, bins, _, grid, _, (_, _, _, cot), _ = case("random_seed0")
    starts = torch.from_numpy(np.array(bins.tile_starts))
    with pytest.raises(ValueError, match="cot"):
        blend.blend_backward_reference(
            torch.from_numpy(ent), identity_idx(ent.shape[0]), starts, torch.from_numpy(cot[:, :6]), *grid
        )
