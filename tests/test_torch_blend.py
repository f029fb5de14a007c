"""The port's blend against the TPU kernels K1 (pallas_stream), K4
(pallas_blend), both in interpret mode, and the XLA blend of dogs_tpu, all
on the same sorted entry matrix built by dogs_tpu (fed to the port with
sorted_idx = arange(K)), and the port's gather through sorted_idx from a
permuted N-space matrix.

The port's plain version is what runs here; the CUDA kernel is held against
it on the card (chip_smoke.py and tests/test_torch_cuda.py).
"""

import functools

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
from tests.test_torch_core import jax_params

ATOL = 3e-4  # forward parity bar of tests/test_pallas_blend.py
TS = 16
MT = 36

SCENES = {
    "random_seed0": (lambda: synthetic.random_scene_arrays(seed=0), synthetic.RANDOM_SCENE_VIEW, 2),
    "random_seed3": (lambda: synthetic.random_scene_arrays(seed=3), synthetic.RANDOM_SCENE_VIEW, 2),
    "saturation": (synthetic.saturation_scene_arrays, synthetic.SATURATION_SCENE_VIEW, 1),
    "empty_tiles": (
        lambda: synthetic.random_scene_arrays(n=16, seed=2, spread=0.3),
        synthetic.RANDOM_SCENE_VIEW, 2,
    ),
}


@functools.lru_cache(maxsize=None)
def jax_entries(scene):
    """dogs_tpu's sorted entries and tile starts for a scene, as render_tiled
    builds them (tiled.py:619-643), plus the tile grid."""
    make, view, deg = SCENES[scene]
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
    nv = int(bins.num_valid)
    ent = np.array(ent_n[bins.sorted_idx[:nv]])
    return ent, bins, ent_n, (-(-h // TS), -(-w // TS), w, h)


def in_image(nty, ntx, w, h):
    t = np.arange(nty * ntx)[:, None]
    p = np.arange(TS * TS)[None, :]
    return ((t % ntx) * TS + p % TS < w) & ((t // ntx) * TS + p // TS < h)


def identity_idx(k):
    return torch.arange(k, dtype=torch.int32)


def permuted_rows(ent_n, sorted_idx, seed):
    """The N-space rows in a random numpy order, and the sorted_idx that
    reads the same entries from it."""
    ent_n = np.asarray(ent_n)
    perm = np.random.RandomState(seed).permutation(ent_n.shape[0])
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0])
    idx = inv[np.asarray(sorted_idx)].astype(np.int32)
    return torch.from_numpy(np.ascontiguousarray(ent_n[perm])), torch.from_numpy(idx)


def port_blend(scene):
    ent, bins, _, (nty, ntx, w, h) = jax_entries(scene)
    starts = torch.from_numpy(np.array(bins.tile_starts))
    return blend.blend_forward_reference(
        torch.from_numpy(ent), identity_idx(ent.shape[0]), starts, nty, ntx, w, h
    ).numpy()


def tpu_blend(scene, which):
    """(T, 5, P) rows R, G, B, A, invD from one of dogs_tpu's blends."""
    ent, bins, ent_n, (nty, ntx, _, _) = jax_entries(scene)
    if which == "xla":
        cfg = JRasterConfig(tile_size=TS, max_tiles_per_gaussian=MT, tile_batch=8, chunk=16)
        img, aa, dd = _blend_with_vjp(
            bins, ent_n[bins.sorted_idx], jnp.zeros(3), nty, ntx, cfg
        )
        t = nty * ntx
        return np.concatenate(
            [np.moveaxis(np.asarray(img[:t]), 2, 1), np.asarray(aa[:t])[:, None],
             np.asarray(dd[:t])[:, None]],
            axis=1,
        )
    k_pad = -(-max(ent.shape[0], 1) // 128) * 128
    ent_t = jnp.asarray(np.pad(ent, ((0, k_pad - ent.shape[0]), (0, 0))).T)
    if which == "k1_stream":
        out = pallas_stream.blend_forward_stream(
            ent_t, bins.tile_starts, nty, ntx, TS, ch=128, interpret=True
        )
    else:
        out = pallas_blend.blend_forward_pallas(
            ent_t, bins.tile_starts, nty, ntx, TS, ch=32, g_tiles=4, interpret=True
        )
    return np.asarray(out)[:, :5]


@pytest.mark.parametrize("which", ["k1_stream", "k4_pertile", "xla"])
@pytest.mark.parametrize("scene", list(SCENES))
def test_blend_reference_matches_tpu_blends(scene, which):
    got = port_blend(scene)
    want = tpu_blend(scene, which)
    mask = in_image(*jax_entries(scene)[3])
    for row, name in enumerate(["R", "G", "B", "A", "invD"]):
        np.testing.assert_allclose(got[:, row][mask], want[:, row][mask], atol=ATOL, err_msg=name)


@pytest.mark.parametrize("scene", list(SCENES))
def test_blend_reference_zeroes_empty_tiles_and_margin(scene):
    got = port_blend(scene)
    _, bins, _, grid = jax_entries(scene)
    starts = np.asarray(bins.tile_starts)
    empty = starts[1:] == starts[:-1]
    assert (got[empty] == 0).all()
    assert (got.transpose(0, 2, 1)[~in_image(*grid)] == 0).all()
    if scene == "empty_tiles":
        assert empty.sum() > 0


@pytest.mark.parametrize("scene", list(SCENES))
def test_blend_reference_reads_rows_through_sorted_idx(scene):
    """The N-space rows in a random order with the matching sorted_idx give
    the blend of the sorted entries, bit for bit."""
    ent, bins, ent_n, (nty, ntx, w, h) = jax_entries(scene)
    rows, idx = permuted_rows(ent_n, bins.sorted_idx[: ent.shape[0]], seed=5)
    starts = torch.from_numpy(np.array(bins.tile_starts))
    got = blend.blend_forward_reference(rows, idx, starts, nty, ntx, w, h).numpy()
    np.testing.assert_array_equal(got, port_blend(scene))


def test_blend_reference_checks_layout():
    ent, bins, _, (nty, ntx, w, h) = jax_entries("random_seed0")
    starts = torch.from_numpy(np.array(bins.tile_starts))
    ent_t, idx = torch.from_numpy(ent), identity_idx(ent.shape[0])
    with pytest.raises(ValueError, match="int32"):
        blend.blend_forward_reference(ent_t, idx, starts.long(), nty, ntx, w, h)
    with pytest.raises(ValueError, match="float32"):
        blend.blend_forward_reference(torch.from_numpy(ent[:, :11]), idx, starts, nty, ntx, w, h)
    with pytest.raises(ValueError, match="sorted_idx"):
        blend.blend_forward_reference(ent_t, idx.long(), starts, nty, ntx, w, h)
