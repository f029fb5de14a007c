"""The render slice as a whole: dogs_tpu_torch's render_tiled against
dogs_tpu's render_tiled, through the production stream kernel (K1, Pallas
in interpret mode) and through the XLA blend, on the same numpy scene."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dogs_tpu.core.camera import look_at_camera as j_look_at
from dogs_tpu.raster.tiled import RasterConfig as JRasterConfig
from dogs_tpu.raster.tiled import render_tiled as j_render
from dogs_tpu_torch.core import look_at_camera, params_from_numpy
from dogs_tpu_torch.data import synthetic
from dogs_tpu_torch.raster.tiled import RasterConfig, render_tiled
from tests.test_torch_core import jax_params

ATOL = 3e-4
J_XLA = JRasterConfig(tile_size=16, max_tiles_per_gaussian=36, tile_batch=8, chunk=16)
J_STREAM = dataclasses.replace(J_XLA, use_pallas=True, pallas_stream=True)
BG = np.array([0.15, 0.25, 0.35], np.float32)


def compare_render(arrays, view, jcfg, deg=2, antialiasing=False, **kw):
    jcfg = dataclasses.replace(jcfg, antialiasing=antialiasing)
    tcfg = RasterConfig(max_tiles_per_gaussian=36, antialiasing=antialiasing)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    a = j_render(jax_params(arrays), j_look_at(**view), jcfg, background=jnp.asarray(BG),
                 active_sh_degree=deg, **jkw)
    with torch.no_grad():
        b = render_tiled(params_from_numpy(arrays, "cpu"), look_at_camera(**view, device="cpu"), tcfg,
                         background=torch.from_numpy(BG), active_sh_degree=deg, **tkw)
    assert b.image.shape == (view["height"], view["width"], 3)
    for f in ("image", "alpha", "invdepth"):
        np.testing.assert_allclose(getattr(b, f).numpy(), np.asarray(getattr(a, f)), atol=ATOL,
                                   err_msg=f)
    np.testing.assert_array_equal(b.radii.numpy(), np.asarray(a.radii))
    assert b.bin_valid == int(a.bin_valid)
    assert b.bin_rect_truncated == int(a.bin_rect_truncated)
    assert b.bin_dropped == 0
    return b


@pytest.mark.parametrize("path", ["stream_kernel", "xla"])
@pytest.mark.parametrize("seed", [0, 3])
def test_render_matches_jax(seed, path):
    out = compare_render(synthetic.random_scene_arrays(seed=seed), synthetic.RANDOM_SCENE_VIEW,
                         J_STREAM if path == "stream_kernel" else J_XLA)
    # The background shows where coverage is thin: the composite is live.
    assert float(out.alpha.min()) < 0.5


def test_render_saturation_scene_matches_jax_stream_kernel():
    compare_render(synthetic.saturation_scene_arrays(), synthetic.SATURATION_SCENE_VIEW,
                   J_STREAM, deg=1)


def test_render_antialiasing_alive_and_invd_offset_match_jax():
    rng = np.random.RandomState(12)
    compare_render(
        synthetic.random_scene_arrays(seed=12), synthetic.RANDOM_SCENE_VIEW, J_XLA,
        antialiasing=True, alive=rng.rand(64) > 0.25,
        invd_offset=rng.uniform(0, 0.05, 64).astype(np.float32),
    )


def test_render_color_override_matches_jax():
    colors = np.random.RandomState(13).uniform(-0.1, 1.0, (64, 3)).astype(np.float32)
    compare_render(synthetic.random_scene_arrays(seed=13), synthetic.RANDOM_SCENE_VIEW, J_XLA,
                   color_override=colors)
