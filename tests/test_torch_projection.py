"""dogs_tpu_torch.raster.projection against dogs_tpu.raster.projection."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dogs_tpu.core.camera import look_at_camera as j_look_at
from dogs_tpu.raster.projection import project_gaussians as j_project
from dogs_tpu_torch.core import look_at_camera, params_from_numpy
from dogs_tpu_torch.data import synthetic
from dogs_tpu_torch.raster.projection import project_gaussians
from tests.test_torch_core import jax_params

FIELDS = ("means2d", "depth", "conic", "color", "opacity", "radius")


def assert_projection_matches(arrays, view, **kw):
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    j = j_project(jax_params(arrays), j_look_at(**view), **jkw)
    t = project_gaussians(params_from_numpy(arrays, "cpu"), look_at_camera(**view, device="cpu"), **tkw)
    for f in FIELDS:
        np.testing.assert_allclose(
            getattr(t, f).detach().numpy(), np.asarray(getattr(j, f)), rtol=1e-5, atol=1e-5, err_msg=f
        )
    assert (t.radius > 0).any()


@pytest.mark.parametrize("antialiasing", [False, True])
@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_projection_matches(deg, antialiasing):
    arrays = synthetic.random_scene_arrays(seed=deg, max_sh_degree=3)
    assert_projection_matches(
        arrays, synthetic.RANDOM_SCENE_VIEW, active_sh_degree=deg, antialiasing=antialiasing
    )


def test_projection_alive_mask_and_scale_modifier():
    arrays = synthetic.random_scene_arrays(seed=7)
    alive = np.random.RandomState(7).rand(64) > 0.3
    offset = np.random.RandomState(8).randn(64, 2).astype(np.float32)
    assert_projection_matches(
        arrays, synthetic.RANDOM_SCENE_VIEW, alive=alive, active_sh_degree=2,
        scale_modifier=0.7, means2d_offset=offset,
    )


def test_projection_color_override():
    arrays = synthetic.random_scene_arrays(seed=9)
    colors = np.random.RandomState(9).randn(64, 3).astype(np.float32)
    assert_projection_matches(arrays, synthetic.RANDOM_SCENE_VIEW, color_override=colors)


def test_projection_near_plane_culls():
    """Saturation scene camera sits at the origin: points behind it cull."""
    arrays = synthetic.saturation_scene_arrays()
    arrays["xyz"][::4, 2] = -1.0
    assert_projection_matches(arrays, synthetic.SATURATION_SCENE_VIEW, active_sh_degree=1)
