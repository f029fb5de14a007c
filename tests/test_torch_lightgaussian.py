"""The LightGaussian importance prune against dogs_tpu: the importance
render (one VJP through the invD column of the blend), its sum over
cameras, the volume-weighted scores, the 90th-percentile volume and the
percentile prune. JAX runs on the CPU with the XLA raster path; the same
numpy inputs go to both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dogs_tpu.core.camera import look_at_camera as j_look_at
from dogs_tpu.data.synthetic import ring_cameras as j_ring_cameras
from dogs_tpu.fields import lightgaussian as jlg
from dogs_tpu.fields.model import GaussianModelState as JModelState
from dogs_tpu.raster.tiled import RasterConfig as JRasterConfig
from dogs_tpu_torch.core import look_at_camera, params_from_numpy
from dogs_tpu_torch.data import synthetic
from dogs_tpu_torch.fields import lightgaussian as tlg
from dogs_tpu_torch.fields.model import GaussianModelState
from dogs_tpu_torch.raster.tiled import RasterConfig
from tests.test_torch_core import jax_params

J_XLA = JRasterConfig(tile_size=16, max_tiles_per_gaussian=36, tile_batch=8, chunk=16, reduce_dtype="f32")
T_RASTER = RasterConfig(max_tiles_per_gaussian=36)
GRAD_ATOL = 2e-3  # max-normalized gradient bar of tests/test_pallas_blend.py:58-61
SCORE_RTOL = 1e-6
RING = dict(n_cams=3, radius=4.0, width=72, height=56, focal=64.0)


def models(n=96, seed=0, dead=0.25):
    """The same model in both packages: a random scene with a share of
    dead slots. The port's alive mask is its own copy: the port prunes in
    place, and on the CPU `jnp.asarray` may alias the numpy buffer that
    `torch.from_numpy` would share."""
    arrays = synthetic.random_scene_arrays(n=n, seed=seed)
    alive = np.random.RandomState(seed + 1).rand(n) > dead
    zeros = np.zeros(n, np.float32)
    jm = JModelState(params=jax_params(arrays), alive=jnp.asarray(alive), grad_accum=jnp.asarray(zeros),
                     denom=jnp.asarray(zeros), max_radii2d=jnp.asarray(zeros))
    tm = GaussianModelState(params_from_numpy(arrays, "cpu"), torch.from_numpy(alive.copy()), *(
        torch.zeros(n) for _ in range(3)))
    return jm, tm, alive


def assert_grad_close(got, want):
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=GRAD_ATOL)


def test_importance_render_matches_jax_and_touches_no_parameter():
    jm, tm, alive = models()
    cam = look_at_camera(**synthetic.RANDOM_SCENE_VIEW, device="cpu")
    got = tlg.importance_render(tm, cam, T_RASTER, active_sh_degree=2).numpy()
    want = np.asarray(jlg.importance_render(jm, j_look_at(**synthetic.RANDOM_SCENE_VIEW), J_XLA, 2))
    assert_grad_close(got, want)
    assert not got[~alive].any() and (got[alive] > 0).sum() > 20
    assert all(p.grad is None for p in tm.params.parameters())


def test_prune_list_sums_cameras_like_jax():
    jm, tm, _ = models(seed=2)
    got = tlg.prune_list(tm, synthetic.ring_cameras(**RING, device="cpu"), T_RASTER, 2).numpy()
    want = np.asarray(jlg.prune_list(jm, j_ring_cameras(**RING), J_XLA, 2))
    assert_grad_close(got, want)


@pytest.mark.parametrize("n,dead", [(96, 0.25), (1001, 0.0), (4096, 0.6)])
def test_scores_match_jax(n, dead):
    """The same importance into both: scores within rtol 1e-6, which
    includes the 90th percentile of the alive volumes."""
    jm, tm, alive = models(n=n, seed=n, dead=dead)
    imp = np.random.RandomState(n).rand(n).astype(np.float32) * alive
    got = tlg.calculate_v_imp_score(tm, torch.from_numpy(imp), 0.1).numpy()
    want = np.asarray(jlg.calculate_v_imp_score(jm, jnp.asarray(imp), 0.1))
    np.testing.assert_allclose(got, want, rtol=SCORE_RTOL, atol=0)
    vol = np.prod(np.exp(np.asarray(jm.params.log_scale)), axis=-1)
    np.testing.assert_allclose(float(tlg._nanpercentile_alive(torch.from_numpy(vol), torch.from_numpy(alive), 90.0)),
                               float(jnp.nanpercentile(jnp.where(jnp.asarray(alive), vol, jnp.nan), 90)),
                               rtol=SCORE_RTOL)


@pytest.mark.parametrize("percent", [0.25, 0.5, 0.6 * 0.5, 1.0])
def test_prune_mask_equals_jax_for_equal_scores(percent):
    """Equal scores (with ties and dead slots) prune the same slots."""
    jm, tm, alive = models(n=200, seed=5)
    scores = np.round(np.random.RandomState(5).rand(200), 2).astype(np.float32)  # ties
    before = int(tm.num_alive)
    tlg.prune_gaussians(tm, percent, torch.from_numpy(scores))
    want = np.asarray(jlg.prune_gaussians(jm, percent, jnp.asarray(scores)).alive)
    np.testing.assert_array_equal(tm.alive.numpy(), want)
    k = int(np.float32(percent) * (np.float32(alive.sum()) - np.float32(1.0)))
    assert before - int(tm.num_alive) >= k
