"""dogs_tpu_torch.core against dogs_tpu.core on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dogs_tpu.core import camera as jcam
from dogs_tpu.core import gaussians as jgs
from dogs_tpu.core import sh as jsh
from dogs_tpu.core import transforms as jtf
from dogs_tpu_torch.core import camera as tcam
from dogs_tpu_torch.core import gaussians as tgs
from dogs_tpu_torch.core import sh as tsh
from dogs_tpu_torch.core import transforms as ttf
from dogs_tpu_torch.data import synthetic

TOL = dict(atol=1e-6, rtol=1e-5)


def jax_params(arrays):
    return jgs.GaussianParams(**{k: jnp.asarray(v) for k, v in arrays.items()})


def close(t, j, **kw):
    np.testing.assert_allclose(t.detach().cpu().numpy(), np.asarray(j), **(kw or TOL))


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh_matches(deg):
    rng = np.random.RandomState(deg)
    sh = rng.randn(50, 25, 3).astype(np.float32)
    dirs = rng.randn(50, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    close(tsh.eval_sh(deg, torch.from_numpy(sh), torch.from_numpy(dirs)),
          jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(dirs)))


def test_rgb_sh_roundtrip_matches():
    rgb = np.random.RandomState(0).rand(20, 3).astype(np.float32)
    close(tsh.rgb_to_sh(torch.from_numpy(rgb)), jsh.rgb_to_sh(jnp.asarray(rgb)))
    close(tsh.sh_to_rgb(tsh.rgb_to_sh(torch.from_numpy(rgb))), rgb)


def test_quat_to_rotmat_and_covariance_match():
    rng = np.random.RandomState(1)
    q = rng.randn(40, 4).astype(np.float32)
    s = np.exp(rng.randn(40, 3)).astype(np.float32)
    close(ttf.quat_to_rotmat(torch.from_numpy(q)), jtf.quat_to_rotmat(jnp.asarray(q)))
    for a, b in zip(
        ttf.covariance_sym6(torch.from_numpy(s), torch.from_numpy(q)),
        jtf.covariance_sym6(jnp.asarray(s), jnp.asarray(q)),
    ):
        close(a, b)


@pytest.mark.parametrize("view", ["random", "saturation", "bench"])
def test_camera_properties_match(view):
    if view == "bench":
        import bench

        j = bench._bench_cameras(8)[5]
        t = synthetic.bench_cameras(8, device="cpu")[5]
    else:
        kw = synthetic.RANDOM_SCENE_VIEW if view == "random" else synthetic.SATURATION_SCENE_VIEW
        j, t = jcam.look_at_camera(**kw), tcam.look_at_camera(**kw, device="cpu")
    for f in ("R", "t", "fx", "fy", "cx", "cy"):
        close(getattr(t, f), getattr(j, f), atol=0, rtol=0)
    assert (t.width, t.height) == (j.width, j.height)
    close(t.camera_center, j.camera_center)
    close(t.tan_half_fov_x, j.tan_half_fov_x)
    close(t.tan_half_fov_y, j.tan_half_fov_y)


@pytest.mark.parametrize(
    "arrays",
    [synthetic.random_scene_arrays(seed=4), synthetic.gt_params_arrays(30, seed=1)],
    ids=["random_scene", "gt_params"],
)
def test_params_from_numpy_activations_match(arrays):
    t = tgs.params_from_numpy(arrays, "cpu")
    j = jax_params(arrays)
    assert t.capacity == j.capacity and t.max_sh_degree == j.max_sh_degree
    close(t.scale, j.scale)
    close(t.opacity, j.opacity)
    close(t.features, j.features, atol=0, rtol=0)


def test_synthetic_draws_match_jax_bit_for_bit():
    """Same RandomState draw order as dogs_tpu.data.synthetic / bench.py."""
    import bench
    from dogs_tpu.data.synthetic import make_gt_params

    pairs = [
        (synthetic.gt_params_arrays(25, seed=3), make_gt_params(25, seed=3)),
        (synthetic.bench_scene_arrays(200, seed=7), bench.bench_scene(200, seed=7)),
    ]
    for arrays, j in pairs:
        for k in ("xyz", "feat_dc", "feat_rest", "log_scale", "quat"):
            np.testing.assert_array_equal(arrays[k], np.asarray(getattr(j, k)), err_msg=k)
        np.testing.assert_allclose(
            arrays["logit_opacity"], np.asarray(j.logit_opacity), atol=1e-6, rtol=1e-6
        )


def test_empty_params_and_inverse_sigmoid():
    t, j = tgs.empty_params(5, 2, "cpu"), jgs.empty_params(5, 2)
    for k in tgs.PARAM_NAMES:
        close(getattr(t, k), getattr(j, k), atol=0, rtol=0)
    x = np.linspace(0.05, 0.95, 11, dtype=np.float32)
    close(tgs.inverse_sigmoid(torch.from_numpy(x)), jgs.inverse_sigmoid(jnp.asarray(x)))
