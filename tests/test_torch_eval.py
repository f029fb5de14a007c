"""Metrics, checkpoint loading and the evaluator against dogs_tpu."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dogs_tpu.eval import metrics as jm
from dogs_tpu.eval.evaluator import EvalConfig as JEvalConfig
from dogs_tpu.eval.evaluator import GaussianSplatEvaluator as JEvaluator
from dogs_tpu.fields.model import GaussianModelState as JModelState
from dogs_tpu.raster.tiled import RasterConfig as JRasterConfig
from dogs_tpu.train.checkpoint import save_pytree
from dogs_tpu_torch.data import synthetic
from dogs_tpu_torch.eval import metrics as tm
from dogs_tpu_torch.eval.evaluator import EvalConfig, GaussianSplatEvaluator
from dogs_tpu_torch.raster.tiled import RasterConfig
from dogs_tpu_torch.train.checkpoint import load_jax_checkpoint
from tests.test_torch_core import jax_params

H, W = 56, 72


def image_pair(seed):
    rng = np.random.RandomState(seed)
    gt = np.clip(rng.rand(H, W, 3) * 0.8 + 0.1, 0, 1).astype(np.float32)
    # A smooth cross-channel distortion plus noise: what color_correct undoes.
    mix = np.array([[0.9, 0.1, 0.0], [0.05, 0.8, 0.1], [0.0, 0.1, 1.1]], np.float32)
    pred = np.clip(gt @ mix.T * 0.95 + 0.03 + rng.randn(H, W, 3) * 0.02, 0, 1).astype(np.float32)
    return pred, gt


@pytest.mark.parametrize("seed", [0, 1])
def test_psnr_ssim_match(seed):
    pred, gt = image_pair(seed)
    tp, tg = torch.from_numpy(pred), torch.from_numpy(gt)
    np.testing.assert_allclose(float(tm.psnr(tp, tg)), float(jm.psnr(jnp.asarray(pred), jnp.asarray(gt))),
                               atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(float(tm.ssim(tp, tg)), float(jm.ssim(jnp.asarray(pred), jnp.asarray(gt))),
                               atol=1e-5)


def test_color_correct_matches():
    pred, gt = image_pair(2)
    got = tm.color_correct(torch.from_numpy(pred), torch.from_numpy(gt)).numpy()
    want = np.asarray(jm.color_correct(jnp.asarray(pred), jnp.asarray(gt)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.abs(got - gt).mean() < np.abs(pred - gt).mean()


def jax_model(seed=5, n=64):
    arrays = synthetic.gt_params_arrays(n, seed=seed, max_sh_degree=2)
    rng = np.random.RandomState(seed)
    return JModelState(
        params=jax_params(arrays),
        alive=jnp.asarray(rng.rand(n) > 0.2),
        grad_accum=jnp.asarray(rng.rand(n).astype(np.float32)),
        denom=jnp.asarray(rng.randint(0, 9, n).astype(np.float32)),
        max_radii2d=jnp.asarray(rng.rand(n).astype(np.float32) * 10),
    )


def save_checkpoint(path, model, kind):
    if kind == "bare":
        save_pytree(str(path), model, {"step": 7})
    else:
        from dogs_tpu.train.trainer import TrainerConfig, train_state_from_model

        save_pytree(str(path), train_state_from_model(model, 3, TrainerConfig()), {"step": 7})


@pytest.mark.parametrize("kind", ["bare", "trainer"])
def test_load_jax_checkpoint(tmp_path, kind):
    model = jax_model()
    path = tmp_path / "model.npz"
    save_checkpoint(path, model, kind)
    state = load_jax_checkpoint(str(path), "cpu")
    for k in ("xyz", "feat_dc", "feat_rest", "log_scale", "quat", "logit_opacity"):
        np.testing.assert_array_equal(getattr(state.params, k).detach().numpy(),
                                      np.asarray(getattr(model.params, k)), err_msg=k)
    for k in ("alive", "grad_accum", "denom", "max_radii2d"):
        np.testing.assert_array_equal(getattr(state, k).numpy(), np.asarray(getattr(model, k)))
    assert int(state.num_alive) == int(model.num_alive)


def test_load_jax_checkpoint_rejects_newer_format_and_non_models(tmp_path):
    newer = tmp_path / "newer.npz"
    np.savez(newer, __meta__=json.dumps({"format_version": 2}), **{".params/.xyz": np.zeros((1, 3))})
    with pytest.raises(ValueError, match="format_version"):
        load_jax_checkpoint(str(newer), "cpu")
    other = tmp_path / "other.npz"
    save_pytree(str(other), {"w": jnp.zeros(3)})
    with pytest.raises(KeyError, match="no model state"):
        load_jax_checkpoint(str(other), "cpu")


def test_lpips_not_ported_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        GaussianSplatEvaluator(None, RasterConfig(), EvalConfig(compute_lpips=True))


@pytest.mark.parametrize("kind,split", [("bare", "val"), ("trainer", "test")])
def test_evaluator_matches_jax_on_loaded_checkpoint(tmp_path, kind, split):
    from dogs_tpu.data.synthetic import make_scene as j_make_scene
    from dogs_tpu.data.synthetic import ring_cameras as j_ring

    model = jax_model()
    path = tmp_path / "model.npz"
    save_checkpoint(path, model, kind)
    gt = j_make_scene(n_gaussians=48, n_cams=3, width=W, height=H, seed=1).images
    ring = dict(n_cams=3, radius=4.0, width=W, height=H, focal=W * 0.9)
    bg = (0.1, 0.2, 0.3)

    j_eval = JEvaluator(
        model, JRasterConfig(max_tiles_per_gaussian=36, tile_batch=8, chunk=16),
        JEvalConfig(output_dir=str(tmp_path / "jax"), save_images=False, compute_lpips=False,
                    background=bg, active_sh_degree=2),
    )
    t_eval = GaussianSplatEvaluator(
        load_jax_checkpoint(str(path), "cpu"), RasterConfig(max_tiles_per_gaussian=36),
        EvalConfig(output_dir=str(tmp_path / "torch"), save_images=False, background=bg,
                   active_sh_degree=2),
    )
    want = j_eval.eval(j_ring(**ring), gt, split=split)
    got = t_eval.eval(synthetic.ring_cameras(**ring, device="cpu"), gt, split=split)
    with open(tmp_path / "torch" / split / "metrics.json") as f:
        assert json.load(f) == got
    assert got["mean"]["num_points"] == want["mean"]["num_points"]
    for a, b in zip(got["per_image"], want["per_image"]):
        assert abs(a["psnr"] - b["psnr"]) < 0.05, (a, b)
        assert abs(a["ssim"] - b["ssim"]) < 1e-3, (a, b)
        assert 5.0 < a["psnr"] < 60.0
