"""Metrics (PSNR, SSIM, LPIPS), checkpoint loading, the evaluator, the PNG
writer, model export, the test trajectory and the eval CLI against
dogs_tpu."""

import json
import shutil
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dogs_tpu.data.dataset import spheric_test_poses as j_spheric_test_poses
from dogs_tpu.eval import metrics as jm
from dogs_tpu.fields import io as jio
from dogs_tpu.eval.evaluator import EvalConfig as JEvalConfig
from dogs_tpu.eval.evaluator import GaussianSplatEvaluator as JEvaluator
from dogs_tpu.fields.model import GaussianModelState as JModelState
from dogs_tpu.raster.tiled import RasterConfig as JRasterConfig
from dogs_tpu.train.checkpoint import save_pytree
from dogs_tpu_torch.data import synthetic
from dogs_tpu_torch.data.dataset import spheric_test_poses
from dogs_tpu_torch.eval import metrics as tm
from dogs_tpu_torch.eval.__main__ import main as eval_cli_main
from dogs_tpu_torch.eval.evaluator import EvalConfig, GaussianSplatEvaluator
from dogs_tpu_torch.fields import io as tio
from dogs_tpu_torch.raster.tiled import RasterConfig
from dogs_tpu_torch.train.__main__ import main as train_cli_main
from dogs_tpu_torch.train.checkpoint import load_jax_checkpoint
from dogs_tpu_torch.utils import png
from tests.test_torch_core import jax_params

REPO = Path(__file__).resolve().parents[1]
H, W = 56, 72
LPIPS_RTOL = 1e-5


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


def test_png_writer_decodes_to_the_array(tmp_path):
    import imageio.v2 as imageio

    rgb = np.random.RandomState(0).randint(0, 256, (H, W, 3)).astype(np.uint8)
    path = str(tmp_path / "x.png")
    png.write_png(path, rgb)
    np.testing.assert_array_equal(imageio.imread(path), rgb)
    assert png.png_size(path) == (W, H)
    with pytest.raises(ValueError, match="uint8"):
        png.write_png(path, rgb.astype(np.float32))


def lpips_weights_npz(path, seed):
    """Calibrated-format LPIPS weights (conv{i}_w HWIO, conv{i}_b, lin{i})
    drawn from `seed`, with nonzero biases."""
    rng = np.random.RandomState(seed)
    params, lins = jm._default_lpips_params(seed)
    arrays = {}
    for i, p in enumerate(params):
        arrays[f"conv{i}_w"] = p["w"]
        arrays[f"conv{i}_b"] = (rng.randn(*p["b"].shape) * 0.05).astype(np.float32)
        arrays[f"lin{i}"] = lins[i]
    np.savez(path, **arrays)


@pytest.mark.parametrize("weights", ["fallback", "calibrated"])
def test_lpips_matches_jax(tmp_path, monkeypatch, weights):
    pred, gt = image_pair(3)
    if weights == "calibrated":
        lpips_weights_npz(tmp_path / "lpips.npz", seed=4)
        monkeypatch.setenv("DOGS_TPU_LPIPS_WEIGHTS", str(tmp_path / "lpips.npz"))
    else:
        monkeypatch.delenv("DOGS_TPU_LPIPS_WEIGHTS", raising=False)
    got, t_cal = tm.lpips(torch.from_numpy(pred), torch.from_numpy(gt))
    want, j_cal = jm.lpips(jnp.asarray(pred), jnp.asarray(gt))
    assert t_cal == j_cal == (weights == "calibrated")
    np.testing.assert_allclose(float(got), float(want), rtol=LPIPS_RTOL)
    assert float(got) > 0.0 and float(tm.lpips(torch.from_numpy(gt), torch.from_numpy(gt))[0]) == 0.0


def test_spheric_test_poses_equal():
    for n, radius, height in ((5, 3.0, -0.5), (8, 1.7, 0.25)):
        np.testing.assert_array_equal(spheric_test_poses(n, radius, height), j_spheric_test_poses(n, radius, height))


def test_export_is_byte_equal_to_jax_and_reads_back(tmp_path):
    """.splat, the 3DGS .ply and the COLMAP point cloud of the alive slots,
    byte for byte, and the port's readers give back the alive rows."""
    model = jax_model(seed=6, n=80)
    path = tmp_path / "model.npz"
    save_checkpoint(path, model, "bare")
    state = load_jax_checkpoint(str(path), "cpu")
    jalive = np.asarray(model.alive)
    for name, j_save, t_save in (("m.splat", jio.save_splat, tio.save_splat),
                                 ("m.ply", jio.save_gaussian_ply, tio.save_gaussian_ply),
                                 ("m_points.ply", jio.save_colmap_ply, tio.save_colmap_ply)):
        j_save(str(tmp_path / f"jax_{name}"), model.params, model.alive)
        t_save(str(tmp_path / f"port_{name}"), state.params, state.alive)
        assert (tmp_path / f"port_{name}").read_bytes() == (tmp_path / f"jax_{name}").read_bytes(), name
    back = tio.load_gaussian_ply(str(tmp_path / "port_m.ply"), "cpu")
    for k in ("xyz", "feat_dc", "feat_rest", "log_scale", "quat", "logit_opacity"):
        np.testing.assert_array_equal(getattr(back, k).detach().numpy(),
                                      np.asarray(getattr(model.params, k))[jalive], err_msg=k)
    splat, j_splat = tio.load_splat(str(tmp_path / "port_m.splat")), jio.load_splat(str(tmp_path / "jax_m.splat"))
    assert splat["xyz"].shape == (int(jalive.sum()), 3)
    for k in splat:
        np.testing.assert_array_equal(splat[k], j_splat[k], err_msg=k)


def test_trajectory_without_imageio_writes_frames_and_no_gif(tmp_path, monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    state = load_jax_checkpoint_from(tmp_path, jax_model())
    ev = GaussianSplatEvaluator(state, RasterConfig(max_tiles_per_gaussian=36),
                                EvalConfig(output_dir=str(tmp_path / "eval"), active_sh_degree=2))
    cam = synthetic.ring_cameras(1, 4.0, W, H, W * 0.9, device="cpu")[0]
    caplog.set_level("INFO")
    assert ev.eval_test_trajectory(cam, n_poses=3, radius=4.0) is None
    frames = sorted((tmp_path / "eval" / "test").iterdir())
    assert [f.name for f in frames] == ["00000.png", "00001.png", "00002.png"]
    assert all(png.png_size(str(f)) == (W, H) for f in frames)
    assert "no GIF" in caplog.text


def load_jax_checkpoint_from(tmp_path, model):
    path = tmp_path / "model.npz"
    save_checkpoint(path, model, "bare")
    return load_jax_checkpoint(str(path), "cpu")


def test_eval_cli_matches_eval_py_on_the_train_cli_checkpoint(tmp_path):
    """The port's train CLI writes a checkpoint; the port's eval CLI and
    eval.py's evaluate score, export and render the trajectory from it.
    Without color correction: the renders of the two packages differ where
    one Gaussian's alpha lies within rounding of the 1/255 cut (up to
    1.4e-3 at 754 of 7,680 pixels here), and the correction's saturation
    masks turn that into 5e-3 dB; uncorrected the means agree to 5e-5 dB,
    SSIM to 1.9e-5 (the bar is 1e-4) and LPIPS to 2e-6."""
    import eval as j_eval

    from dogs_tpu.utils.config import load_config as j_load_config

    config = str(REPO / "config" / "gaussian_splatting" / "synthetic_smoke.yaml")
    common = ["trainer.max_iterations=6", "trainer.enable_tensorboard=false", "eval.n_test_poses=2",
              "eval.color_correct=false"]
    port_root, jax_root = tmp_path / "port", tmp_path / "jax"
    train_cli_main(["--config", config, "device=cpu", f"root_dir={port_root}", *common])
    expname = "gs_novel_view_synthesis_synthetic_toy"
    shutil.copytree(port_root / expname / "model", jax_root / expname / "model")
    eval_cli_main(["--config", config, "device=cpu", f"root_dir={port_root}", *common])
    j_cfg = j_load_config(config, cli_overrides=[f"root_dir={jax_root}", *common])
    j_cfg.dataset.scene, j_cfg.expname = "toy", expname
    j_eval.evaluate(j_cfg)

    def metrics(root):
        return json.loads((root / expname / "eval" / "val" / "metrics.json").read_text())["mean"]

    got, want = metrics(port_root), metrics(jax_root)
    assert got["step"] == want["step"] == 6 and got["num_points"] == want["num_points"]
    assert abs(got["psnr"] - want["psnr"]) < 1e-3, (got, want)
    assert abs(got["ssim"] - want["ssim"]) < 1e-4, (got, want)
    assert abs(got["lpips_uncalibrated"] - want["lpips_uncalibrated"]) < 1e-5, (got, want)
    for name in ("model.splat", "model.ply", "model_points.ply"):
        assert (port_root / expname / "export" / name).read_bytes() == (
            jax_root / expname / "export" / name).read_bytes(), name
    import imageio.v2 as imageio

    for i in range(2):  # the trajectory: uint8 frames of renders equal up to f32 rounding
        frame = f"{i:05d}.png"
        a, b = (imageio.imread(root / expname / "eval" / "test" / frame).astype(int) for root in (port_root, jax_root))
        assert a.shape == (80, 96, 3) and np.abs(a - b).max() <= 1, frame
    assert (port_root / expname / "eval" / "test" / "trajectory.gif").exists()
