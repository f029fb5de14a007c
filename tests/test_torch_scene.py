"""The real-scene slice as a whole: the port's train and eval CLIs on a
written COLMAP scene with urban3d_admm.yaml (one device), the appearance
mask, the trained exposure and pose refinement on, against dogs_tpu's
utils.create_trainer on the same files."""

import json
import logging
import os
import re

import imageio.v2 as imageio
import jax
import numpy as np
import torch
from PIL import Image

import utils as j_utils
from dogs_tpu.core.transforms import rotmat_to_quat
from dogs_tpu.data import colmap as jcolmap
from dogs_tpu.data import dataset as jdataset
from dogs_tpu.utils import config as jconfig
from dogs_tpu_torch.data import dataset as tdataset
from dogs_tpu_torch.data import synthetic
from dogs_tpu_torch.eval.__main__ import main as eval_cli_main
from dogs_tpu_torch.fields.appearance import flatten
from dogs_tpu_torch.train.__main__ import main as train_cli_main
from dogs_tpu_torch.train.checkpoint import load_jax_train_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "config", "gaussian_splatting", "urban3d_admm.yaml")
STEPS = 4
# Both trainers take the same cameras, images and math; only f32 rounding
# differs. Per-step train PSNR and the final validate() at
# test_torch_train.py's bar; each trained leaf within LR_FRACTION of what
# its Adam can move it in STEPS steps (lr x STEPS). Measured on the CPU:
# 5e-6 at most (logit_opacity; the mask's up0 weights 2e-6), val PSNR 4e-6 dB.
PSNR_STEP_TOL = 0.01
LR_FRACTION = 1e-2


def write_colmap_scene(root: str, n_images=6, width=128, height=96, seed=3):
    """Renders of a synthetic teacher scene from a ring of cameras, written
    as PNGs with an OPENCV camera (small k1), the poses and the scene's
    points (jittered) with its colours, by dogs_tpu's writers; and the
    images at half size in images_2/, resized by PIL, as a dataset ships
    its downsampled copies (Mip-NeRF 360's images_2/4/8)."""
    scene = synthetic.make_scene(n_gaussians=120, n_cams=n_images, width=width, height=height, seed=seed,
                                 device="cpu")
    model_dir = os.path.join(root, "sparse", "0")
    os.makedirs(model_dir)
    os.makedirs(os.path.join(root, "images"))
    os.makedirs(os.path.join(root, "images_2"))
    focal = width * 0.9
    params = [focal, focal, width / 2, height / 2, 0.01, 0.0, 0.0, 0.0]
    jcolmap.write_cameras_bin(os.path.join(model_dir, "cameras.bin"),
                              {1: jcolmap.ColmapCamera(1, "OPENCV", width, height, np.asarray(params))})
    images = {}
    for i, (cam, img) in enumerate(zip(scene.cameras, scene.images)):
        R, t = cam.R.numpy().astype(np.float64), cam.t.numpy().astype(np.float64)
        q = np.asarray(rotmat_to_quat(R.astype(np.float32)), np.float64)
        images[i + 1] = jcolmap.ColmapImage(i + 1, q, t, 1, f"frame_{i:02d}.png")
        full = np.clip(img.numpy() * 255.0 + 0.5, 0, 255).astype(np.uint8)
        imageio.imwrite(os.path.join(root, "images", f"frame_{i:02d}.png"), full)
        Image.fromarray(full).resize((width // 2, height // 2), Image.BILINEAR).save(
            os.path.join(root, "images_2", f"frame_{i:02d}.png"))
    jcolmap.write_images_bin(os.path.join(model_dir, "images.bin"), images)
    rgb = np.clip(scene.colors * 255.0, 0, 255).astype(np.uint8)
    jcolmap.write_points3d_bin(os.path.join(model_dir, "points3D.bin"), scene.points.astype(np.float64), rgb)


def test_train_and_eval_cli_on_a_colmap_scene_match_dogs_tpu(tmp_path, caplog):
    """urban3d_admm.yaml's single-device run on one scene directory: the
    manhattan swap, factor 2 (both packages read the dataset's own
    images_2/, and each writes its own undistortion cache: the port only
    under its own names, the images equal), val = image 0 (val_interval 100),
    the mask at lambda_mask 0.5, exposure and pose refinement from step 2.
    Five train images own rows 0-4 of the per-image state while their image
    indices are 1-5: the last reads row 4 and writes nothing, in both
    packages."""
    data = tmp_path / "data"
    write_colmap_scene(str(data / "scene"))
    common = [f"dataset.root_dir={data}", "dataset.factor=2",
              "appearance.use_trained_exposure=true", "optimizer.lr.pose=1e-4", "geometry.opt_pose_start_iter=2",
              f"trainer.max_iterations={STEPS}", "trainer.n_tensorboard=1", "trainer.n_validation=0",
              "trainer.n_checkpoint=0", "trainer.enable_tensorboard=false"]
    port = [f"root_dir={tmp_path / 'out'}", "device=cpu", *common]
    caplog.set_level(logging.INFO)
    train_cli_main(["--config", CONFIG, "--scene", "scene", *port])
    final = re.search(r"final val: \{'val_psnr': ([-+0-9.eE]+)\}", caplog.text)
    logged = [float(x) for x in re.findall(r"step \d+ loss [-0-9.]+ psnr ([-0-9.]+)", caplog.text)]

    j_cfg = jconfig.load_config(CONFIG, cli_overrides=[f"root_dir={tmp_path / 'j'}", *common])
    j_cfg.dataset.scene, j_cfg.expname = "scene", "jax"
    jt, _, _ = j_utils.create_trainer(j_cfg)
    jt.train(num_iterations=STEPS, log_every=1)
    j_val = jt.validate()["val_psnr"]

    # Each package read its own undistortion cache of images_2/; the port
    # wrote nothing under a name that dogs_tpu reads.
    scene_dir = str(data / "scene")
    assert sorted(os.listdir(scene_dir)) == ["images", "images_2", "images_2_undist", "images_2_undist_torch",
                                             "sparse"]
    t_recs = tdataset.load_scene(scene_dir, factor=2, val_interval=0, normalize=False).train_cameras
    j_recs = jdataset.load_scene(scene_dir, factor=2, val_interval=0, normalize=False).train_cameras
    assert len(t_recs) == len(j_recs) == 6
    for rt, rj in zip(t_recs, j_recs):
        assert "images_2_undist_torch" in rt.image_path and "images_2_undist" in rj.image_path
        np.testing.assert_array_equal(rt.load(), rj.load())

    expname = "gs_novel_view_synthesis_urban3d_scene"
    state = load_jax_train_state(str(tmp_path / "out" / expname / "model" / "model.npz"), "cpu")
    assert state.step == STEPS and final is not None
    assert len(logged) == STEPS
    for a, b in zip(logged, [m["psnr"] for m in jt.metrics_history]):
        assert abs(a - b) <= PSNR_STEP_TOL + 0.005, (a, b)  # the log prints 2 decimals
    assert abs(float(final.group(1)) - j_val) < PSNR_STEP_TOL, (final.group(1), j_val)
    js, cfg = jt.state, jt.cfg
    bar = {k: LR_FRACTION * STEPS * lr for k, lr in dict(
        xyz=cfg.position_lr_init * jt.spatial_lr_scale, feat_dc=cfg.feature_lr, log_scale=cfg.scaling_lr,
        quat=cfg.quaternion_lr, logit_opacity=cfg.opacity_lr, exposure=cfg.exposure_lr_init,
        pose_deltas=cfg.pose_lr, mask=cfg.mask_lr).items()}
    alive = np.asarray(js.model.alive)
    np.testing.assert_array_equal(state.model.alive.numpy(), alive)
    for k in ("xyz", "feat_dc", "log_scale", "quat", "logit_opacity"):
        np.testing.assert_allclose(getattr(state.model.params, k).detach().numpy()[alive],
                                   np.asarray(getattr(js.model.params, k))[alive], rtol=0, atol=bar[k], err_msg=k)
    # The per-image leaves moved, as JAX's did; row 0 belongs to image 0,
    # the val image, and never moves.
    for k in ("exposure", "pose_deltas"):
        got, want = getattr(state, k).numpy(), np.asarray(getattr(js, k))
        np.testing.assert_allclose(got, want, rtol=0, atol=bar[k], err_msg=k)
    np.testing.assert_array_equal(state.exposure.numpy()[0], np.eye(3, 4))
    np.testing.assert_array_equal(state.pose_deltas.numpy()[0], 0.0)
    assert np.abs(state.exposure.numpy()[1:] - np.eye(3, 4)).max() > 0
    assert np.abs(state.pose_deltas.numpy()[1:]).max() > 0
    j_mask = {"/".join(str(p) for p in path): leaf
              for path, leaf in jax.tree_util.tree_flatten_with_path(js.mask_params)[0]}
    for key, leaf in flatten(state.mask_params).items():
        np.testing.assert_allclose(leaf.detach().numpy(), np.asarray(j_mask[key]), rtol=0, atol=bar["mask"],
                                   err_msg=key)

    caplog.clear()
    # urban3d_admm.yaml is a block-parallel config: the eval CLI, as eval.py,
    # routes it to the fused block checkpoint unless told it is one device's.
    eval_cli_main(["--config", CONFIG, "--scene", "scene", *port, "dataset.multi_blocks=false", "eval.n_test_poses=2"])
    metrics = os.path.join(tmp_path, "out", expname, "eval", "val", "metrics.json")
    with open(metrics) as f:
        got = json.load(f)["mean"]
    assert abs(got["psnr"] - float(final.group(1))) < 1e-4, (got["psnr"], final.group(1))
    assert torch.isfinite(torch.tensor(got["lpips_uncalibrated"]))


def test_written_scene_carries_its_truth(tmp_path):
    """tools/colmap_scene.py: the stored poses corrected by the returned
    deltas (R' = dR R, t' = dR t + dt, the trainer's convention) are the
    rendering cameras; image 0 is unperturbed; the files load at factor 2."""
    from dogs_tpu_torch.core.transforms import se3_exp
    from dogs_tpu_torch.tools import colmap_scene

    cams = colmap_scene.make_cameras(4, 48, 36, 40.0, device="cpu")
    truth = colmap_scene.write_scene(str(tmp_path / "scene"), synthetic.bench_scene(300, device="cpu"), cams)
    np.testing.assert_array_equal(truth["exposure"][0], np.eye(3, 4))
    assert not truth["pose_delta"][0].any() and np.abs(truth["pose_delta"][1:]).min(axis=1).max() > 0
    data = tdataset.load_scene(str(tmp_path / "scene"), factor=2, val_interval=0, normalize=False)
    assert [(r.width, r.height, r.image_index) for r in data.train_cameras] == [(48, 36, i) for i in range(4)]
    assert "images_2_torch_undist_torch" in data.train_cameras[0].image_path
    for rec, cam, delta in zip(data.train_cameras, cams, truth["pose_delta"]):
        dR, dt = (a.numpy() for a in se3_exp(torch.as_tensor(delta, dtype=torch.float64)))
        np.testing.assert_allclose(dR @ rec.R, cam.R.numpy(), atol=1e-6)
        np.testing.assert_allclose(dR @ rec.t + dt, cam.t.numpy(), atol=1e-6)
        np.testing.assert_allclose([rec.fx, rec.cx, rec.cy], [40.0, 24.0, 18.0], rtol=1e-9)
        assert rec.load().shape == (36, 48, 3)


def test_colmap_scene_cli_writes_a_loadable_scene(tmp_path, monkeypatch, capsys):
    """`python -m dogs_tpu_torch.tools.colmap_scene OUT --device cpu`, at a
    smaller scene than the CLI's own: the images and model it reports."""
    from dogs_tpu_torch.tools import colmap_scene

    for name, value in dict(CLI_GAUSSIANS=200, CLI_IMAGES=3, CLI_WIDTH=40, CLI_HEIGHT=30).items():
        monkeypatch.setattr(colmap_scene, name, value)
    colmap_scene.main([str(tmp_path), "--device", "cpu"])
    assert "wrote 3 images of 80x60" in capsys.readouterr().out
    data = tdataset.load_scene(str(tmp_path / "scene"), factor=2, val_interval=0, normalize=False)
    assert [(r.width, r.height) for r in data.train_cameras] == [(40, 30)] * 3
    assert data.points.shape == (200, 3) and np.isfinite(data.points).all()
