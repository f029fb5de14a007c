"""Coarse-to-fine training and the profiler hooks against dogs_tpu: the
camera's downsample and pose helpers, the appearance mask at the coarse
frames, the single-device trainer over the 4 -> 2 -> 1 schedule, the ADMM
master's coarse-to-fine cameras and streamed GT, a resume across a regime
switch, and the train CLI with the profiler on. JAX runs on the CPU with the
XLA raster path; the same numpy inputs go to both packages, and dogs_tpu's
PIL resize is replaced by the port's (`resize_image`, within one 8-bit level
of PIL's), so that both trainers see equal GT."""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import dogs_tpu.data.dataset as j_dataset
from dogs_tpu.core import camera as jcamera
from dogs_tpu.data import blocks as jblocks
from dogs_tpu.data.synthetic import make_scene as j_make_scene
from dogs_tpu.fields import appearance as ja
from dogs_tpu.parallel import admm as jadmm
from dogs_tpu.parallel import master as jmaster
from dogs_tpu.train import trainer as jtrainer
from dogs_tpu_torch.core import camera as tcamera
from dogs_tpu_torch.data import blocks, synthetic
from dogs_tpu_torch.data.dataset import resize_image
from dogs_tpu_torch.fields import appearance as ta
from dogs_tpu_torch.parallel import admm, master
from dogs_tpu_torch.train import trainer as ttrainer
from dogs_tpu_torch.train.__main__ import main as cli_main
from dogs_tpu_torch.train.checkpoint import CheckpointManager, train_state_arrays
from tests.test_torch_appearance import FWD_TOL, GRAD_ATOL, max_close
from tests.test_torch_train import J_RASTER, PSNR_STEP_TOL, T_RASTER, trainer_cfg

REPO = Path(__file__).resolve().parents[1]
NAMES = ttrainer.PARAM_NAMES
# Final parameters after 12 steps from the point-cloud init: f32 drift
# through Adam only (tests/test_torch_train.py:test_trainer_densifies_and_
# resets_like_jax's bar).
PARAM_ATOL = 2e-3
# 12 steps at c2f_interval 4: steps 1-3 at factor 4, 4-7 at 2, 8-12 at 1.
C2F = dict(coarse_to_fine=True, densify_end_iter=12, sh_increase_interval=100)
C2F_FACTORS = [4] * 3 + [2] * 4 + [1] * 5


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def equal_gt(monkeypatch):
    """dogs_tpu imports resize_image at the call: its trainers then resize
    with the port's function."""
    monkeypatch.setattr(j_dataset, "resize_image", resize_image)


def np_(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# ---- the camera ----------------------------------------------------------------


@pytest.mark.parametrize("factor", [1, 1.5, 2, 3, 4, 8])
@pytest.mark.parametrize("wh", [(64, 48), (97, 53), (1152, 864), (13, 7)], ids=str)
def test_camera_downsample_and_pose_helpers_match_jax(wh, factor):
    rng = np.random.RandomState(wh[0] + int(10 * factor))
    q = rng.randn(4)
    w, x, y, z = q / np.linalg.norm(q)
    R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                  [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                  [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
    t, (fx, fy) = rng.randn(3), rng.uniform(0.5, 1.5, 2) * wh[0]
    cx, cy = wh[0] / 2 + rng.randn(), wh[1] / 2 + rng.randn()
    jc = jcamera.make_camera(R, t, fx, fy, cx, cy, *wh, image_index=3, near=0.1, far=50.0).downsample(factor)
    tc = tcamera.make_camera(R, t, fx, fy, cx, cy, *wh, image_index=3, near=0.1, far=50.0,
                             device="cpu").downsample(factor)
    assert (tc.width, tc.height, tc.image_index, tc.near, tc.far) == (jc.width, jc.height, 3, 0.1, 50.0)
    for k in ("fx", "fy", "cx", "cy", "R", "t", "world_to_camera", "camera_to_world"):
        np.testing.assert_allclose(np_(getattr(tc, k)), np.asarray(getattr(jc, k)), rtol=1e-6, atol=1e-6, err_msg=k)
    pts = (R.T @ (np.stack([rng.uniform(-1, 1, 50), rng.uniform(-1, 1, 50), rng.uniform(2, 6, 50)]) - t[:, None])).T
    juv, jz = jc.project(jnp.asarray(pts, jnp.float32))
    tuv, tz = tc.project(torch.as_tensor(pts, dtype=torch.float32))
    np.testing.assert_allclose(np_(tz), np.asarray(jz), rtol=1e-6, atol=1e-6)
    # Pixel coordinates at 1e-6 of their largest: the division by depth
    # carries a few f32 ulps of the rotation's sums.
    scale = np.abs(np.asarray(juv)).max()
    np.testing.assert_allclose(np_(tuv) / scale, np.asarray(juv) / scale, rtol=0, atol=1e-6)


# ---- the appearance mask at the coarse frames ---------------------------------------


@pytest.mark.parametrize("hw", [(216, 288), (432, 576)], ids=["288x216", "576x432"])
def test_apply_appearance_at_coarse_frames_matches_jax(hw, monkeypatch):
    """The forward at the appearance bar, and the parameter and input
    gradients at the gradient bar on the port's ReLU branch: JAX takes each
    ReLU's sign as the port computed it. At 576x432 the downsample is 18x13
    at a ratio of 33.2 and the upsample x2 from 288x208; on its own branch
    JAX differs from the port only where a ReLU input lies within f32
    rounding of 0, which moves a gradient by up to ~1e-2 of its leaf's max
    (checked below, not a divergence of either package)."""
    rng = np.random.RandomState(hw[0])
    arrays = ta.init_appearance_arrays(4, np.random.RandomState(1))
    img, cot = rng.rand(*hw, 3).astype(np.float32), rng.randn(*hw, 3).astype(np.float32)
    relu, branch = torch.relu, []
    # The signs in JAX's NHWC layout.
    monkeypatch.setattr(torch, "relu", lambda z: branch.append((z > 0).permute(0, 2, 3, 1).numpy()) or relu(z))
    tp = ta.appearance_params_from_numpy(arrays, "cpu")
    tx = torch.tensor(img, requires_grad=True)
    mask = ta.apply_appearance(tp, tx, 2)
    leaves = ta.flatten(tp)
    grads = torch.autograd.grad((mask * torch.from_numpy(cot)).sum(), list(leaves.values()) + [tx])
    monkeypatch.setattr(torch, "relu", relu)

    def j_grads(p, x):
        return jnp.sum(ja.apply_appearance(p, x, jnp.int32(2)) * cot)

    jp = jax.tree.map(jnp.asarray, arrays)
    max_close(np_(mask), ja.apply_appearance(jp, jnp.asarray(img), jnp.int32(2)), FWD_TOL, "mask")
    patterns = iter(branch)
    monkeypatch.setattr(jax.nn, "relu", lambda z: z * jnp.asarray(next(patterns), z.dtype))
    jg_p, jg_x = jax.grad(j_grads, argnums=(0, 1))(jp, jnp.asarray(img))
    want = {"/".join(str(p) for p in path): g for path, g in jax.tree_util.tree_flatten_with_path(jg_p)[0]}
    assert next(patterns, None) is None and len(branch) == 1 + ta.UPSTAGES
    for (k, _), g in zip(leaves.items(), grads[:-1]):
        max_close(np_(g), want[k], GRAD_ATOL, k)
    max_close(np_(grads[-1]), jg_x, GRAD_ATOL, "input")


# ---- the single-device trainer ------------------------------------------------------


@pytest.fixture(scope="module")
def c2f_scenes():
    kw = dict(n_gaussians=80, n_cams=10, width=64, height=48, seed=3)
    return j_make_scene(raster_cfg=J_RASTER, **kw), synthetic.make_scene(**kw, device="cpu")


def c2f_trainers(scenes, **kw):
    """dogs_tpu's and the port's trainer on the scene's first 8 cameras, with
    the JAX scene's images (equal inputs), coarse-to-fine on."""
    js, ts = scenes
    cfg = trainer_cfg(**C2F, **kw)
    images = [np.array(im) for im in js.images[:8]]
    jt = jtrainer.GaussianSplatTrainer(js.cameras[:8], images, js.points, js.colors, jtrainer.TrainerConfig(**cfg),
                                       J_RASTER, seed=42)
    tt = ttrainer.GaussianSplatTrainer(ts.cameras[:8], images, ts.points, ts.colors, ttrainer.TrainerConfig(**cfg),
                                       T_RASTER, seed=42, device="cpu")
    return jt, tt


def test_coarse_to_fine_trainer_tracks_jax(c2f_scenes, equal_gt):
    """12 steps through factors 4, 2 and 1 (16x12, 32x24, 64x48): the same
    cameras and GT each step, the per-step train PSNR within the trainer
    bar, the final parameters within PARAM_ATOL, and GT cached per (image,
    factor)."""
    jt, tt = c2f_trainers(c2f_scenes)
    assert [tt.training_resolution(s) for s in range(1, 13)] == C2F_FACTORS
    assert [jt.training_resolution(s) for s in range(1, 13)] == C2F_FACTORS
    for trainer in (jt, tt):
        trainer.train(num_iterations=12, log_every=1)
    assert jt._order == tt._order
    for a, b in zip(jt.metrics_history, tt.metrics_history):
        assert abs(a["psnr"] - b["psnr"]) < PSNR_STEP_TOL, (a["step"], a["psnr"], b["psnr"])
    assert sorted(tt._gt_cache) == sorted(jt._gt_cache)
    assert {res for _, res in tt._gt_cache} == {1, 2, 4}
    for key, gt in tt._gt_cache.items():
        np.testing.assert_array_equal(np_(gt), np.asarray(jt._gt_cache[key]), err_msg=str(key))
    assert tuple(tt._gt_cache[next(k for k in tt._gt_cache if k[1] == 4)].shape) == (12, 16, 3)
    alive = np.asarray(jt.state.model.alive)
    np.testing.assert_array_equal(np_(tt.state.model.alive), alive)
    for k in NAMES:
        np.testing.assert_allclose(np_(getattr(tt.state.model.params, k))[alive],
                                   np.asarray(getattr(jt.state.model.params, k))[alive], rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)


def test_resume_across_a_regime_switch_is_bit_for_bit(c2f_scenes, tmp_path):
    """A checkpoint after step 5 (factor 2) resumed in a fresh trainer
    through the 2 -> 1 switch at step 8 to step 10 equals the uninterrupted
    run, leaf for leaf."""
    _, tt = c2f_trainers(c2f_scenes)
    tt.train(num_iterations=5, log_every=0)
    path = tt.save_checkpoint(CheckpointManager(str(tmp_path)))
    tt.train(num_iterations=5, log_every=0)
    _, resumed = c2f_trainers(c2f_scenes)
    assert resumed.load_checkpoint(CheckpointManager(str(tmp_path)), path) == 5
    resumed.train(num_iterations=5, log_every=0)
    a, b = train_state_arrays(tt.state), train_state_arrays(resumed.state)
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert resumed._order == tt._order


# ---- the ADMM master ------------------------------------------------------------------


def test_master_coarse_to_fine_stages_as_dogs_tpu(equal_gt):
    """The port's MasterTrainer and dogs_tpu's on the same 2x2 blocks with
    coarse-to-fine (c2f_interval 3: factors 4, 2, 1 over 9 master steps):
    each block's camera order, its downsampled camera and, at factors 4
    and 2, its GT (resized in f32, then encoded to uint8) equal dogs_tpu's
    staged chunk; the resident pool serves factor 1, and the port's block
    steps run at each factor."""
    kw = dict(n_gaussians=64, n_cams=12, width=48, height=40, seed=51)
    js = j_make_scene(raster_cfg=J_RASTER, **kw)
    ts = synthetic.make_scene(**kw, device="cpu")
    cam_pos = np.stack([np.asarray(c.camera_center) for c in js.cameras])
    part = blocks.partition_scene(cam_pos, js.points, 2, 2, (1.6, 1.6))
    j_part = jblocks.partition_scene(cam_pos, js.points, 2, 2, (1.6, 1.6))
    images = [np.array(im) for im in js.images]
    labels = part.camera_labels
    np.testing.assert_array_equal(labels, j_part.camera_labels)
    sel = [[i for i in range(len(labels)) if labels[i] == k] for k in range(4)]
    assert all(sel), sel
    pts = [js.points[: 8 + k] for k in range(4)]
    cols = [js.colors[: 8 + k] for k in range(4)]
    cfg = trainer_cfg(coarse_to_fine=True, densify_end_iter=9, sh_increase_interval=100)
    jm = jmaster.MasterTrainer(Mesh(np.asarray(jax.devices()[:4]), ("block",)), j_part, pts, cols,
                               [[js.cameras[i] for i in s] for s in sel], [[images[i] for i in s] for s in sel],
                               jtrainer.TrainerConfig(**cfg), J_RASTER, jadmm.AdmmConfig(), spatial_lr_scale=4.0)
    tm = master.MasterTrainer(part, pts, cols, [[ts.cameras[i] for i in s] for s in sel],
                              [[images[i] for i in s] for s in sel], ttrainer.TrainerConfig(**cfg), T_RASTER,
                              admm.AdmmConfig(), spatial_lr_scale=4.0, device="cpu")
    assert all(p is not None for p in tm._gt_pool)
    for step in range(1, 10):
        res = tm.training_resolution(step)
        assert res == jm.training_resolution(step) == [4, 2, 1, 1][step // 3]
        j_cam, j_gt = jm._stage_chunk(1, res)
        for kb in range(4):
            i = tm._next_camera(kb)
            cam = tm.block_cameras[kb][i].downsample(res) if res > 1 else tm.block_cameras[kb][i]
            assert int(np.asarray(j_cam.image_index)[0, kb]) == cam.image_index == i
            assert (cam.width, cam.height) == (j_cam.width, j_cam.height)
            for f in ("fx", "fy", "cx", "cy"):
                np.testing.assert_allclose(np_(getattr(cam, f)), np.asarray(getattr(j_cam, f))[0, kb], rtol=1e-6)
            gt = tm._gt(kb, i, res)
            enc = np_(tm._gt_pool[kb][i]) if res == 1 else np_(tm._gt_cache[(kb, i, res)])
            if res > 1:
                np.testing.assert_array_equal(enc, np.asarray(j_gt)[0, kb])
            np.testing.assert_array_equal(np_(gt), enc.astype(np.float32) * np.float32(1 / 255))
        tm.step = step
    assert {res for *_, res in tm._gt_cache} == {4, 2}
    # The port's block steps at every factor, from the start.
    tm2 = master.MasterTrainer(part, pts, cols, [[ts.cameras[i] for i in s] for s in sel],
                               [[images[i] for i in s] for s in sel], ttrainer.TrainerConfig(**cfg), T_RASTER,
                               admm.AdmmConfig(consensus_interval=3), spatial_lr_scale=4.0, device="cpu")
    for _ in range(3):
        out = tm2.train_iteration()
        assert np.isfinite(out["loss"])
    assert tm2.step == 9 and tm2.admm_enabled


# ---- the profiler ---------------------------------------------------------------------


def test_train_cli_coarse_to_fine_with_the_profiler(tmp_path, caplog):
    """The train CLI with geometry.coarse-to-fine and the profiler over
    steps 2-3 (across the 4 -> 2 switch of c2f_interval 3): one Chrome
    trace with a train_step span for each traced step, logged as dogs_tpu
    logs it, and a final state equal to the unprofiled run's, bit for bit."""
    common = ["--config", str(REPO / "config" / "gaussian_splatting" / "synthetic_smoke.yaml"), "device=cpu",
              "trainer.max_iterations=6", "geometry.densify_end_iter=9", "geometry.coarse-to-fine=true"]
    prof_dir = tmp_path / "profile"
    caplog.set_level("INFO")
    cli_main(common + [f"root_dir={tmp_path / 'plain'}"])
    cli_main(common + [f"root_dir={tmp_path / 'traced'}", "trainer.profile.start_step=2",
                       "trainer.profile.num_steps=2", f"trainer.profile.dir={prof_dir}"])
    traces = sorted(prof_dir.glob("*.json"))
    assert [p.name for p in traces] == ["trace_steps_2_3.json"]
    assert f"profiler trace written to {traces[0]}" in caplog.text
    events = json.loads(traces[0].read_text())["traceEvents"]
    spans = sorted({e["name"] for e in events if e.get("name", "").startswith("train_step_")})
    assert spans == ["train_step_2", "train_step_3"]
    run = "gs_novel_view_synthesis_synthetic_toy/model/model.npz"
    with np.load(tmp_path / "plain" / run) as a, np.load(tmp_path / "traced" / run) as b:
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
