"""The per-image loss terms against dogs_tpu: the VastGaussian appearance
mask CNN (forward, gradients, pixel-shuffle order), the SO(3)/SE(3)
exponentials of pose refinement, one train step with the trained exposure,
the mask and pose refinement on (alone and together), the pose gauge, and
checkpoints that carry the trained per-image leaves, both ways. JAX runs on
the CPU with the XLA raster path; the same numpy inputs go to both packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dogs_tpu.core import transforms as jtf
from dogs_tpu.data.synthetic import make_scene as j_make_scene
from dogs_tpu.fields import appearance as ja
from dogs_tpu.fields import model as jmodel
from dogs_tpu.train import optim as joptim
from dogs_tpu.train import trainer as jtrainer
from dogs_tpu.train.checkpoint import _flatten_with_paths, load_pytree, save_pytree
from dogs_tpu_torch.core import gaussians as tgs
from dogs_tpu_torch.core import transforms as ttf
from dogs_tpu_torch.data import synthetic
from dogs_tpu_torch.fields import appearance as ta
from dogs_tpu_torch.fields import model as tmodel
from dogs_tpu_torch.train import optim as toptim
from dogs_tpu_torch.train import trainer as ttrainer
from dogs_tpu_torch.train.checkpoint import load_jax_train_state, load_train_state, save_train_state, train_state_arrays
from tests.test_torch_core import jax_params
from tests.test_torch_train import J_RASTER, T_RASTER, trainer_cfg, warm_state_arrays

NAMES = tgs.PARAM_NAMES
FWD_TOL = 1e-5  # mask forward, max-normalized
GRAD_ATOL = 2e-3  # max-normalized gradient bar of tests/test_pallas_blend.py:58-61


def np_(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def max_close(got, want, atol, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=atol, err_msg=name)


# ---- the mask CNN -------------------------------------------------------------


def test_init_draws_dogs_tpu_weights():
    jp = ja.init_appearance_params(5)
    got = ta.flatten(ta.init_appearance_arrays(5))
    want = dict((("/".join(str(p) for p in path)), leaf) for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0])
    assert list(got) == list(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)


@pytest.mark.parametrize("hw", [(80, 96), (48, 64), (100, 70)], ids=["96x80", "64x48", "70x100"])
def test_apply_appearance_matches_jax(hw):
    rng = np.random.RandomState(hw[0])
    arrays = ta.init_appearance_arrays(4, np.random.RandomState(1))
    img = rng.rand(*hw, 3).astype(np.float32)
    want = ja.apply_appearance(jax.tree.map(jnp.asarray, arrays), jnp.asarray(img), jnp.int32(2))
    got = ta.apply_appearance(ta.appearance_params_from_numpy(arrays, "cpu"), torch.from_numpy(img), 2)
    assert got.shape == hw + (3,)
    max_close(np_(got), want, FWD_TOL, "mask")


@pytest.mark.parametrize("index", [1, 7], ids=["row", "past_last_row"])
def test_appearance_gradients_match_jax(index):
    """Parameter and input gradients of sum(mask * cot) + the loss terms; an
    index past the embedding's rows reads (and trains) its last row."""
    rng = np.random.RandomState(3)
    arrays = ta.init_appearance_arrays(4, np.random.RandomState(2))
    arrays["embed"] = arrays["embed"] + rng.randn(*arrays["embed"].shape).astype(np.float32) * 0.3
    img = rng.rand(80, 96, 3).astype(np.float32)
    gt = rng.rand(80, 96, 3).astype(np.float32)
    cot = rng.randn(80, 96, 3).astype(np.float32)

    def j_loss(p, x):
        mask = ja.apply_appearance(p, x, jnp.int32(index))
        l1, reg = ja.appearance_loss_terms(mask, x, jnp.asarray(gt), 0.5)
        return jnp.sum(mask * cot) + l1 + reg

    jg_p, jg_x = jax.grad(j_loss, argnums=(0, 1))(jax.tree.map(jnp.asarray, arrays), jnp.asarray(img))
    tp = ta.appearance_params_from_numpy(arrays, "cpu")
    tx = torch.tensor(img, requires_grad=True)
    mask = ta.apply_appearance(tp, tx, index)
    l1, reg = ta.appearance_loss_terms(mask, tx, torch.from_numpy(gt), 0.5)
    leaves = ta.flatten(tp)
    grads = torch.autograd.grad((mask * torch.from_numpy(cot)).sum() + l1 + reg, list(leaves.values()) + [tx])
    want = dict(("/".join(str(p) for p in path), g) for path, g in jax.tree_util.tree_flatten_with_path(jg_p)[0])
    for (k, _), g in zip(leaves.items(), grads[:-1]):
        max_close(np_(g), want[k], GRAD_ATOL, k)
    max_close(np_(grads[-1]), jg_x, GRAD_ATOL, "input")
    used = min(index, 3)
    assert np.abs(np_(grads[list(leaves).index("['embed']")])[used]).max() > 0


def test_pixel_shuffle_keeps_the_jax_channel_order():
    """Asymmetric input: every channel distinct. dogs_tpu's order is not
    F.pixel_shuffle's."""
    x = np.random.RandomState(0).randn(1, 3, 5, 12).astype(np.float32)  # NHWC, C = 3 * 2 * 2
    want = np.asarray(ja._pixel_shuffle(jnp.asarray(x)))  # (1, 6, 10, 3)
    got = ta._pixel_shuffle(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)
    torch_order = F.pixel_shuffle(torch.from_numpy(x).permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1).numpy()
    assert not np.array_equal(torch_order, want)


# ---- pose exponentials ----------------------------------------------------------


@pytest.mark.parametrize("scale", [0.0, 1e-6, 0.3, 2.5])
def test_so3_se3_exp_match_jax(scale):
    """Values and gradients, finite at zero (pose deltas start there)."""
    rng = np.random.RandomState(int(scale * 10) + 1)
    xi = (rng.randn(5, 6) * scale).astype(np.float32)
    w = rng.randn(5, 3, 3).astype(np.float32)  # cotangents
    v = rng.randn(5, 3).astype(np.float32)

    def j_f(x):
        R, t = jtf.se3_exp(x)
        return jnp.sum(R * w) + jnp.sum(t * v)

    jR, jt = jtf.se3_exp(jnp.asarray(xi))
    jg = jax.grad(j_f)(jnp.asarray(xi))
    tx = torch.tensor(xi, requires_grad=True)
    tR, tt = ttf.se3_exp(tx)
    (tg,) = torch.autograd.grad((tR * torch.from_numpy(w)).sum() + (tt * torch.from_numpy(v)).sum(), [tx])
    np.testing.assert_allclose(np_(tR), np.asarray(jR), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(np_(tt), np.asarray(jt))
    assert np.isfinite(np_(tg)).all()
    np.testing.assert_allclose(np_(tg), np.asarray(jg), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np_(ttf.so3_exp(tx[:, 3:])), np.asarray(jtf.so3_exp(jnp.asarray(xi[:, 3:]))),
                               rtol=1e-6, atol=1e-6)


# ---- one train step with the terms on --------------------------------------------


@pytest.fixture(scope="module")
def scene():
    kw = dict(n_gaussians=80, n_cams=4, width=64, height=48, seed=3)
    js = j_make_scene(raster_cfg=J_RASTER, **kw)
    ts = synthetic.make_scene(**kw, device="cpu")
    return js, ts


def per_image_arrays(n_images: int, mask: bool, rng) -> dict:
    """Per-image state moved off its init, with moments (nu > 0) drawn from
    numpy, so that no Adam update sits on a sign flip of f32 noise."""
    out = dict(
        exposure=(np.eye(3, 4)[None] + rng.randn(n_images, 3, 4) * 0.05).astype(np.float32),
        exposure_mu=(rng.randn(n_images, 3, 4) * 1e-3).astype(np.float32),
        exposure_nu=(rng.rand(n_images, 3, 4) * 1e-4 + 1e-5).astype(np.float32),
        pose_deltas=(rng.randn(n_images, 6) * 1e-3).astype(np.float32),
        pose_mu=(rng.randn(n_images, 6) * 1e-3).astype(np.float32),
        pose_nu=(rng.rand(n_images, 6) * 1e-4 + 1e-5).astype(np.float32),
    )
    if mask:
        p = ta.init_appearance_arrays(n_images)
        flat = ta.flatten(p)
        out["mask_params"] = p
        out["mask_mu"] = {k: (rng.randn(*a.shape) * 1e-4).astype(np.float32) for k, a in flat.items()}
        out["mask_nu"] = {k: (rng.rand(*a.shape) * 1e-6 + 1e-7).astype(np.float32) for k, a in flat.items()}
    return out


def unflatten(flat: dict) -> dict:
    tree = {}
    for key, v in flat.items():
        *parents, name = [part[2:-2] for part in key.split("/")]
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = v
    return tree


def step_states(scene, cfg: dict, n_images: int, step0: int, seed: int):
    """The same warm TrainState in both packages."""
    params, alive, mu, nu, stats = warm_state_arrays(scene, np.random.RandomState(seed))
    rng = np.random.RandomState(seed + 1)
    extra = per_image_arrays(n_images, cfg.get("use_appearance_mask", False), rng)
    jstate = jtrainer.train_state_from_model(
        jmodel.GaussianModelState(params=jax_params(params), alive=jnp.asarray(alive),
                                  **{k: jnp.asarray(v) for k, v in stats.items()}),
        n_images, jtrainer.TrainerConfig(**cfg),
    )
    jextra = {k: jnp.asarray(v) for k, v in extra.items() if not k.startswith("mask")}
    if "mask_params" in extra:
        jextra.update(mask_params=jax.tree.map(jnp.asarray, extra["mask_params"]),
                      mask_mu=jax.tree.map(jnp.asarray, unflatten(extra["mask_mu"])),
                      mask_nu=jax.tree.map(jnp.asarray, unflatten(extra["mask_nu"])))
    jstate = jstate.replace(opt=joptim.SparseAdamState(mu=jax_params(mu), nu=jax_params(nu)),
                            step=jnp.int32(step0), **jextra)
    tstate = ttrainer.train_state_from_model(
        tmodel.GaussianModelState(params=tgs.params_from_numpy(params, "cpu"), alive=torch.from_numpy(alive.copy()),
                                  **{k: torch.from_numpy(v.copy()) for k, v in stats.items()}),
        n_images, ttrainer.TrainerConfig(**cfg),
    )
    textra = {k: torch.from_numpy(v.copy()) for k, v in extra.items() if not k.startswith("mask")}
    if "mask_params" in extra:
        textra.update(mask_params=ta.appearance_params_from_numpy(extra["mask_params"], "cpu"),
                      mask_mu=_tree_tensors(unflatten(extra["mask_mu"])),
                      mask_nu=_tree_tensors(unflatten(extra["mask_nu"])))
    tstate = dataclasses.replace(
        tstate, step=step0, **textra,
        opt=toptim.SparseAdamState(mu={k: torch.from_numpy(v.copy()) for k, v in mu.items()},
                                   nu={k: torch.from_numpy(v.copy()) for k, v in nu.items()}),
    )
    return jstate, tstate, extra


def _tree_tensors(tree: dict) -> dict:
    return {k: _tree_tensors(v) if isinstance(v, dict) else torch.from_numpy(np.array(v)) for k, v in tree.items()}


def assert_adam_close(t_p, j_p, t_mu, j_mu, t_nu, j_nu, mu_old, lr, name):
    """The gradient (recovered from the new first moment) at the max-normalized
    bar, the moments at test_torch_train.py's bars, and the new values within
    1e-2 of the learning rate (an Adam step moves each element by about lr)."""
    j_mu, t_mu = np.asarray(j_mu), np_(t_mu)
    max_close((t_mu - 0.9 * mu_old) / 0.1, (j_mu - 0.9 * mu_old) / 0.1, GRAD_ATOL, f"grad {name}")
    np.testing.assert_allclose(t_mu, j_mu, rtol=1e-3, atol=2e-3 * np.abs(j_mu).max(), err_msg=f"mu {name}")
    j_nu, t_nu = np.asarray(j_nu), np_(t_nu)
    np.testing.assert_allclose(t_nu, j_nu, rtol=1e-3, atol=2e-3 * np.abs(j_nu).max(), err_msg=f"nu {name}")
    np.testing.assert_allclose(np_(t_p), np.asarray(j_p), rtol=0, atol=1e-2 * lr + 1e-7, err_msg=f"param {name}")


TERMS = {
    "exposure": dict(use_trained_exposure=True),
    "mask": dict(use_appearance_mask=True, lambda_mask=0.5, mask_lr=1e-3),
    "pose": dict(optimize_camera_poses=True, pose_lr=1e-3, opt_pose_start_iter=2),
    "all": dict(use_trained_exposure=True, use_appearance_mask=True, lambda_mask=0.5, optimize_camera_poses=True,
                pose_lr=1e-3, opt_pose_start_iter=2),
}


@pytest.mark.parametrize("term", list(TERMS))
def test_train_step_with_terms_matches_jax(scene, term):
    """One step from a warm state on camera 1 at step 3, every leaf against
    dogs_tpu's make_train_step. (A camera past the last row of per-image
    state, which reads the last row and writes nothing in both packages, is
    held against dogs_tpu by tests/test_torch_scene.py and the gradient test
    above.)"""
    n_images = 4
    js, ts = scene
    cfg = trainer_cfg(**TERMS[term])
    step0, deg, bg, lr_scale = 3, 2, (0.0, 0.0, 0.0), 4.4
    jstate, tstate, extra = step_states(scene, cfg, n_images, step0, seed=5)
    jstep = jtrainer.make_train_step(jtrainer.TrainerConfig(**cfg), J_RASTER, lr_scale, deg, bg)
    jnew, jm = jstep(jstate, js.cameras[1], js.images[1])
    tstep = ttrainer.make_train_step(ttrainer.TrainerConfig(**cfg), T_RASTER, lr_scale, deg, bg)
    tnew, tm = tstep(tstate, ts.cameras[1], ts.images[1])

    for k in ("loss", "l1", "ssim", "psnr", "scale_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    assert int(tm["n_visible"]) == int(jm["n_visible"])
    for k in NAMES:
        np.testing.assert_allclose(np_(getattr(tnew.model.params, k)), np.asarray(getattr(jnew.model.params, k)),
                                   rtol=0, atol=2e-5, err_msg=f"param {k}")
    tcfg = ttrainer.TrainerConfig(**cfg)
    exposure_lr = ttrainer.make_lr_schedules(tcfg, lr_scale)[1](step0)
    for name, lr, on in (("exposure", exposure_lr, tcfg.use_trained_exposure),
                         ("pose", tcfg.pose_lr, tcfg.optimize_camera_poses)):
        p, mu, nu = (("exposure", "exposure_mu", "exposure_nu") if name == "exposure"
                     else ("pose_deltas", "pose_mu", "pose_nu"))
        if on:
            assert_adam_close(getattr(tnew, p), getattr(jnew, p), getattr(tnew, mu), getattr(jnew, mu),
                              getattr(tnew, nu), getattr(jnew, nu), extra[mu], lr, name)
        if not on:  # untouched
            for key in (p, mu, nu):
                np.testing.assert_array_equal(np_(getattr(tnew, key)), extra[key], err_msg=key)
                np.testing.assert_array_equal(np.asarray(getattr(jnew, key)), extra[key], err_msg=key)
    if tcfg.use_appearance_mask:
        jflat = {"/".join(str(x) for x in path): leaf
                 for path, leaf in jax.tree_util.tree_flatten_with_path(jnew.mask_params)[0]}
        jmu = {"/".join(str(x) for x in path): leaf
               for path, leaf in jax.tree_util.tree_flatten_with_path(jnew.mask_mu)[0]}
        jnu = {"/".join(str(x) for x in path): leaf
               for path, leaf in jax.tree_util.tree_flatten_with_path(jnew.mask_nu)[0]}
        tmu, tnu = ta.flatten(tnew.mask_mu), ta.flatten(tnew.mask_nu)
        for k, p in ta.flatten(tnew.mask_params).items():
            assert_adam_close(p, jflat[k], tmu[k], jmu[k], tnu[k], jnu[k], extra["mask_mu"][k], tcfg.mask_lr, k)
    else:
        assert tnew.mask_params == {} and jnew.mask_params == {}


def test_pose_gauge_holds_camera_0_and_waits_for_the_start(scene):
    """Before opt_pose_start_iter, and for image 0 at any step, the pose row
    stays at zero while its moments move."""
    _, ts = scene
    cfg = ttrainer.TrainerConfig(**trainer_cfg(optimize_camera_poses=True, pose_lr=1e-2, opt_pose_start_iter=2))
    model = tmodel.init_from_points(ts.points, ts.colors, 128, 2, "cpu")
    state = ttrainer.train_state_from_model(model, 4, cfg)
    step = ttrainer.make_train_step(cfg, T_RASTER, 4.4, 2, (0.0, 0.0, 0.0))
    for cam_i in (1, 0, 0, 0):  # steps 0 (before the start), 1, 2 and 3 on camera 0
        state, _ = step(state, ts.cameras[cam_i], ts.images[cam_i])
    poses, mu = np_(state.pose_deltas), np_(state.pose_mu)
    assert np.all(poses[:2] == 0.0) and np.abs(mu[:2]).min(axis=1).max() > 0
    state, _ = step(state, ts.cameras[1], ts.images[1])  # step 4: camera 1 moves
    assert np.abs(np_(state.pose_deltas)[1]).max() > 0 and np.all(np_(state.pose_deltas)[0] == 0.0)


# ---- checkpoints with the trained leaves ------------------------------------------


def test_checkpoints_with_trained_leaves_load_both_ways(scene, tmp_path):
    cfg = trainer_cfg(use_trained_exposure=True, use_appearance_mask=True, optimize_camera_poses=True)
    jstate, tstate, _ = step_states(scene, cfg, 3, 9, seed=8)
    want = _flatten_with_paths(jstate)[0]
    got = train_state_arrays(tstate)
    assert list(got) == list(want)
    assert any(k.startswith(".mask_params/['up3']/['w']") for k in got)
    for k, a in want.items():
        assert (got[k].shape, got[k].dtype) == (a.shape, a.dtype), k
        np.testing.assert_array_equal(got[k], a, err_msg=k)
    # port -> JAX
    save_train_state(str(tmp_path / "port.npz"), tstate, {"step": 9})
    loaded, _ = load_pytree(str(tmp_path / "port.npz"), jstate)
    for (k, a), (_, b) in zip(_flatten_with_paths(loaded)[0].items(), want.items()):
        np.testing.assert_array_equal(a, b, err_msg=k)
    # JAX -> port, with and without a template
    save_pytree(str(tmp_path / "jax.npz"), jstate, {"step": 9})
    for state in (load_jax_train_state(str(tmp_path / "jax.npz"), "cpu"),
                  load_train_state(str(tmp_path / "jax.npz"), tstate)[0]):
        back = train_state_arrays(state)
        assert list(back) == list(want)
        for k, a in want.items():
            np.testing.assert_array_equal(back[k], a, err_msg=k)
        assert all(p.requires_grad for p in ta.flatten(state.mask_params).values())
