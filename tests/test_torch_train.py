"""The training slice against dogs_tpu: learning-rate schedules, sparse Adam,
densify statistics, KNN and point-cloud init, the SSIM gradient, one whole
train step from a warm state, the trainer over 30 steps across densify
events and an opacity reset, and loading a JAX trainer checkpoint. JAX runs
on the CPU with the XLA raster path; the same numpy inputs go to both
packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dogs_tpu.core.knn import _exact_knn_mean_sq
from dogs_tpu.core.knn import mean_knn_dist_sq as j_knn
from dogs_tpu.core.knn import morton_codes as j_morton_codes
from dogs_tpu.data.synthetic import make_scene as j_make_scene
from dogs_tpu.fields import model as jmodel
from dogs_tpu.raster.ssim import ssim as j_ssim
from dogs_tpu.raster.tiled import RasterConfig as JRasterConfig
from dogs_tpu.train import optim as joptim
from dogs_tpu.train import trainer as jtrainer
from dogs_tpu.train.checkpoint import save_pytree
from dogs_tpu_torch.core import gaussians as tgs
from dogs_tpu_torch.core.knn import mean_knn_dist_sq, morton_codes
from dogs_tpu_torch.data import synthetic
from dogs_tpu_torch.fields import model as tmodel
from dogs_tpu_torch.raster.ssim import ssim
from dogs_tpu_torch.raster.tiled import RasterConfig
from dogs_tpu_torch.train import optim as toptim
from dogs_tpu_torch.train import trainer as ttrainer
from dogs_tpu_torch.train.checkpoint import load_jax_train_state
from tests.test_torch_core import jax_params

NAMES = tgs.PARAM_NAMES
J_RASTER = JRasterConfig(tile_batch=16, chunk=32)  # XLA path, as tests/test_trainer_e2e.py
T_RASTER = RasterConfig()
GRAD_ATOL = 2e-3  # max-normalized gradient bar of tests/test_pallas_blend.py:58-61
# Per-step train PSNR: both trainers see the same cameras and the same math;
# only f32 rounding (summation order in blend, SSIM, reduce) differs and it
# drifts slowly through Adam. Measured <= 1e-4 dB over 30 steps on the CPU.
PSNR_STEP_TOL = 0.01
VAL_TOL = 0.2  # dB, final validate()
# The host events of the trainer run: densify at steps 10, 20 and 30 (clones
# and a split at 10, clones at 20, the prune of the reset opacities at 30),
# the opacity reset at 20; capacity stays 128. The threshold sits well
# above the f32 noise of the mean screen gradients (~1e-2 at most here), so
# no Gaussian flips between the packages. Grow-first capacity on both sides.
EVENTS = dict(densify_start_iter=5, densification_interval=10, opacity_reset_interval=20,
              densify_grad_threshold=8e-3, percent_dense=0.1, reactive_capacity_growth=False)


def np_(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("delay", [0, 50])
def test_exponential_lr_matches(delay):
    kw = dict(lr_delay_steps=delay, lr_delay_mult=0.01)
    j = joptim.exponential_lr(1.6e-4, 1.6e-6, 300, **kw)
    t = toptim.exponential_lr(1.6e-4, 1.6e-6, 300, **kw)
    for step in [0, 1, 7, 49, 50, 150, 299, 300, 450]:
        np.testing.assert_allclose(t(step), float(j(jnp.int32(step))), rtol=2e-6)


def random_leaves(rng, n, k_sh=9):
    shapes = dict(xyz=(n, 3), feat_dc=(n, 1, 3), feat_rest=(n, k_sh - 1, 3), log_scale=(n, 3),
                  quat=(n, 4), logit_opacity=(n, 1))
    return {k: rng.randn(*shapes[k]).astype(np.float32) for k in NAMES}


def test_sparse_adam_step_matches():
    rng = np.random.RandomState(0)
    n = 50
    p, g, m = (random_leaves(rng, n) for _ in range(3))
    v = {k: (rng.rand(*a.shape) * 1e-2).astype(np.float32) for k, a in p.items()}
    visible = rng.rand(n) > 0.3
    lrs = dict(xyz=1e-3, feat_dc=2.5e-3, feat_rest=1.25e-4, log_scale=5e-3, quat=1e-3,
               logit_opacity=0.025)

    jp, js = joptim.sparse_adam_step(
        jax_params(p), jax_params(g),
        joptim.SparseAdamState(mu=jax_params(m), nu=jax_params(v)),
        jnp.asarray(visible), jax_params({k: np.float32(x) for k, x in lrs.items()}),
    )
    tp = tgs.params_from_numpy(p, "cpu")
    ts = toptim.SparseAdamState(
        mu={k: torch.from_numpy(m[k].copy()) for k in NAMES},
        nu={k: torch.from_numpy(v[k].copy()) for k in NAMES},
    )
    toptim.sparse_adam_step(tp, {k: torch.from_numpy(g[k]) for k in NAMES}, ts,
                            torch.from_numpy(visible), lrs)
    for k in NAMES:
        np.testing.assert_allclose(np_(getattr(tp, k)), np.asarray(getattr(jp, k)), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(np_(ts.mu[k]), np.asarray(getattr(js.mu, k)), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(np_(ts.nu[k]), np.asarray(getattr(js.nu, k)), rtol=1e-6, atol=1e-9)
        # Invisible Gaussians keep parameters and moments bit for bit.
        np.testing.assert_array_equal(np_(getattr(tp, k))[~visible], p[k][~visible])
        np.testing.assert_array_equal(np_(ts.mu[k])[~visible], m[k][~visible])


def test_adam_step_matches():
    rng = np.random.RandomState(1)
    p, g, m = (rng.randn(3, 4).astype(np.float32) for _ in range(3))
    v = rng.rand(3, 4).astype(np.float32)
    for step in (0, 5):
        want = joptim.adam_step(*(jnp.asarray(a) for a in (p, g, m, v)), 0.01, jnp.int32(step))
        got = toptim.adam_step(*(torch.from_numpy(a) for a in (p, g, m, v)), 0.01, step)
        for a, b in zip(got, want):
            np.testing.assert_allclose(np_(a), np.asarray(b), rtol=1e-5, atol=1e-7)


def test_update_densify_stats_matches():
    rng = np.random.RandomState(2)
    n = 40
    stats = dict(grad_accum=rng.rand(n), denom=rng.randint(0, 5, n), max_radii2d=rng.rand(n) * 9)
    stats = {k: v.astype(np.float32) for k, v in stats.items()}
    grad = rng.randn(n, 2).astype(np.float32) * 1e-3
    radii = np.where(rng.rand(n) > 0.4, rng.rand(n) * 12, 0.0).astype(np.float32)
    arrays = synthetic.gt_params_arrays(n, seed=2)
    j = jmodel.update_densify_stats(
        jmodel.GaussianModelState(params=jax_params(arrays), alive=jnp.ones(n, bool),
                                  **{k: jnp.asarray(v) for k, v in stats.items()}),
        jnp.asarray(grad), jnp.asarray(radii), 72, 56,
    )
    t = tmodel.GaussianModelState(params=tgs.params_from_numpy(arrays, "cpu"), alive=torch.ones(n, dtype=torch.bool),
                                  **{k: torch.from_numpy(v.copy()) for k, v in stats.items()})
    tmodel.update_densify_stats(t, torch.from_numpy(grad), torch.from_numpy(radii), 72, 56)
    for k in stats:
        np.testing.assert_allclose(np_(getattr(t, k)), np.asarray(getattr(j, k)), rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("n", [5, 300, 2048])
def test_mean_knn_dist_sq_matches_exact_jax(n):
    rng = np.random.RandomState(n)
    pts = (rng.randn(n, 3) * rng.uniform(0.1, 3.0)).astype(np.float32)
    valid = rng.rand(n) > 0.2
    want = np.asarray(jnp.where(valid, _exact_knn_mean_sq(jnp.asarray(pts), jnp.asarray(valid), 3), 0.0))
    got = mean_knn_dist_sq(torch.from_numpy(pts), torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-9)
    np.testing.assert_allclose(got, np.asarray(j_knn(jnp.asarray(pts), jnp.asarray(valid))),
                               rtol=2e-5, atol=1e-9)


@pytest.mark.parametrize("n,masked", [(3000, False), (5000, True)])
def test_windowed_knn_matches_jax(n, masked):
    """Above 2,048 points both packages search +-32 neighbours in Morton
    order: the same codes, the same stable order, the same result up to
    f32 rounding of the sums."""
    rng = np.random.RandomState(n)
    pts = (rng.randn(n, 3) * rng.uniform(0.1, 3.0, 3)).astype(np.float32)
    valid = rng.rand(n) > 0.2 if masked else None
    j_valid = None if valid is None else jnp.asarray(valid)
    t_valid = None if valid is None else torch.from_numpy(valid)
    codes = j_morton_codes(jnp.asarray(pts), j_valid)
    t_codes = morton_codes(torch.from_numpy(pts), t_valid)
    np.testing.assert_array_equal(t_codes.numpy(), np.asarray(codes))
    if masked:
        codes = jnp.where(j_valid, codes, jnp.int32(2**30))
        t_codes = torch.where(t_valid, t_codes, 2**30)
    np.testing.assert_array_equal(torch.sort(t_codes, stable=True).indices.numpy(), np.asarray(jnp.argsort(codes)))
    got = mean_knn_dist_sq(torch.from_numpy(pts), t_valid).numpy()
    np.testing.assert_allclose(got, np.asarray(j_knn(jnp.asarray(pts), j_valid)), rtol=1e-6, atol=0)


def test_init_from_points_and_capacity_helpers_match():
    rng = np.random.RandomState(3)
    pts = rng.randn(100, 3).astype(np.float32)
    cols = rng.rand(100, 3).astype(np.float32)
    cap = tgs.round_up_capacity(100, 64)
    from dogs_tpu.core.gaussians import pad_to_capacity as j_pad
    from dogs_tpu.core.gaussians import round_up_capacity as j_round

    assert cap == j_round(100, 64) == 128
    j = jmodel.init_from_points(jnp.asarray(pts), jnp.asarray(cols), cap, 2)
    t = tmodel.init_from_points(pts, cols, cap, 2, "cpu")
    for k in NAMES:
        np.testing.assert_allclose(np_(getattr(t.params, k)), np.asarray(getattr(j.params, k)),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(np_(t.alive), np.asarray(j.alive))
    for k in ("grad_accum", "denom", "max_radii2d"):
        assert not np_(getattr(t, k)).any()
    jp, tp = j_pad(j.params, 256), tgs.pad_to_capacity(t.params, 256)
    for k in NAMES:
        np.testing.assert_allclose(np_(getattr(tp, k)), np.asarray(getattr(jp, k)), rtol=1e-5, atol=1e-6)


def test_ssim_gradient_matches():
    rng = np.random.RandomState(4)
    a = rng.rand(30, 34, 3).astype(np.float32)
    b = np.clip(a + rng.randn(30, 34, 3).astype(np.float32) * 0.1, 0, 1)
    want = np.asarray(jax.grad(lambda x: j_ssim(x, jnp.asarray(b)))(jnp.asarray(a)))
    x = torch.from_numpy(a).requires_grad_(True)
    (got,) = torch.autograd.grad(ssim(x, torch.from_numpy(b)), [x])
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy() / scale, want / scale, atol=1e-5)


# ---- the step and the trainer -------------------------------------------------


def trainer_cfg(**kw):
    """A short run: SH degree switches at steps 10 and 20, densify and the
    opacity reset past its end."""
    base = dict(max_iterations=400, position_lr_max_steps=400, densify_start_iter=1000,
                densify_end_iter=2000, opacity_reset_interval=10000, sh_increase_interval=10,
                max_sh_degree=2, min_capacity=128)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def scenes():
    kw = dict(n_gaussians=80, n_cams=10, width=64, height=64, seed=3)
    js = j_make_scene(raster_cfg=J_RASTER, **kw)
    ts = synthetic.make_scene(**kw, device="cpu")
    for a, b in zip(js.images, ts.images):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=3e-4)
    np.testing.assert_array_equal(ts.points, js.points)
    return js, ts


def warm_state_arrays(scenes, rng):
    """A model from the scene's point cloud, moved off its init, with moments
    drawn from numpy (nu > 0): from zero moments the first step is
    -lr sqrt(1000) sign(g), and near-zero gradients would flip sign on f32
    noise."""
    js, _ = scenes
    m = jmodel.init_from_points(jnp.asarray(js.points), jnp.asarray(js.colors), 128, 2)
    params = {k: np.array(getattr(m.params, k)) for k in NAMES}
    alive = np.array(m.alive)
    params["feat_dc"][alive] += rng.randn(alive.sum(), 1, 3).astype(np.float32) * 0.2
    params["feat_rest"][alive] += rng.randn(alive.sum(), 8, 3).astype(np.float32) * 0.05
    params["logit_opacity"][alive] += 2.0
    params["log_scale"][alive] += 0.5
    mu = {k: (rng.randn(*a.shape) * 1e-4).astype(np.float32) for k, a in params.items()}
    nu = {k: (rng.rand(*a.shape) * 1e-7 + 1e-9).astype(np.float32) for k, a in params.items()}
    stats = dict(grad_accum=rng.rand(128), denom=rng.randint(0, 4, 128), max_radii2d=rng.rand(128) * 5)
    stats = {k: v.astype(np.float32) for k, v in stats.items()}
    return params, alive, mu, nu, stats


def test_train_step_matches_jax_from_warm_state(scenes):
    js, ts = scenes
    params, alive, mu, nu, stats = warm_state_arrays(scenes, np.random.RandomState(5))
    cfg = trainer_cfg()
    step0, deg, bg, lr_scale = 3, 2, (0.0, 0.0, 0.0), 4.4

    jstate = jtrainer.train_state_from_model(
        jmodel.GaussianModelState(params=jax_params(params), alive=jnp.asarray(alive),
                                  **{k: jnp.asarray(v) for k, v in stats.items()}),
        8, jtrainer.TrainerConfig(**cfg),
    )
    jstate = jstate.replace(
        opt=joptim.SparseAdamState(mu=jax_params(mu), nu=jax_params(nu)), step=jnp.int32(step0)
    )
    jstep = jtrainer.make_train_step(jtrainer.TrainerConfig(**cfg), J_RASTER, lr_scale, deg, bg)
    jnew, jm = jstep(jstate, js.cameras[0], js.images[0])

    tstate = dataclasses.replace(
        ttrainer.train_state_from_model(
            tmodel.GaussianModelState(
                params=tgs.params_from_numpy(params, "cpu"), alive=torch.from_numpy(alive),
                **{k: torch.from_numpy(v.copy()) for k, v in stats.items()}),
            8, ttrainer.TrainerConfig(**cfg)),
        opt=toptim.SparseAdamState(mu={k: torch.from_numpy(v.copy()) for k, v in mu.items()},
                                   nu={k: torch.from_numpy(v.copy()) for k, v in nu.items()}),
        step=step0,
    )
    tstep = ttrainer.make_train_step(ttrainer.TrainerConfig(**cfg), T_RASTER, lr_scale, deg, bg)
    tnew, tm = tstep(tstate, ts.cameras[0], ts.images[0])

    assert tnew.step == int(jnew.step) == step0 + 1
    assert set(tm) == set(jm)
    for k in ("loss", "l1", "ssim", "psnr", "scale_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    for k in ("n_visible", "n_alive", "bin_valid", "bin_rect_truncated", "bin_dropped"):
        assert int(tm[k]) == int(jm[k]), k
    visible = np_(tnew.model.grad_accum) != stats["grad_accum"]
    assert visible.sum() == int(tm["n_visible"]) > 0
    for k in NAMES:
        jmu, tmu = np.asarray(getattr(jnew.opt.mu, k)), np_(tnew.opt.mu[k])
        # The gradient, recovered from the new first moment on visible rows.
        jg = (jmu - 0.9 * mu[k])[visible] / 0.1
        tg = (tmu - 0.9 * mu[k])[visible] / 0.1
        scale = np.abs(jg).max() + 1e-12
        np.testing.assert_allclose(tg / scale, jg / scale, atol=GRAD_ATOL, err_msg=f"grad {k}")
        np.testing.assert_allclose(tmu, jmu, rtol=1e-3, atol=2e-3 * np.abs(jmu).max(), err_msg=f"mu {k}")
        jnu, tnu = np.asarray(getattr(jnew.opt.nu, k)), np_(tnew.opt.nu[k])
        np.testing.assert_allclose(tnu, jnu, rtol=1e-3, atol=2e-3 * np.abs(jnu).max(), err_msg=f"nu {k}")
        # New parameters: the Adam step is at most ~lr per element.
        np.testing.assert_allclose(np_(getattr(tnew.model.params, k)),
                                   np.asarray(getattr(jnew.model.params, k)), rtol=0, atol=2e-5,
                                   err_msg=f"param {k}")
    for k in ("grad_accum", "denom", "max_radii2d"):
        np.testing.assert_allclose(np_(getattr(tnew.model, k)), np.asarray(getattr(jnew.model, k)),
                                   rtol=2e-3, atol=1e-6, err_msg=k)


def jax_split_noise(seed):
    """The port trainer's `_split_noise` replaced by the JAX trainer's draws:
    one split of its key chain per densify event (dogs_tpu
    trainer.py:761), jax.random.normal of (2C, 3)."""
    key = jax.random.PRNGKey(seed)

    def draw(capacity):
        nonlocal key
        key, sub = jax.random.split(key)
        return torch.from_numpy(np.array(jax.random.normal(sub, (2 * capacity, 3), jnp.float32)))

    return draw


@pytest.fixture(scope="module")
def trained(scenes):
    """Both trainers over 30 steps with the host events of EVENTS, validated
    at the start, after step 19 (before the opacity reset) and at the end."""
    js, ts = scenes
    cfg = trainer_cfg(**EVENTS)
    jt = jtrainer.GaussianSplatTrainer(
        js.cameras[:8], js.images[:8], js.points, js.colors, jtrainer.TrainerConfig(**cfg),
        J_RASTER, val_cameras=js.cameras[8:], val_images=js.images[8:], seed=42,
    )
    tt = ttrainer.GaussianSplatTrainer(
        ts.cameras[:8], ts.images[:8], ts.points, ts.colors, ttrainer.TrainerConfig(**cfg),
        T_RASTER, val_cameras=ts.cameras[8:], val_images=ts.images[8:], seed=42, device="cpu",
    )
    tt._split_noise = jax_split_noise(42)
    vals = [(jt.validate()["val_psnr"], tt.validate()["val_psnr"])]
    orders = []
    for trainer in (jt, tt):
        trainer.train(num_iterations=19, log_every=1)
    vals.append((jt.validate()["val_psnr"], tt.validate()["val_psnr"]))
    for trainer in (jt, tt):
        trainer.train(num_iterations=11, log_every=1)
        orders.append(list(trainer._order))
    vals.append((jt.validate()["val_psnr"], tt.validate()["val_psnr"]))
    return jt, tt, vals, orders


def test_trainer_tracks_jax_trainer(trained):
    jt, tt, vals, (j_left, t_left) = trained
    assert j_left == t_left  # the same camera permutation, consumed alike
    assert [m["step"] for m in tt.metrics_history] == list(range(1, 31))
    for a, b in zip(jt.metrics_history, tt.metrics_history):
        assert abs(a["psnr"] - b["psnr"]) < PSNR_STEP_TOL, (a["step"], a["psnr"], b["psnr"])
        assert b["n_alive"] == a["n_alive"], (a["step"], a["n_alive"], b["n_alive"])
        assert b["bin_valid"] == a["bin_valid"], (a["step"], a["bin_valid"], b["bin_valid"])
    for jv, tv in vals:
        assert abs(jv - tv) < VAL_TOL, (jv, tv)
    # Both rise before the opacity reset: train PSNR and the val split.
    (jv0, tv0), (jv19, tv19), _ = vals
    for hist in (jt.metrics_history, tt.metrics_history):
        psnr = [m["psnr"] for m in hist]
        assert np.mean(psnr[14:19]) > np.mean(psnr[:5]) + 2.0
        assert np.mean(psnr[25:]) > np.mean(psnr[20:25])  # recovering after the reset
    assert tv19 > tv0 + 1.0 and jv19 > jv0 + 1.0


def test_trainer_densifies_and_resets_like_jax(trained):
    """n_alive after each densify event (logged at the next step, and the
    final state after the event at step 30), the capacity, the reset
    opacities and the final model."""
    jt, tt, _, _ = trained
    alive = [int(m["n_alive"]) for m in tt.metrics_history]
    for event in (10, 20):  # metrics_history[event] is step event + 1
        assert alive[event] != alive[event - 1], (event, alive)
    final = int(tt.state.model.num_alive)
    assert final == int(jt.state.model.num_alive) != alive[-1]
    assert tt.state.model.capacity == jt.state.model.capacity == 128
    j_alive = np.asarray(jt.state.model.alive)
    np.testing.assert_array_equal(np_(tt.state.model.alive), j_alive)
    for k in NAMES:  # 10 Adam steps past the last split: f32 drift only
        np.testing.assert_allclose(np_(getattr(tt.state.model.params, k))[j_alive],
                                   np.asarray(getattr(jt.state.model.params, k))[j_alive],
                                   rtol=0, atol=2e-3, err_msg=k)
    # The reset at step 20 zeroed the opacity moments; 10 sparse steps later
    # the never-visible ones are still zero on both sides.
    np.testing.assert_array_equal(np_(tt.state.opt.mu["logit_opacity"]) == 0,
                                  np.asarray(jt.state.opt.mu.logit_opacity) == 0)
    for k in ("grad_accum", "denom", "max_radii2d"):  # zeroed by the event at step 30
        assert not np_(getattr(tt.state.model, k)).any() and not np.asarray(getattr(jt.state.model, k)).any()


def test_reactive_capacity_growth_matches_jax(scenes, caplog):
    """dogs_tpu's capacity protocol (reactive_capacity_growth=True) on both
    trainers. Every alive Gaussian splits at each event (threshold 0,
    percent_dense 0), so the event at step 5 drops candidates in the full
    capacity and logs the overflow, and the one at step 10 grows a bucket
    first. The logged drops and growth, n_alive at every step, the capacity
    and the final alive mask are equal."""
    js, ts = scenes
    cfg = trainer_cfg(densify_start_iter=2, densification_interval=5, densify_grad_threshold=0.0,
                      percent_dense=0.0, sh_increase_interval=1000, reactive_capacity_growth=True)
    jt = jtrainer.GaussianSplatTrainer(js.cameras[:8], js.images[:8], js.points, js.colors,
                                       jtrainer.TrainerConfig(**cfg), J_RASTER, seed=42)
    tt = ttrainer.GaussianSplatTrainer(ts.cameras[:8], ts.images[:8], ts.points, ts.colors,
                                       ttrainer.TrainerConfig(**cfg), T_RASTER, seed=42, device="cpu")
    tt._split_noise = jax_split_noise(42)
    caplog.set_level("INFO")
    for trainer in (jt, tt):
        trainer.train(num_iterations=10, log_every=1)

    def capacity_log(module):
        return [r.getMessage() for r in caplog.records if r.name == module.__name__
                and ("densify overflow" in r.getMessage() or "capacity growth" in r.getMessage())]

    logged = capacity_log(ttrainer)
    assert logged == capacity_log(jtrainer), logged
    assert len(logged) == 2 and logged[0].startswith("densify overflow: ") and logged[1].startswith(
        "reactive capacity growth 128 -> ")
    alive = [int(m["n_alive"]) for m in tt.metrics_history]
    assert alive == [int(m["n_alive"]) for m in jt.metrics_history]
    assert alive[5] > alive[4]  # the event at step 5 split into the free slots
    assert tt.state.model.capacity == jt.state.model.capacity > 128
    np.testing.assert_array_equal(np_(tt.state.model.alive), np.asarray(jt.state.model.alive))


@pytest.fixture(scope="module")
def pruned(scenes):
    """Both trainers over 6 steps with the LightGaussian prune after steps 3
    and 5 (percent 0.5, then 0.6 x 0.5), logged every 3 steps; the port's
    per-step bin_valid is recorded."""
    js, ts = scenes
    cfg = trainer_cfg(prune_iterations=(3, 5), prune_percent=0.5, prune_decay=0.6)
    jt = jtrainer.GaussianSplatTrainer(js.cameras[:8], js.images[:8], js.points, js.colors,
                                       jtrainer.TrainerConfig(**cfg), J_RASTER, seed=42)
    tt = ttrainer.GaussianSplatTrainer(ts.cameras[:8], ts.images[:8], ts.points, ts.colors,
                                       ttrainer.TrainerConfig(**cfg), T_RASTER, seed=42, device="cpu")
    per_step = []
    take_step = tt.train_iteration

    def recording(step):
        metrics = take_step(step)
        per_step.append(metrics["bin_valid"])
        return metrics

    tt.train_iteration = recording
    for trainer in (jt, tt):
        trainer.train(num_iterations=6, log_every=3)
    return jt, tt, per_step


def test_trainer_lightgaussian_prune_matches_jax(pruned):
    """n_alive at each log and the alive mask after both prunes are the JAX
    trainer's; each prune removed at least k = int(percent (n_alive - 1))."""
    jt, tt, _ = pruned
    alive = [int(m["n_alive"]) for m in tt.metrics_history]
    assert alive == [int(m["n_alive"]) for m in jt.metrics_history]
    final = int(tt.state.model.num_alive)
    assert final == int(jt.state.model.num_alive)
    np.testing.assert_array_equal(np_(tt.state.model.alive), np.asarray(jt.state.model.alive))
    # 80 points alive at the log of step 3 (before its prune); the first
    # prune alone removes at least int(0.5 x 79).
    assert alive[0] == 80 and final <= 80 - int(0.5 * 79), (alive, final)


def test_log_window_reports_the_max_bin_valid(pruned):
    """F4: bin_valid at a log is the maximum over the window's steps, as the
    JAX trainer reports it, not the last step's."""
    jt, tt, per_step = pruned
    got = [m["bin_valid"] for m in tt.metrics_history]
    assert got == [max(per_step[:3]), max(per_step[3:])]
    assert got == [m["bin_valid"] for m in jt.metrics_history]
    assert got != [per_step[2], per_step[5]]  # the windows' last steps are not their maxima


def test_admm_penalty_raises():
    """The ADMM step takes u, z_local and rho (tests/test_torch_admm.py holds
    it against dogs_tpu); called without them, or the plain step with them,
    it raises."""
    admm_step = ttrainer.make_train_step(ttrainer.TrainerConfig(), T_RASTER, 1.0, 0, (0.0, 0.0, 0.0), admm=True)
    with pytest.raises(TypeError, match="u, z_local, rho"):
        admm_step(None, None, None)
    plain_step = ttrainer.make_train_step(ttrainer.TrainerConfig(), T_RASTER, 1.0, 0, (0.0, 0.0, 0.0))
    with pytest.raises(TypeError, match="3 extra arguments"):
        plain_step(None, None, None, {}, {}, {})


def test_load_jax_train_state(tmp_path, trained):
    jt, _, _, _ = trained
    path = tmp_path / "ckpt.npz"
    save_pytree(str(path), jt.state, {"step": 30})
    state = load_jax_train_state(str(path), "cpu")
    assert state.step == 30 and state.exposure.shape == (8, 3, 4) and state.mask_params == {}
    for k in NAMES:
        np.testing.assert_array_equal(np_(getattr(state.model.params, k)),
                                      np.asarray(getattr(jt.state.model.params, k)))
        np.testing.assert_array_equal(np_(state.opt.mu[k]), np.asarray(getattr(jt.state.opt.mu, k)))
        np.testing.assert_array_equal(np_(state.opt.nu[k]), np.asarray(getattr(jt.state.opt.nu, k)))
    for k in ("alive", "grad_accum", "denom", "max_radii2d"):
        np.testing.assert_array_equal(np_(getattr(state.model, k)), np.asarray(getattr(jt.state.model, k)))
    # The port resumes from it: one more step runs.
    step = ttrainer.make_train_step(ttrainer.TrainerConfig(**trainer_cfg()), T_RASTER, 4.4, 2, (0.0,) * 3)
    cam = synthetic.ring_cameras(10, 4.0, 64, 64, 64 * 0.9, device="cpu")[0]
    state, m = step(state, cam, torch.rand(64, 64, 3, generator=torch.Generator().manual_seed(0)))
    assert state.step == 31 and np.isfinite(float(m["loss"]))
    with pytest.raises(KeyError, match="trainer checkpoint"):
        model_only = tmp_path / "model.npz"
        save_pytree(str(model_only), jt.state.model)
        load_jax_train_state(str(model_only), "cpu")
