"""The ADMM functions against dogs_tpu: one consensus round against
`make_consensus_step` on a 4-device CPU mesh, `adapt_rho` and
`initial_rho` in bits, the slot maps, the block-step metrics, and one train
step with the scaled-dual penalty against dogs_tpu's
`make_train_step(..., admm=True)`. The same numpy inputs go to both
packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from dogs_tpu.core.gaussians import GaussianParams as JParams
from dogs_tpu.data.synthetic import make_scene as j_make_scene
from dogs_tpu.fields import model as jmodel
from dogs_tpu.parallel import admm as jadmm
from dogs_tpu.train import optim as joptim
from dogs_tpu.train import trainer as jtrainer
from dogs_tpu_torch.core import gaussians as tgs
from dogs_tpu_torch.data import synthetic
from dogs_tpu_torch.fields import model as tmodel
from dogs_tpu_torch.parallel import admm
from dogs_tpu_torch.train import optim as toptim
from dogs_tpu_torch.train import trainer as ttrainer
from tests.test_torch_core import jax_params
from tests.test_torch_train import GRAD_ATOL, J_RASTER, T_RASTER, trainer_cfg, warm_state_arrays

NAMES = tgs.PARAM_NAMES
B, C, G = 4, 32, 50  # blocks, block capacity, global Gaussians


def np_(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def f32_bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def block_arrays(seed=0):
    """Stacked (B, C, ...) block parameters, duals and z, alive masks with
    dead slots, and slot maps whose alive rows name distinct global rows
    within a block (shared across blocks), private (G) rows among them."""
    rng = np.random.RandomState(seed)
    shapes = dict(xyz=(3,), feat_dc=(1, 3), feat_rest=(3, 3), log_scale=(3,), quat=(4,), logit_opacity=(1,))
    params = {k: rng.randn(B, C, *s).astype(np.float32) for k, s in shapes.items()}
    u = {k: (rng.randn(B, C, *s) * 0.1).astype(np.float32) for k, s in shapes.items()}
    z_old = {k: (v + rng.randn(*v.shape) * 0.05).astype(np.float32) for k, v in params.items()}
    alive = rng.rand(B, C) < 0.8
    slot_map = np.stack([rng.permutation(G)[:C] for _ in range(B)]).astype(np.int32)
    slot_map[rng.rand(B, C) < 0.15] = G  # private slots
    slot_map[:, -3:] = G  # padding
    alive[:, -3:] = False
    rho = {k: np.float32(r) for k, r in zip(NAMES, (0.7, 0.03, 0.2, 1.5, 0.4, 0.05))}
    return params, u, z_old, alive, slot_map, rho


def test_consensus_round_matches_make_consensus_step():
    params, u, z_old, alive, slot_map, rho = block_arrays()
    cfg = admm.AdmmConfig(over_relaxation_coeff=0.5)
    mesh = Mesh(np.asarray(jax.devices()[:B]), ("block",))
    step = jadmm.make_consensus_step(mesh, G, jadmm.AdmmConfig(over_relaxation_coeff=0.5))
    j_u, j_z_local, j_z, j_counts, j_primal, j_dual = step(
        jax_params(params), jnp.asarray(alive), jnp.asarray(slot_map), jax_params(u), jax_params(z_old),
        JParams(**{k: jnp.float32(v) for k, v in rho.items()}),
    )

    blocks = [
        admm.AdmmBlockState(
            train=ttrainer.train_state_from_model(
                tmodel.GaussianModelState(tgs.params_from_numpy({k: v[kb] for k, v in params.items()}, "cpu"),
                                          torch.from_numpy(alive[kb].copy()), *tmodel.fresh_stats(C, "cpu")),
                1, ttrainer.TrainerConfig()),
            u={k: torch.from_numpy(v[kb].copy()) for k, v in u.items()},
            z_local={k: torch.from_numpy(v[kb].copy()) for k, v in z_old.items()},
            slot_map=torch.from_numpy(slot_map[kb].copy()),
        )
        for kb in range(B)
    ]
    rho_t = {k: torch.tensor(v) for k, v in rho.items()}
    new_u, z_local, z, counts, primal, dual = admm.consensus_round(blocks, G, rho_t, cfg)

    np.testing.assert_array_equal(np_(counts), np.asarray(j_counts))
    assert (np_(counts) == 0).any() and np_(counts).max() >= 2  # rows unseen, rows shared
    for k in NAMES:
        np.testing.assert_allclose(np_(z[k]), np.asarray(getattr(j_z, k)), rtol=1e-6, atol=1e-7, err_msg=k)
        for kb in range(B):
            np.testing.assert_allclose(np_(z_local[kb][k]), np.asarray(getattr(j_z_local, k))[kb], rtol=1e-6,
                                       atol=1e-7, err_msg=k)
            np.testing.assert_allclose(np_(new_u[kb][k]), np.asarray(getattr(j_u, k))[kb], rtol=1e-6, atol=1e-7,
                                       err_msg=k)
        np.testing.assert_allclose(float(primal[k]), float(getattr(j_primal, k)), rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(float(dual[k]), float(getattr(j_dual, k)), rtol=1e-6, err_msg=k)
    # Dead slots keep their duals.
    for kb in range(B):
        np.testing.assert_array_equal(np_(new_u[kb]["xyz"])[~alive[kb]], u["xyz"][kb][~alive[kb]])


def test_consensus_round_is_deterministic():
    params, u, z_old, alive, slot_map, rho = block_arrays(seed=3)
    blocks = [
        admm.AdmmBlockState(
            train=ttrainer.train_state_from_model(
                tmodel.GaussianModelState(tgs.params_from_numpy({k: v[kb] for k, v in params.items()}, "cpu"),
                                          torch.from_numpy(alive[kb].copy()), *tmodel.fresh_stats(C, "cpu")),
                1, ttrainer.TrainerConfig()),
            u={k: torch.from_numpy(v[kb].copy()) for k, v in u.items()},
            z_local={k: torch.from_numpy(v[kb].copy()) for k, v in z_old.items()},
            slot_map=torch.from_numpy(slot_map[kb].copy()),
        )
        for kb in range(B)
    ]
    rho_t = {k: torch.tensor(v) for k, v in rho.items()}
    a = admm.consensus_round(blocks, G, rho_t, admm.AdmmConfig())
    b = admm.consensus_round(blocks, G, rho_t, admm.AdmmConfig())
    for k in NAMES:
        assert torch.equal(a[2][k], b[2][k]) and torch.equal(a[4][k], b[4][k])


def test_adapt_rho_matches_jax_in_bits():
    """Grow, shrink and keep, and the comparisons at mu exactly, as float32."""
    cfg = admm.AdmmConfig(mu=10.0, tau_inc=2.0, tau_dec=3.0)
    jcfg = jadmm.AdmmConfig(mu=10.0, tau_inc=2.0, tau_dec=3.0)
    rho = cfg.initial_rho(12345)
    cases = {
        "grow": (1.0, 1e-6), "shrink": (1e-6, 1.0), "keep": (1.0, 1.0),
        "edge": (np.float32(10.0) * np.float32(0.3), 0.3), "zero": (0.0, 0.0),
    }
    for name, (p, d) in cases.items():
        primal = {k: np.float32(p) * np.float32(1 + i) for i, k in enumerate(NAMES)}
        dual = {k: np.float32(d) * np.float32(1 + i) for i, k in enumerate(NAMES)}
        got = admm.adapt_rho(rho, primal, dual, cfg)
        want = jadmm.adapt_rho(JParams(**{k: jnp.float32(v) for k, v in rho.items()}),
                               JParams(**{k: jnp.float32(v) for k, v in primal.items()}),
                               JParams(**{k: jnp.float32(v) for k, v in dual.items()}), jcfg)
        for k in NAMES:
            assert f32_bits(got[k]) == f32_bits(getattr(want, k)), (name, k)
    grown = admm.adapt_rho(rho, {k: np.float32(1) for k in NAMES}, {k: np.float32(0) for k in NAMES}, cfg)
    assert all(grown[k] == rho[k] * np.float32(2) for k in NAMES)


@pytest.mark.parametrize("n", [0, 1, 7, 1_000_003])
def test_initial_rho_matches_jax_in_bits(n):
    got = admm.AdmmConfig(alpha_fr=123.0).initial_rho(n)
    want = jadmm.AdmmConfig(alpha_fr=123.0).initial_rho(n)
    for k in NAMES:
        assert isinstance(got[k], np.float32)
        assert f32_bits(got[k]) == f32_bits(getattr(want, k)), k


def test_make_slot_maps_matches_jax():
    ids = [np.array([4, 0, 9], np.int32), np.array([], np.int32), np.arange(5, dtype=np.int32)]
    got = admm.make_slot_maps(ids, 8, 10)
    np.testing.assert_array_equal(got, jadmm.make_slot_maps(ids, 8, 10))
    assert got.dtype == np.int32 and (got[1] == 10).all()


def test_block_metrics_average_and_sum():
    per_block = [dict(loss=torch.tensor(1.0), n_visible=torch.tensor(3), bin_dropped=torch.tensor(2),
                      bin_pool_truncated=torch.tensor(0), bin_valid=5),
                 dict(loss=torch.tensor(3.0), n_visible=torch.tensor(4), bin_dropped=torch.tensor(1),
                      bin_pool_truncated=torch.tensor(4), bin_valid=7)]
    m = admm.block_metrics(per_block)
    assert {k: float(v) for k, v in m.items()} == dict(loss=2.0, n_visible=3.5, bin_dropped=3.0,
                                                        bin_pool_truncated=4.0, bin_valid=6.0)


# ---- the step with the penalty ------------------------------------------------------


@pytest.fixture(scope="module")
def scenes():
    kw = dict(n_gaussians=80, n_cams=2, width=64, height=48, seed=3)
    return j_make_scene(raster_cfg=J_RASTER, **kw), synthetic.make_scene(**kw, device="cpu")


def test_admm_penalty_step_matches_jax(scenes):
    """One step from a warm state with nonzero u, z_local and rho, against
    dogs_tpu's admm=True step: loss at rtol 1e-5, the gradients (recovered
    from the new first moment) at the max-normalized 2e-3, the moments and
    parameters at test_torch_train.py's bars; the penalty moves the loss
    and the gradients."""
    js, ts = scenes
    rng = np.random.RandomState(9)
    params, alive, mu, nu, stats = warm_state_arrays(scenes, rng)
    u = {k: (rng.randn(*a.shape) * 0.05).astype(np.float32) for k, a in params.items()}
    z = {k: (a + rng.randn(*a.shape) * 0.1).astype(np.float32) for k, a in params.items()}
    rho = {k: np.float32(r) for k, r in zip(NAMES, (20.0, 5.0, 50.0, 5.0, 5.0, 2.0))}
    cfg = trainer_cfg()
    step0, deg, bg, lr_scale = 3, 2, (0.0, 0.0, 0.0), 4.4

    jstate = jtrainer.train_state_from_model(
        jmodel.GaussianModelState(params=jax_params(params), alive=jnp.asarray(alive),
                                  **{k: jnp.asarray(v) for k, v in stats.items()}),
        2, jtrainer.TrainerConfig(**cfg),
    ).replace(opt=joptim.SparseAdamState(mu=jax_params(mu), nu=jax_params(nu)), step=jnp.int32(step0))
    jstep = jtrainer.make_train_step(jtrainer.TrainerConfig(**cfg), J_RASTER, lr_scale, deg, bg, admm=True)
    jnew, jm = jstep(jstate, js.cameras[0], js.images[0], jax_params(u), jax_params(z),
                     JParams(**{k: jnp.float32(v) for k, v in rho.items()}))

    def port_state():
        """A fresh port state: the step updates it in place, and
        params_from_numpy shares the numpy arrays' memory."""
        model = tmodel.GaussianModelState(
            params=tgs.params_from_numpy({k: v.copy() for k, v in params.items()}, "cpu"),
            alive=torch.from_numpy(alive.copy()),
            **{k: torch.from_numpy(v.copy()) for k, v in stats.items()})
        return dataclasses.replace(
            ttrainer.train_state_from_model(model, 2, ttrainer.TrainerConfig(**cfg)),
            opt=toptim.SparseAdamState(mu={k: torch.from_numpy(v.copy()) for k, v in mu.items()},
                                       nu={k: torch.from_numpy(v.copy()) for k, v in nu.items()}),
            step=step0,
        )

    tstep = ttrainer.make_train_step(ttrainer.TrainerConfig(**cfg), T_RASTER, lr_scale, deg, bg, admm=True)
    with pytest.raises(TypeError, match="u, z_local, rho"):
        tstep(port_state(), ts.cameras[0], ts.images[0])
    tnew, tm = tstep(port_state(), ts.cameras[0], ts.images[0], {k: torch.from_numpy(v) for k, v in u.items()},
                     {k: torch.from_numpy(v) for k, v in z.items()}, {k: torch.tensor(v) for k, v in rho.items()})
    plain, pm = ttrainer.make_train_step(ttrainer.TrainerConfig(**cfg), T_RASTER, lr_scale, deg, bg)(
        port_state(), ts.cameras[0], ts.images[0])

    for k in ("loss", "l1", "ssim", "psnr", "scale_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    assert float(tm["loss"]) > float(pm["loss"]) + 1e-3  # the penalty is in the loss
    visible = np_(tnew.model.grad_accum) != stats["grad_accum"]
    assert visible.sum() == int(tm["n_visible"]) > 0
    for k in NAMES:
        jmu, tmu = np.asarray(getattr(jnew.opt.mu, k)), np_(tnew.opt.mu[k])
        jg, tg = (jmu - 0.9 * mu[k])[visible] / 0.1, (tmu - 0.9 * mu[k])[visible] / 0.1
        scale = np.abs(jg).max() + 1e-12
        np.testing.assert_allclose(tg / scale, jg / scale, atol=GRAD_ATOL, err_msg=f"grad {k}")
        pg = (np_(plain.opt.mu[k]) - 0.9 * mu[k])[visible] / 0.1
        assert np.abs(pg - tg).max() > 10 * GRAD_ATOL * scale, f"the penalty does not move grad {k}"
        np.testing.assert_allclose(tmu, jmu, rtol=1e-3, atol=2e-3 * np.abs(jmu).max(), err_msg=f"mu {k}")
        jnu, tnu = np.asarray(getattr(jnew.opt.nu, k)), np_(tnew.opt.nu[k])
        np.testing.assert_allclose(tnu, jnu, rtol=1e-3, atol=2e-3 * np.abs(jnu).max(), err_msg=f"nu {k}")
        np.testing.assert_allclose(np_(getattr(tnew.model.params, k)), np.asarray(getattr(jnew.model.params, k)),
                                   rtol=0, atol=2e-5, err_msg=f"param {k}")
