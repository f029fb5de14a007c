"""The block trainer over ranks on the CPU: four gloo processes against one
process on the smoke scene (the fusion exactly, a consensus round to
float32 summation order, rho equal in bits on every rank), both against
the plain reference of benchmark/reference/admm.py, a checkpoint written
by four ranks resumed in one process bit for bit, a killed rank, the
shared-row round against the dense one, and the train_admm CLI with
trainer.distributed."""

import dataclasses
import logging
import os
import time

import numpy as np
import pytest
import torch

from benchmark.reference import admm as ref_admm
from benchmark.reference import appearance as ref_appearance
from dogs_tpu_torch import factory, preprocess, train_admm
from dogs_tpu_torch.core.gaussians import PARAM_NAMES
from dogs_tpu_torch.fields import appearance
from dogs_tpu_torch.parallel import admm, master
from dogs_tpu_torch.train import trainer as ttrainer
from dogs_tpu_torch.train.checkpoint import CheckpointManager, read_checkpoint
from dogs_tpu_torch.utils.config import load_config

SMOKE = "config/gaussian_splatting/synthetic_admm_smoke.yaml"
SCENE = "toy_blocks"
SMOKE_SIZE = ["dataset.n_cams=16", "dataset.width=48", "dataset.height=40", "dataset.n_gaussians=64"]
# Densify at 4 and 7, the fusion at 10, then rounds every 5 steps.
TRAIN_KW = dict(min_capacity=32, densify_start_iter=1, densify_end_iter=10, densification_interval=3,
                densify_grad_threshold=1e-4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread here and in every spawned rank (they take the
    caller's count), so one process and four compute alike."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("admm_ranks")
    overrides = [f"dataset.root_dir={tmp}/data", f"root_dir={tmp}/out", "device=cpu", *SMOKE_SIZE]
    preprocess.main(["--config", SMOKE, *overrides])
    return tmp, overrides, load_config(SMOKE, cli_overrides=overrides)


def make_master(smoke, distributed=False, rank_timeout_s=120.0):
    tmp, _, config = smoke
    m = master.MasterTrainer.from_manifests(
        str(tmp / "data" / SCENE), 2, 2,
        trainer_cfg=dataclasses.replace(factory._trainer_config(config), **TRAIN_KW),
        raster_cfg=factory._raster_config(config),
        admm_cfg=dataclasses.replace(train_admm.admm_config(config), consensus_interval=5), seed=7, device="cpu",
        distributed=distributed, rank_timeout_s=rank_timeout_s,
    )
    assert m.world == (4 if distributed else 1)  # a rank a block on the CPU
    return m


def numpy_blocks(blocks):
    return [{k: v.detach().cpu().numpy().copy() for k, v in b.items()} for b in blocks]


def gathered(m):
    return {kind: numpy_blocks(m.gather_blocks(kind)) for kind in ("params", "alive", "u", "z_local", "slot_map")}


@pytest.fixture(scope="module")
def runs(smoke, tmp_path_factory):
    """Four ranks and one process through the block phase, the fusion, five
    ADMM steps and one round, with snapshots; a checkpoint of the four
    ranks after the round and their state three steps later."""
    m4, m1 = make_master(smoke, distributed=True), make_master(smoke)
    out = {}
    try:
        for m in (m4, m1):
            m.train_iteration()
            m.train_iteration()
        assert m4.admm_enabled and m1.admm_enabled and m4.step == 10
        out["fused"] = [gathered(m) for m in (m4, m1)]
        out["n"] = [(m.n_global, m.n_shared) for m in (m4, m1)]
        for m in (m4, m1):
            for _ in range(5):
                m.train_step()
        out["before"] = [gathered(m) for m in (m4, m1)]
        out["rho_before"] = dict(m4.rho)
        out["residuals"] = [m.consensus() for m in (m4, m1)]
        out["after"] = [gathered(m) for m in (m4, m1)]
        out["rho"] = [dict(m.rho) for m in (m4, m1)]
        out["rank_rho"] = m4.rank_states()
        manager = CheckpointManager(str(tmp_path_factory.mktemp("ranks_ckpt")))
        out["ckpt"] = m4.save_checkpoint(manager)
        for _ in range(3):
            m4.train_step()
        out["later"] = gathered(m4)
        out["cfg"] = m4.admm_cfg
    finally:
        m4.close()
        m1.close()
    return out


def rel(a, b):
    return float(np.linalg.norm((a - b).ravel())) / max(float(np.linalg.norm(np.asarray(b, np.float64).ravel())),
                                                         1e-30)


def test_fusion_over_ranks_equals_one_process(runs):
    f4, f1 = runs["fused"]
    (g4, s4), (g1, s1) = runs["n"]
    assert g4 == g1 and s4 == s1 > 0  # one process numbers the shared rows as the ranks do
    for kind in ("params", "alive", "slot_map"):
        for b4, b1 in zip(f4[kind], f1[kind]):
            for k in b1:
                np.testing.assert_array_equal(b4[k], b1[k], err_msg=f"{kind} {k}")


def test_round_over_ranks_matches_one_process(runs):
    (b4, b1), (a4, a1) = runs["before"], runs["after"]
    for kb in range(4):
        for k in PARAM_NAMES:  # the ranks' steps are the one process's, bit for bit
            np.testing.assert_array_equal(b4["params"][kb][k], b1["params"][kb][k], err_msg=k)
        alive = b1["alive"][kb]["alive"]
        for k in PARAM_NAMES:
            x = b1["params"][kb][k][alive]
            assert rel(a4["z_local"][kb][k][alive], a1["z_local"][kb][k][alive]) <= 1e-6, (kb, k)
            # u moves by 1.5 (x - z): its rounding is z's, relative to x.
            d = a4["u"][kb][k][alive] - a1["u"][kb][k][alive]
            assert float(np.linalg.norm(d)) <= 1e-6 * float(np.linalg.norm(x)), (kb, k)
    (p4, d4), (p1, d1) = runs["residuals"]
    for k in PARAM_NAMES:
        assert abs(p4[k] - p1[k]) <= 1e-6 * abs(p1[k]) and abs(d4[k] - d1[k]) <= 1e-6 * abs(d1[k]), k
    bits = [np.asarray([r[k] for k in PARAM_NAMES], np.float32).view(np.uint32) for r in runs["rank_rho"]]
    assert len(bits) == 4 and all(np.array_equal(b, bits[0]) for b in bits)
    assert runs["rho"][0] == runs["rho"][1]


def test_round_matches_the_plain_reference(runs):
    before, after = runs["before"][0], runs["after"][0]
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    cfg = runs["cfg"]
    x = [{k: t(b[k]) for k in PARAM_NAMES} for b in before["params"]]
    alive = [t(b["alive"]) for b in before["alive"]]
    ref = ref_admm.consensus_round(
        x, alive, [t(b["slot_map"]) for b in before["slot_map"]],
        [{k: t(b[k]) for k in PARAM_NAMES} for b in before["u"]],
        [{k: t(b[k]) for k in PARAM_NAMES} for b in before["z_local"]],
        runs["rho_before"], runs["n"][0][0], cfg.over_relaxation_coeff)
    for kb in range(4):
        al = before["alive"][kb]["alive"]
        for k in PARAM_NAMES:
            x = before["params"][kb][k][al]
            assert rel(after["z_local"][kb][k][al], ref["z_local"][kb][k].numpy()[al]) <= 1e-6, (kb, k)
            d = after["u"][kb][k][al] - ref["u"][kb][k].numpy()[al]
            assert float(np.linalg.norm(d)) <= 1e-6 * float(np.linalg.norm(x)), (kb, k)
    primal, dual = runs["residuals"][0]
    for k in PARAM_NAMES:
        assert abs(primal[k] - ref["primal"][k]) <= 1e-5 * ref["primal"][k], k
        assert abs(dual[k] - ref["dual"][k]) <= 1e-5 * ref["dual"][k], k
    want = ref_admm.adapt_rho(runs["rho_before"], ref["primal"], ref["dual"], cfg.mu, cfg.tau_inc, cfg.tau_dec)
    assert runs["rho"][0] == want


def test_penalty_gradient_matches_the_plain_reference(smoke):
    """One ADMM step with u, z and rho away from zero: the change of the
    step's gradient that the penalty makes (read from the first moment) is
    the reference penalty's autograd gradient, on the drawn rows."""
    m = make_master(smoke)
    try:
        for _ in range(2):
            m.train_iteration()
        blk = m.blocks[0]
        rng = np.random.RandomState(3)
        for k in PARAM_NAMES:
            blk.u[k] = torch.from_numpy((rng.randn(*blk.u[k].shape) * 0.05).astype(np.float32))
            blk.z_local[k] = blk.z_local[k] + torch.from_numpy((rng.randn(*blk.u[k].shape) * 0.1).astype(np.float32))
        rho = {k: np.float32(r) for k, r in zip(PARAM_NAMES, (20.0, 5.0, 50.0, 5.0, 5.0, 2.0))}
        cam, gt = m.block_cameras[0][0], m._gt(0, 0)
        mus = []
        for admm_on in (True, False):
            ts = ttrainer.train_state_from_model(
                dataclasses.replace(blk.train.model, params=type(blk.train.model.params)(
                    **{k: getattr(blk.train.model.params, k).clone() for k in PARAM_NAMES})), 16, m.cfg)
            step = ttrainer.make_train_step(m.cfg, m.raster_cfg, m.spatial_lr_scale, 2, (0.0, 0.0, 0.0),
                                            admm=admm_on)
            extra = (blk.u, blk.z_local, {k: torch.tensor(v) for k, v in rho.items()}) if admm_on else ()
            ts, metrics = step(ts, cam, gt, *extra)
            mus.append({k: v.clone() for k, v in ts.opt.mu.items()})
        p = {k: getattr(blk.train.model.params, k).detach().clone().requires_grad_(True) for k in PARAM_NAMES}
        pen = ref_admm.penalty(p, blk.u, blk.z_local, blk.train.model.alive, {k: float(v) for k, v in rho.items()})
        want = dict(zip(PARAM_NAMES, torch.autograd.grad(pen, list(p.values()))))
        drawn = mus[0]["xyz"].abs().sum(1) > 0
        assert int(drawn.sum()) > 10
        for k in PARAM_NAMES:
            got = ((mus[0][k] - mus[1][k]) / 0.1)[drawn]
            w = want[k][drawn]
            assert float(w.abs().max()) > 0, k
            np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=0, atol=2e-3 * float(w.abs().max()), err_msg=k)
    finally:
        m.close()


def test_appearance_mask_matches_the_plain_reference():
    """The port's mask CNN from its initial parameters against the plain
    one, forward and the render's gradient."""
    torch.manual_seed(0)
    render = torch.rand((96, 128, 3), requires_grad=True)
    ours = appearance.init_appearance_params(3, device="cpu")
    ref = ref_appearance.init_params(3, "cpu")
    for path, v in appearance.flatten(ours).items():
        key = path.replace("['", "").replace("']", "")
        np.testing.assert_array_equal(v.detach().numpy(), ref_appearance.leaves(ref)[key].detach().numpy())
    a = appearance.apply_appearance(ours, render, 1)
    b = ref_appearance.mask(ref, render, 1)
    np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=0, atol=1e-5)
    ga, = torch.autograd.grad(a.square().sum(), render)
    gb, = torch.autograd.grad(b.square().sum(), render)
    np.testing.assert_allclose(ga.numpy(), gb.numpy(), rtol=0, atol=1e-4 * float(gb.abs().max()))


def test_checkpoint_of_four_ranks_resumes_in_one_process_bit_for_bit(smoke, runs):
    one = make_master(smoke)
    try:
        assert one.load_checkpoint(None, runs["ckpt"]) == 15
        arrays, _ = read_checkpoint(runs["ckpt"])
        state = one.state_arrays()
        assert sorted(state) == sorted(arrays)
        for k in arrays:
            np.testing.assert_array_equal(state[k], arrays[k], err_msg=k)
        for _ in range(3):
            one.train_step()
        later = numpy_blocks(one.gather_blocks("params"))
        for b, w in zip(later, runs["later"]["params"]):
            for k in PARAM_NAMES:
                np.testing.assert_array_equal(b[k], w[k], err_msg=k)
    finally:
        one.close()


def test_a_killed_rank_makes_rank_0_raise(smoke):
    m = make_master(smoke, distributed=True, rank_timeout_s=20.0)
    try:
        victim = m._group.procs[0]
        os.kill(victim.pid, 9)
        victim.join(10.0)
        t0 = time.monotonic()
        with pytest.raises((RuntimeError, TimeoutError)):
            m.train_iteration()
        assert time.monotonic() - t0 < 25.0
    finally:
        m.close()
    assert not any(p.is_alive() for p in m._group.procs)


def test_shared_round_is_the_dense_round_in_one_process():
    """The shared-row round with every block in one process against
    `consensus_round` on random blocks: equal on the alive slots up to
    summation order, and a row that one block holds keeps z = x exactly."""
    rng = np.random.RandomState(0)
    b, c, g = 4, 40, 90
    cfg = admm.AdmmConfig(over_relaxation_coeff=0.5)
    ids = [np.sort(rng.choice(g, 30 + k, replace=False)).astype(np.int32) for k in range(b)]
    n_shared, slots = admm.shared_rows(ids, g, c)
    maps = admm.make_slot_maps(ids, c, g)
    blocks = []
    for k in range(b):
        p = ttrainer.train_state_from_model(
            admm.GaussianModelState(
                admm.GaussianParams(xyz=torch.randn(c, 3), feat_dc=torch.randn(c, 1, 3),
                                    feat_rest=torch.randn(c, 15, 3), log_scale=torch.randn(c, 3),
                                    quat=torch.randn(c, 4), logit_opacity=torch.randn(c, 1)),
                torch.from_numpy((np.arange(c) < len(ids[k])) & (rng.rand(c) < 0.9)), *admm.fresh_stats(c, "cpu")),
            1, ttrainer.TrainerConfig())
        blocks.append(admm.AdmmBlockState(
            train=p, u={n: torch.randn_like(getattr(p.model.params, n)) * 0.1 for n in PARAM_NAMES},
            z_local={n: torch.randn_like(getattr(p.model.params, n)) for n in PARAM_NAMES},
            slot_map=torch.from_numpy(maps[k])))
    rho = {k: torch.tensor(0.1 * (i + 1)) for i, k in enumerate(PARAM_NAMES)}
    u_d, z_d, _, _, primal_d, dual_d = admm.consensus_round(blocks, g, rho, cfg)
    index = [admm.SharedIndex.of(s, "cpu") for s in slots]
    u_s, z_s, primal_s, dual_s = admm.consensus_round_shared(blocks, index, n_shared, b, rho, cfg)
    held = np.bincount(np.concatenate(ids), minlength=g)
    for k_b, blk in enumerate(blocks):
        al = blk.train.model.alive.numpy()
        own = al & (maps[k_b] < g) & (held[np.minimum(maps[k_b], g - 1)] == 1)
        assert own.any()
        for n in PARAM_NAMES:
            x = getattr(blk.train.model.params, n).detach().numpy()
            np.testing.assert_array_equal(z_s[k_b][n].numpy()[own], x[own])
            np.testing.assert_allclose(z_s[k_b][n].numpy()[al], z_d[k_b][n].numpy()[al], rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(u_s[k_b][n].numpy()[al], u_d[k_b][n].numpy()[al], rtol=1e-6, atol=1e-6)
    for n in PARAM_NAMES:
        np.testing.assert_allclose(primal_s[n], float(primal_d[n]), rtol=1e-6)
        np.testing.assert_allclose(dual_s[n], float(dual_d[n]), rtol=1e-6)


def test_train_admm_cli_over_ranks(smoke, caplog):
    """python -m dogs_tpu_torch.train_admm with trainer.distributed=true on
    the CPU: four ranks through the block phase, the fusion (its shared
    rows numbered) and rounds, the final validation on rank 0."""
    tmp, overrides, _ = smoke
    args = ["--config", SMOKE, *overrides, "trainer.distributed=true", "trainer.max_iterations=15",
            "trainer.n_checkpoint=0", "trainer.n_validation=0", "trainer.admm.consensus_interval=5",
            "geometry.densify_start_iter=1", "geometry.densify_end_iter=5", "geometry.densification_interval=3",
            "root_dir=" + str(tmp / "cli")]
    with caplog.at_level(logging.INFO):
        train_admm.main(args)
    enabled = [r.getMessage() for r in caplog.records if r.getMessage().startswith("ADMM enabled")]
    assert len(enabled) == 1 and "shared)" in enabled[0] and "(0 shared)" not in enabled[0], enabled
    rounds = [r.getMessage() for r in caplog.records if "primal_xyz=" in r.getMessage()]
    assert len(rounds) == 2, rounds
    final = [r.args for r in caplog.records if r.getMessage().startswith("final val")]
    assert len(final) == 1 and final[0]["val_psnr"] > 12.0, final
