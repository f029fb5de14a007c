"""The block trainer: the fusion against dogs_tpu's fuse_local_gaussians (the
float32 crop, the concatenation, the re-selection, and the post-merge prune
on dogs_tpu's scores), checkpoints read by either package, and the port's
lifecycle on synthetic_admm_smoke.yaml at tests/test_admm_cli.py's smoke
size: fusion and ADMM, residuals over decaying-LR rounds, rho pulling the
blocks together, a bit-for-bit kill/resume, the overflow log at the phase
boundary, and the train_admm and eval CLIs on the CPU."""

import copy
import dataclasses
import json
import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dogs_tpu.core.gaussians import GaussianParams as JParams
from dogs_tpu.data import blocks as jblocks
from dogs_tpu.data.synthetic import ring_cameras as j_ring_cameras
from dogs_tpu.fields import lightgaussian as jlg
from dogs_tpu.fields.model import GaussianModelState as JModelState
from dogs_tpu.parallel import admm as jadmm
from dogs_tpu.parallel import master as jmaster
from dogs_tpu.train import trainer as jtrainer
from dogs_tpu.train.checkpoint import save_pytree
from dogs_tpu_torch import factory, preprocess, train_admm
from dogs_tpu_torch.core.gaussians import PARAM_NAMES
from dogs_tpu_torch.data import blocks, synthetic
from dogs_tpu_torch.eval.__main__ import main as eval_main
from dogs_tpu_torch.fields import lightgaussian as tlg
from dogs_tpu_torch.parallel import admm, master
from dogs_tpu_torch.train.checkpoint import CheckpointManager, read_checkpoint
from dogs_tpu_torch.utils.config import load_config
from tests.test_torch_lightgaussian import GRAD_ATOL, J_XLA, RING, T_RASTER

SMOKE = "config/gaussian_splatting/synthetic_admm_smoke.yaml"
SCENE = "toy_blocks"
# tests/test_admm_cli.py's smoke size.
SMOKE_SIZE = ["dataset.n_cams=16", "dataset.width=48", "dataset.height=40", "dataset.n_gaussians=64"]
PRUNE_PERCENT = 0.5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's small tensors. A master step is
    hundreds of small ops over four blocks; with a thread a core in each of
    the parallel test workers they wait on each other's threads (two orders
    of magnitude slower here)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- the fusion against dogs_tpu ------------------------------------------------


def fusion_inputs(seed=0):
    """Four overlapping block models of a random scene (SH 2, some dead
    slots, the blocks' copies of shared Gaussians apart by noise, a fifth of
    them too faint to be seen, which score 0), the partition of its points
    in both packages, and ring cameras in both packages."""
    rng = np.random.RandomState(seed)
    scene = synthetic.random_scene_arrays(n=160, seed=seed)
    scene["logit_opacity"][rng.rand(160) < 0.2] = -8.0
    cam_pos = np.stack([[4.0 * np.cos(a), 4.0 * np.sin(a), 0.5] for a in np.linspace(0, 2 * np.pi, 12)])
    part = blocks.partition_scene(cam_pos, scene["xyz"], 2, 2, (1.4, 1.4))
    j_part = jblocks.partition_scene(cam_pos, scene["xyz"], 2, 2, (1.4, 1.4))
    models = []
    for k in range(4):
        idx = np.nonzero(part.point_masks[k])[0]
        m = {f: np.zeros((128,) + a.shape[1:], np.float32) for f, a in scene.items()}
        for f, a in scene.items():
            m[f][: len(idx)] = a[idx] + (rng.randn(len(idx), *a.shape[1:]) * 0.01).astype(np.float32)
        m["alive"] = (np.arange(128) < len(idx)) & (rng.rand(128) > 0.1)
        models.append(m)
    return models, part, j_part


def jax_models(models):
    zeros = np.zeros(128, np.float32)
    return [JModelState(params=JParams(**{f: m[f] for f in PARAM_NAMES}), alive=m["alive"], grad_accum=zeros,
                        denom=zeros, max_radii2d=zeros) for m in models]


def assert_fused_equal(got, want):
    (g_out, g_ids), (w_out, w_ids) = got, want
    assert sorted(g_out) == sorted(w_out)
    for f in w_out:
        np.testing.assert_array_equal(g_out[f], w_out[f], err_msg=f)
    assert len(g_ids) == len(w_ids)
    for a, b in zip(g_ids, w_ids):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype == np.int32


def test_fuse_local_gaussians_matches_jax():
    models, part, j_part = fusion_inputs()
    got = master.fuse_local_gaussians(models, part)
    assert_fused_equal(got, jmaster.fuse_local_gaussians(jax_models(models), j_part))
    fused, ids = got
    n = fused["xyz"].shape[0]
    covered = np.zeros(n, bool)
    for i in ids:
        covered[i] = True
    assert covered.all() and sum(len(i) for i in ids) > n  # every Gaussian in a block; overlap
    assert n < sum(int(m["alive"].sum()) for m in models)  # the crop removed the overlap


def test_post_merge_prune_matches_jax_for_equal_scores(monkeypatch):
    """The port's scores within the importance bar of dogs_tpu's; fed
    dogs_tpu's scores, the port keeps the same Gaussians (the zero scores of
    the faint ones tie) and re-selects the same blocks."""
    models, part, j_part = fusion_inputs(seed=1)
    fused, _ = jmaster.fuse_local_gaussians(jax_models(models), j_part)
    n = fused["xyz"].shape[0]
    jm = jmaster._fused_model_state(fused)
    j_scores = np.asarray(jlg.calculate_v_imp_score(jm, jlg.prune_list(jm, j_ring_cameras(**RING), J_XLA, 2), 0.1),
                          np.float32)
    tcams = synthetic.ring_cameras(**RING, device="cpu")
    tm = master.fused_model_state(fused, "cpu")
    t_scores = tlg.calculate_v_imp_score(tm, tlg.prune_list(tm, tcams, T_RASTER, 2), 0.1).numpy()
    scale = np.abs(j_scores).max()
    np.testing.assert_allclose(t_scores / scale, j_scores / scale, rtol=0, atol=GRAD_ATOL)
    k = int(0.4 * PRUNE_PERCENT * (n - 1))
    assert (j_scores[:n] == 0).sum() > 1 and np.sort(j_scores[:n])[k - 1] == 0.0  # the cut falls in the tie

    monkeypatch.setattr(master, "calculate_v_imp_score", lambda *a: torch.from_numpy(j_scores.copy()))
    got = master.fuse_local_gaussians(models, part, prune_cameras=tcams, raster_cfg=T_RASTER,
                                      prune_percent=PRUNE_PERCENT, active_sh_degree=2, device="cpu")
    want = jmaster.fuse_local_gaussians(jax_models(models), j_part, prune_cameras=j_ring_cameras(**RING),
                                        raster_cfg=J_XLA, prune_percent=PRUNE_PERCENT, active_sh_degree=2)
    assert_fused_equal(got, want)
    assert got[0]["xyz"].shape[0] == n - k


# ---- the port's lifecycle on the smoke scene ----------------------------------------


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    """The smoke scene's block manifests, written by the port's preprocess
    CLI, and its config."""
    tmp = tmp_path_factory.mktemp("admm_smoke")
    overrides = [f"dataset.root_dir={tmp}/data", f"root_dir={tmp}/out", "device=cpu", *SMOKE_SIZE]
    preprocess.main(["--config", SMOKE, *overrides])
    return tmp, overrides, load_config(SMOKE, cli_overrides=overrides)


def make_master(smoke, admm_kw=None, **cfg_kw):
    tmp, _, config = smoke
    a = dataclasses.replace(train_admm.admm_config(config), **(admm_kw or {}))
    return master.MasterTrainer.from_manifests(
        str(tmp / "data" / SCENE), 2, 2,
        trainer_cfg=dataclasses.replace(factory._trainer_config(config), **cfg_kw),
        raster_cfg=factory._raster_config(config), admm_cfg=a, seed=7, device="cpu",
    )


def test_fusion_covers_every_gaussian_and_admm_turns_on(smoke):
    m = make_master(smoke, dict(consensus_interval=5), min_capacity=64, densify_start_iter=1, densify_end_iter=5,
                    densification_interval=3)
    assert m.block_cameras[1][2].image_index == 2 and len(m._gt_pool) == 4
    assert all(p is not None and p.dtype == torch.uint8 for p in m._gt_pool)
    r1 = m.train_iteration()
    assert m.admm_enabled and m.step == 5 and np.isfinite(r1["loss"])
    rows = torch.cat([b.slot_map[b.train.model.alive] for b in m.blocks])
    assert sorted(set(rows.tolist())) == list(range(m.n_global))  # every fused Gaussian lies in a block
    assert len(rows) > m.n_global  # and the expanded boxes overlap
    assert all(b.train.step == 5 for b in m.blocks)
    assert all(float(m.rho[k]) == float(v) for k, v in m.admm_cfg.initial_rho(m.n_global).items())
    r2 = m.train_iteration()
    for k in PARAM_NAMES:
        assert np.isfinite(r2[f"primal_{k}"]) and np.isfinite(r2[f"dual_{k}"])
    assert r2["primal_xyz"] > 0
    val = m.validate(*train_admm.load_val_split(smoke[2], SCENE, "cpu"))
    assert np.isfinite(val["val_psnr"]) and 0 < val["num_points"] <= m.n_global


def test_residuals_fall_over_decaying_lr_rounds(smoke):
    """tests/test_master_fusion.py:103-148's harness: the xyz LR decays over
    the run, rho fixed, no densify. After the post-fusion transient (x == z
    and u = 0 at the fusion: a low first round, then a rebound) the primal
    residual falls round after round, and the dual falls from round to
    round. On this scene the first round's dip sits below the tail, in
    dogs_tpu's master too, so the bar is the tail."""
    m = make_master(smoke, dict(consensus_interval=4, stop_adapt_iter=0), max_iterations=40, min_capacity=128,
                    densify_start_iter=10**9, densify_end_iter=4, position_lr_init=1.6e-3,
                    position_lr_final=1.6e-6, position_lr_max_steps=28, opacity_reset_interval=10**6)
    m.train_iteration()
    assert m.admm_enabled
    rho0 = dict(m.rho)
    primals, duals = [], []
    for _ in range(6):
        r = m.train_iteration()
        primals.append(r["primal_xyz"])
        duals.append(r["dual_xyz"])
    assert m.rho == rho0  # stop_adapt_iter 0
    assert primals[-4] > primals[-3] > primals[-2] > primals[-1] > 0, primals
    assert all(a > b for a, b in zip(duals, duals[1:])), duals


def test_large_rho_pulls_blocks_together(smoke):
    """From one post-fusion state, 4 master steps at a large rho end closer
    to consensus (a lower primal residual) than 4 at rho = 0."""
    m = make_master(smoke, dict(consensus_interval=4), min_capacity=128, densify_start_iter=10**9,
                    densify_end_iter=4)
    m.train_iteration()
    start, rng = copy.deepcopy(m.blocks), copy.deepcopy(m.rng)

    def spread(rho):
        m.blocks, m.rng, m._cam_order = copy.deepcopy(start), copy.deepcopy(rng), [[] for _ in range(4)]
        m.set_rho({k: np.float32(rho) for k in PARAM_NAMES})
        for _ in range(4):
            m.train_step()
        return float(admm.consensus_round(m.blocks, m.n_global, m._rho_dev[0], m.admm_cfg)[4]["xyz"])

    free, tied = spread(0.0), spread(50.0)
    assert tied < free, (tied, free)


def state_equal(a: master.MasterTrainer, b: master.MasterTrainer):
    sa, sb = a.state_arrays(), b.state_arrays()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and np.array_equal(sa[k], sb[k]), k
    assert (a.step, a.n_global, a.admm_enabled, a.rho) == (b.step, b.n_global, b.admm_enabled, b.rho)


def test_kill_resume_continues_bit_for_bit(smoke, tmp_path):
    """A checkpoint in the block phase (between densify events), resumed in
    a fresh trainer, then through the fusion and a consensus round: equal
    to the uninterrupted run in every leaf, rho and step."""
    kw = dict(min_capacity=32, densify_start_iter=1, densify_end_iter=10, densification_interval=3,
              densify_grad_threshold=1e-4)
    run = make_master(smoke, dict(consensus_interval=5), **kw)
    run.train_iteration()
    manager = CheckpointManager(str(tmp_path / "ckpt"))
    path = run.save_checkpoint(manager)
    for _ in range(2):
        run.train_iteration()
    assert run.admm_enabled and run.step == 15
    resumed = make_master(smoke, dict(consensus_interval=5), **kw)
    assert resumed.load_checkpoint(manager, path) == 5
    for _ in range(2):
        resumed.train_iteration()
    state_equal(resumed, run)
    assert run.blocks[0].train.model.capacity > 32  # densify grew the blocks


def test_overflow_before_fusion_is_logged(smoke, caplog):
    """A reactive-growth densify event at the last step before the fusion
    drops candidates; its overflow is logged before the phase boundary
    (dogs_tpu never reads it)."""
    m = make_master(smoke, dict(consensus_interval=6), min_capacity=32, reactive_capacity_growth=True,
                    densify_grad_threshold=0.0, densify_start_iter=1, densify_end_iter=6,
                    densification_interval=5)
    with caplog.at_level(logging.INFO, logger="dogs_tpu_torch.parallel.master"):
        m.train_iteration()
    msgs = [r.getMessage() for r in caplog.records]
    drops = [i for i, s in enumerate(msgs) if s.startswith("densify overflow at step 5, block")]
    fused = [i for i, s in enumerate(msgs) if s.startswith("ADMM enabled at step 6")]
    assert drops and fused and max(drops) < fused[0], msgs


def test_checkpoints_load_in_either_package(smoke, tmp_path):
    """A port checkpoint (ADMM phase) gives dogs_tpu's
    load_fused_from_checkpoint the port's fused model; a stacked block state
    written by dogs_tpu loads into the port's trainer leaf for leaf, with
    the port's key layout, and fuses as dogs_tpu fuses it."""
    tmp, _, _ = smoke
    root = str(tmp / "data" / SCENE)
    _, part = master.load_manifest_partition(root, 2, 2)
    _, j_part = jmaster.load_manifest_partition(root, 2, 2)
    m = make_master(smoke, dict(consensus_interval=5), min_capacity=64, densify_start_iter=1,
                    densify_end_iter=5, densification_interval=3)
    m.train_iteration()
    m.train_iteration()
    path = m.save_checkpoint(CheckpointManager(str(tmp_path / "port")))
    got = master.load_fused_from_checkpoint(path, part, "cpu")
    want = jmaster.load_fused_from_checkpoint(path, j_part)
    for k in PARAM_NAMES:
        np.testing.assert_array_equal(getattr(got.params, k).detach().numpy(), np.asarray(getattr(want.params, k)))
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(want.alive))
    assert 0 < int(got.num_alive) <= m.n_global  # strays past the origin boxes since the fusion go

    # dogs_tpu's phase-1 state of the same manifests, saved by its save_pytree.
    blks = [jblocks.load_block(jblocks.block_dir(root, 2, 2, k)) for k in range(4)]
    sizes = np.cumsum([0] + [len(b["points"]) for b in blks])
    ids = [np.arange(sizes[k], sizes[k + 1], dtype=np.int32) for k in range(4)]
    jcfg = jtrainer.TrainerConfig(min_capacity=64, max_sh_degree=2)
    jstate = jadmm.build_admm_state(np.concatenate([b["points"] for b in blks]),
                                    np.concatenate([b["colors"] for b in blks]), ids, 4, jcfg)
    extra = dict(step=0, admm_enabled=False, n_global=int(sizes[-1]), rho=[1.0] * 6,
                 np_rng=np.random.RandomState(3).get_state()[1].tolist())
    jpath = str(tmp_path / "jax.npz")
    save_pytree(jpath, jstate, extra)
    fresh = make_master(smoke, min_capacity=64)
    assert fresh.load_checkpoint(CheckpointManager(str(tmp_path / "unused")), jpath) == 0
    arrays, _ = read_checkpoint(jpath)
    port = fresh.state_arrays()
    assert sorted(port) == sorted(arrays)
    for k, v in arrays.items():
        assert port[k].dtype == v.dtype and np.array_equal(port[k], v), k
    assert fresh.rho == {k: np.float32(1.0) for k in PARAM_NAMES} and fresh.n_global == sizes[-1]
    got = master.load_fused_from_checkpoint(jpath, part, "cpu")
    want = jmaster.load_fused_from_checkpoint(jpath, j_part)
    np.testing.assert_array_equal(got.params.xyz.detach().numpy(), np.asarray(want.params.xyz))
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(want.alive))


def test_fusion_only_mode(smoke):
    """admm.enable=false (the reference's fusion-only mode, master:686-688):
    the blocks train on past densify_end_iter without a fusion, and
    validate() fuses fresh with the post-merge prune."""
    m = make_master(smoke, dict(consensus_interval=4, enable=False), min_capacity=64, densify_start_iter=10**9,
                    densify_end_iter=4, prune_percent=0.25)
    m.train_iteration()
    m.train_iteration()
    assert m.step == 8 and not m.admm_enabled
    unpruned = m.global_model(prune=False)
    val = m.validate(*train_admm.load_val_split(smoke[2], SCENE, "cpu"))
    assert np.isfinite(val["val_psnr"]) and 0 < val["num_points"] < int(unpruned.num_alive)


def test_streamed_gt_trains_as_the_resident_pool(smoke):
    """GT images kept on the device per block (the default) and streamed
    through the LRU cache train the same bits, both stored as uint8; float32
    storage stays within the 8-bit quantization (tests/test_master_fusion.py
    holds dogs_tpu's two the same way)."""
    kw = dict(min_capacity=64, densify_start_iter=10**9)
    runs = {name: make_master(smoke, dict(consensus_interval=4, **a), **kw) for name, a in (
        ("resident", {}), ("streamed", dict(gt_resident=False)), ("float32", dict(gt_dtype="float32")))}
    assert runs["resident"]._gt_pool[0] is not None and runs["streamed"]._gt_pool[0] is None
    assert runs["float32"]._gt_pool[0].dtype == torch.float32
    out = {name: m.train_iteration() for name, m in runs.items()}
    a, b = runs["resident"].state_arrays(), runs["streamed"].state_arrays()
    assert all(np.array_equal(a[k], b[k]) for k in a) and out["resident"] == out["streamed"]
    assert len(runs["streamed"]._gt_cache) == sum(len(c) for c in runs["streamed"].block_cameras)
    assert abs(out["float32"]["loss"] - out["resident"]["loss"]) < 2e-2


def test_gt_encoding_matches_dogs_tpu():
    rng = np.random.RandomState(0)
    im = np.concatenate([rng.rand(300), np.arange(256) / 255.0, [-0.1, 1.2, 0.5 / 255, 1.5 / 255]]).astype(np.float32)
    im = im.astype(np.float16).astype(np.float32)  # a manifest's float16 images
    got = master.encode_gt(im, np.uint8)
    np.testing.assert_array_equal(got, jmaster._encode_gt(im, np.uint8))
    np.testing.assert_array_equal(got[300:556], np.arange(256))
    decoded = torch.from_numpy(got).to(torch.float32) * (1.0 / 255.0)
    np.testing.assert_array_equal(decoded.numpy(), np.asarray(jnp.asarray(got).astype(jnp.float32) * (1.0 / 255.0)))


def test_train_admm_and_eval_clis_on_the_cpu(smoke, caplog):
    """python -m dogs_tpu_torch.train_admm, then python -m
    dogs_tpu_torch.eval on its block checkpoint: the eval CLI's val PSNR
    equals the final validate() of the fused model."""
    tmp, overrides, _ = smoke
    args = ["--config", SMOKE, *overrides, "trainer.max_iterations=10", "trainer.n_checkpoint=5",
            "trainer.n_validation=5", "trainer.admm.consensus_interval=5", "geometry.densify_start_iter=1",
            "geometry.densify_end_iter=5", "geometry.densification_interval=3"]
    with caplog.at_level(logging.INFO):
        train_admm.main(args)
    final = [r.args for r in caplog.records if r.getMessage().startswith("final val")]  # the dict
    assert len(final) == 1 and final[0]["val_psnr"] > 12.0, final
    run = tmp / "out" / "gs_novel_view_synthesis_synthetic_toy_blocks_admm"
    for f in ("model/model.npz", "model/model_000010.npz", "export/model.splat", "export/point_cloud.ply"):
        assert (run / f).exists(), f
    assert os.path.getsize(run / "export" / "model.splat") == 32 * final[0]["num_points"]
    eval_main(args)
    metrics = json.loads((run / "eval" / "val" / "metrics.json").read_text())["mean"]
    assert abs(metrics["psnr"] - final[0]["val_psnr"]) <= 1e-4
