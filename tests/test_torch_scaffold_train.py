"""Scaffold-GS's training half against dogs_tpu: one step's updated state,
anchor growing and pruning with capacity growth, a trainer run across
anchor events, checkpoints both ways and the port's bit-for-bit resume,
and the train and eval CLIs against eval.py. JAX runs on the CPU with the
XLA raster path; the same numpy inputs go to both packages."""

import json
import logging
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dogs_tpu.data.synthetic import make_scene as j_make_scene
from dogs_tpu.fields import scaffold as js
from dogs_tpu.train.checkpoint import CheckpointManager as JCheckpointManager
from dogs_tpu.train.checkpoint import _flatten_with_paths
from dogs_tpu_torch.data import synthetic
from dogs_tpu_torch.eval.__main__ import main as eval_cli_main
from dogs_tpu_torch.fields import scaffold as ts
from dogs_tpu_torch.train.__main__ import main as train_cli_main
from dogs_tpu_torch.train.checkpoint import CheckpointManager
from tests.test_torch_scaffold import J_RASTER, T_RASTER, j_params, np_

REPO = Path(__file__).resolve().parents[1]
MOMENT_ATOL = 2e-3  # of each leaf's max, as tests/test_torch_train.py holds the step's moments
VAL_TOL = 0.2  # dB, final validate(), as tests/test_torch_train.py
# 30 steps with anchor events at 10, 20 and 30 (check_interval 10): growth at
# every level (a threshold far below the screen gradients, so that growth
# hangs on the exact visibility counts and the shared RandomState) and
# pruning of the anchors that stay dim.
RUN = dict(max_iterations=30, voxel_size=0.25, k_offsets=4, stat_start_iter=1, densify_start_iter=5,
           densify_end_iter=30, densification_interval=10, update_init_factor=4, check_interval=10,
           densify_grad_threshold=1e-7, min_opacity=0.05)


def j_arrays(tree) -> dict:
    return _flatten_with_paths(tree)[0]


def assert_states_equal(t_state: ts.ScaffoldTrainState, j_state) -> None:
    got, want = ts.scaffold_state_arrays(t_state), j_arrays(j_state)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's small tensors, as
    tests/test_torch_master.py: in the parallel test workers, a thread a
    core makes the port's many small ops wait on each other's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scenes():
    kw = dict(n_gaussians=48, n_cams=8, width=64, height=48, seed=5)
    jsc = j_make_scene(raster_cfg=J_RASTER, **kw)
    tsc = synthetic.make_scene(**kw, device="cpu")
    return jsc, tsc


def trainers(scenes, seed=42, **cfg):
    jsc, tsc = scenes
    jt = js.ScaffoldGSTrainer(jsc.cameras[:7], jsc.images[:7], jsc.points, raster_cfg=J_RASTER,
                              val_cameras=jsc.cameras[7:], val_images=jsc.images[7:], seed=seed,
                              scaffold_cfg=js.ScaffoldConfig(**cfg))
    tt = ts.ScaffoldGSTrainer(tsc.cameras[:7], tsc.images[:7], tsc.points, raster_cfg=T_RASTER,
                              val_cameras=tsc.cameras[7:], val_images=tsc.images[7:], seed=seed,
                              scaffold_cfg=ts.ScaffoldConfig(**cfg), device="cpu")
    return jt, tt


@pytest.mark.parametrize("heads", [{}, dict(use_feat_bank=True, appearance_dim=8)], ids=["plain", "bank_app"])
def test_one_step_state_matches_jax(scenes, heads):
    """From the same initial state: each parameter within 2x its group's
    learning rate (Adam's first step is lr * sign(g), and a gradient within
    rounding of 0 may take either sign), the moments within 2e-3 of each
    leaf's max, the counts equal and the accumulated statistics within 2e-3
    of their max."""
    cfg = dict(max_iterations=100, voxel_size=0.25, k_offsets=5, stat_start_iter=0, **heads)
    jt, tt = trainers(scenes, **cfg)
    assert_states_equal(tt.state, jt.state)
    before = {k: v.copy() for k, v in ts.scaffold_state_arrays(tt.state).items()}
    jsc, tsc = scenes
    jnew, jm = jt._step_fn(jt.state, jsc.cameras[2], jnp.asarray(jsc.images[2]))
    tnew, tm = tt._step_fn(tt.state, tsc.cameras[2], tsc.images[2])
    assert tnew.step == int(jnew.step) == 1
    for k in ("loss", "psnr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    c = ts.ScaffoldConfig(**cfg)
    lr = dict(anchor_xyz=c.anchor_lr_init, anchor_feat=c.feat_lr, offsets=c.offset_lr_init,
              log_scaling=c.scaling_lr, mlp_opacity=c.mlp_lr_init, mlp_color=c.mlp_lr_init, mlp_cov=c.mlp_lr_init,
              mlp_feat_bank=c.mlp_lr_init, app_embedding=c.app_lr)
    got, want = ts.scaffold_state_arrays(tnew), j_arrays(jnew)
    for key, w in want.items():
        g = got[key]
        group, _, leaf = key[1:].partition("/")
        if group == "params":
            np.testing.assert_allclose(g, w, rtol=0, atol=2 * lr[leaf[1:].split("/")[0]], err_msg=key)
        elif group in ("mu", "nu", "opacity_accum", "offset_grad_accum") and w.size:
            np.testing.assert_allclose(g, w, rtol=0, atol=MOMENT_ATOL * np.abs(w).max(), err_msg=key)
        elif group in ("step", "alive", "anchor_denom", "offset_denom"):
            np.testing.assert_array_equal(g, w, err_msg=key)
    assert want[".offset_denom"].sum() > 0 and want[".opacity_accum"].sum() > 0
    # The parameters that moved: every leaf the loss reaches.
    moved = [k for k in want if k.startswith(".params/") and not np.array_equal(got[k], before[k])]
    assert ".params/.anchor_feat" in moved and ".params/.mlp_cov/['w1']" in moved


def constructed_states(case: str):
    """A dogs_tpu and a port state from the same arrays: random moments,
    offsets spread over 0.4 so that candidates reach fresh cells at every
    level, screen gradients over the threshold, and (case "prune") zero
    opacity on the odd anchors, or (case "capacity") every slot alive so
    that growth has to grow the buffers."""
    rng = np.random.RandomState(2)
    points = rng.rand(60, 3).astype(np.float32) * 2.0
    n_anchors = len(ts.voxelize_points(points, 0.1))
    arrays, alive = ts.init_scaffold_arrays(points, voxel_size=0.1, k_offsets=4,
                                            capacity=n_anchors if case == "capacity" else None)
    arrays[".log_scaling"][:, :3] = np.log(0.4)
    cap = alive.size
    stats = dict(
        opacity_accum=np.where(np.arange(cap) % 2 == 0, 50.0, 0.0).astype(np.float32),
        anchor_denom=np.full((cap,), 20.0, np.float32),
        offset_grad_accum=(rng.rand(cap, 4) * 2e-2).astype(np.float32),
        offset_denom=rng.randint(0, 30, (cap, 4)).astype(np.float32),
    )
    moments = [{k: (rng.randn(*a.shape) * 1e-3).astype(np.float32) for k, a in arrays.items()} for _ in range(2)]
    j_state = js.ScaffoldTrainState(
        params=j_params(arrays), mu=j_params(moments[0]), nu=j_params(moments[1]), step=jnp.asarray(100, jnp.int32),
        alive=jnp.asarray(alive), **{k: jnp.asarray(v) for k, v in stats.items()})
    t_state = ts.ScaffoldTrainState(
        params=ts.scaffold_params_from_numpy(arrays, "cpu"),
        mu=ts.scaffold_params_from_numpy(moments[0], "cpu", requires_grad=False),
        nu=ts.scaffold_params_from_numpy(moments[1], "cpu", requires_grad=False), step=100,
        alive=torch.from_numpy(alive), **{k: torch.from_numpy(v) for k, v in stats.items()})
    return j_state, t_state


@pytest.mark.parametrize("case", ["prune", "capacity"])
def test_grow_and_prune_anchors_matches_jax(case, caplog):
    """Equal arrays after an event, the zeroed and zero-extended moments
    included, with growth at every hierarchy level (voxel sizes 0.4, 0.2
    and 0.1) and the same draws."""
    j_state, t_state = constructed_states(case)
    cap = t_state.capacity
    cfg = dict(voxel_size=0.1, k_offsets=4, densify_grad_threshold=1e-3, update_init_factor=4,
               update_hierarchy_factor=2, check_interval=10, success_threshold=0.5, min_opacity=0.05)
    j_rng, t_rng = np.random.RandomState(3), np.random.RandomState(3)
    jnew, jstats = js.grow_and_prune_anchors(j_state, js.ScaffoldConfig(**cfg), j_rng, do_prune=case == "prune")
    caplog.set_level(logging.INFO, logger=ts.logger.name)
    tnew, tstats = ts.grow_and_prune_anchors(t_state, ts.ScaffoldConfig(**cfg), t_rng, do_prune=case == "prune")
    assert tstats == jstats and tstats["grown"] > 0
    assert (tstats["pruned"] > 0) == (case == "prune")
    assert_states_equal(tnew, jnew)
    assert all(np.array_equal(a, b) for a, b in zip(t_rng.get_state()[1:], j_rng.get_state()[1:]))
    if case == "capacity":
        assert tnew.capacity == ts.round_up_capacity(cap + tstats["grown"], 256) > cap
        assert f"anchor capacity grown to {tnew.capacity}" in caplog.text
    # The filled slots: alive with zero offsets (initial offsets are drawn
    # from U(-0.5, 0.5)), one voxel size per level, and zero moments.
    filled = np_(tnew.alive) & ~np_(tnew.params.offsets).any(axis=(1, 2))
    assert filled.sum() == tstats["grown"]
    assert np.unique(np_(tnew.params.log_scaling)[filled, 0]).size == 3
    for m in (tnew.mu, tnew.nu):
        for k in ts.ANCHOR_LEAVES:
            assert not np_(getattr(m, k))[filled].any(), k
    assert all(v.requires_grad for v in tnew.params.leaves().values())


@pytest.fixture(scope="module")
def runs(scenes):
    """Both trainers over 30 steps with anchor events at 10, 20 and 30."""
    jt, tt = trainers(scenes, **RUN)
    vals = [(jt.validate()["val_psnr"], tt.validate()["val_psnr"])]
    for trainer in (jt, tt):
        trainer.train(num_iterations=30, log_every=1)
    vals.append((jt.validate()["val_psnr"], tt.validate()["val_psnr"]))
    return jt, tt, vals


def test_trainer_run_matches_jax(runs):
    jt, tt, vals = runs
    assert [m["step"] for m in tt.metrics_history] == list(range(1, 31))
    j_anchors = [m["n_anchors"] for m in jt.metrics_history]
    assert [m["n_anchors"] for m in tt.metrics_history] == j_anchors
    assert len(set(j_anchors)) >= 3, j_anchors  # every event changed the anchors
    assert tt.state.capacity == jt.state.alive.shape[0] and list(tt._order) == [int(i) for i in jt._order]
    for a, b in zip(jt.metrics_history, tt.metrics_history):
        assert abs(a["psnr"] - b["psnr"]) < 0.05, (a["step"], a["psnr"], b["psnr"])
    for jv, tv in vals:
        assert abs(jv - tv) < VAL_TOL, (jv, tv)
    assert vals[1][1] > vals[0][1] + 2.0


def test_checkpoints_load_both_ways(runs, scenes, tmp_path):
    """dogs_tpu's trainer reads the port's file; the port reads dogs_tpu's,
    across a capacity change (dogs_tpu's state grown to 512 slots), with
    dogs_tpu's RandomState rule: the key restored at position 0."""
    jt, tt, _ = runs
    port_mgr = CheckpointManager(str(tmp_path / "port"))
    tt.save_checkpoint(port_mgr)
    j_fresh, t_fresh = trainers(scenes, **RUN)
    assert j_fresh.load_checkpoint(JCheckpointManager(str(tmp_path / "port"))) == 30
    assert_states_equal(tt.state, j_fresh.state)
    np.testing.assert_array_equal(j_fresh.rng.get_state()[1], tt.rng.get_state()[1])

    trained = jt.state
    jt.state = js._resize_scaffold_state(trained, 512)
    jt.save_checkpoint(JCheckpointManager(str(tmp_path / "jax")))
    assert t_fresh.state.capacity == 256
    assert t_fresh.load_checkpoint(CheckpointManager(str(tmp_path / "jax"))) == 30
    assert t_fresh.state.capacity == 512
    assert_states_equal(t_fresh.state, jt.state)
    jt.state = trained
    assert t_fresh.rng.get_state()[2] == 0 and t_fresh._order == []
    np.testing.assert_array_equal(t_fresh.rng.get_state()[1], jt.rng.get_state()[1])
    _, m = t_fresh._step_fn(t_fresh.state, scenes[1].cameras[0], scenes[1].images[0])
    assert np.isfinite(float(m["loss"]))


def test_port_resumes_bit_for_bit(scenes, tmp_path):
    """A checkpoint after step 15 resumed in a fresh trainer: the events at
    20 and 30 draw from the restored RandomState position and the pending
    camera order, and the two runs end equal bit for bit."""
    _, tt = trainers(scenes, **RUN)
    tt.train(num_iterations=15, log_every=0)
    mgr = CheckpointManager(str(tmp_path))
    tt.save_checkpoint(mgr)
    _, resumed = trainers(scenes, **RUN)
    assert resumed.load_checkpoint(mgr) == 15 and resumed._order == tt._order
    for trainer in (tt, resumed):
        trainer.train(num_iterations=15, log_every=5)
    a, b = ts.scaffold_state_arrays(tt.state), ts.scaffold_state_arrays(resumed.state)
    assert list(a) == list(b) and all(np.array_equal(a[k], b[k]) for k in a)
    assert [m["loss"] for m in tt.metrics_history[-3:]] == [m["loss"] for m in resumed.metrics_history]


def test_cli_scaffold_matches_eval_py(tmp_path, caplog):
    """The port's train CLI on scaffold_gs/synthetic_smoke.yaml writes a
    checkpoint and resumes to "nothing to do"; the port's eval CLI and
    eval.py's evaluate score it alike, uncorrected (the val PSNR within
    1e-4 dB and SSIM within 1e-4), and both export the decoded Gaussians."""
    import eval as j_eval

    from dogs_tpu.utils.config import load_config as j_load_config

    config = str(REPO / "config" / "scaffold_gs" / "synthetic_smoke.yaml")
    common = ["trainer.max_iterations=6", "trainer.enable_tensorboard=false", "eval.n_test_poses=2",
              "eval.color_correct=false"]
    port_root, jax_root = tmp_path / "port", tmp_path / "jax"
    caplog.set_level(logging.INFO)
    train_cli_main(["--config", config, "device=cpu", f"root_dir={port_root}", *common])
    train_cli_main(["--config", config, "device=cpu", f"root_dir={port_root}", "trainer.resume=true", *common])
    assert "resumed from step 6" in caplog.text and "nothing to do" in caplog.text
    expname = "scaffold_gs_novel_view_synthesis_synthetic_toy"
    shutil.copytree(port_root / expname / "model", jax_root / expname / "model")
    eval_cli_main(["--config", config, "device=cpu", f"root_dir={port_root}", *common])
    j_cfg = j_load_config(config, cli_overrides=[f"root_dir={jax_root}", *common])
    j_cfg.dataset.scene, j_cfg.expname = "toy", expname
    j_eval.evaluate(j_cfg)

    def metrics(root):
        return json.loads((root / expname / "eval" / "val" / "metrics.json").read_text())["mean"]

    got, want = metrics(port_root), metrics(jax_root)
    assert got["step"] == want["step"] == 6 and got["num_points"] == want["num_points"] > 0
    assert abs(got["psnr"] - want["psnr"]) < 1e-4, (got, want)
    assert abs(got["ssim"] - want["ssim"]) < 1e-4, (got, want)
    for root in (port_root, jax_root):
        export = root / expname / "export"
        assert (export / "model.splat").stat().st_size == 32 * got["num_points"]
        assert (export / "model.ply").exists()
        assert sorted(p.name for p in (root / expname / "eval" / "test").glob("*.png")) == ["00000.png", "00001.png"]
