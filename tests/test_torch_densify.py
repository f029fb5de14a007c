"""The host-loop slice against dogs_tpu: densify / clone / split / prune, the
opacity reset, capacity and moment surgery, the schedule copy, the config
resolver and the factory, checkpoints in both directions, a bit-identical
resume and the train CLI. JAX runs on the CPU; the same numpy inputs go to
both packages, and the split noise is JAX's draw fed to the port."""

import dataclasses
import json
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import utils as j_utils
from dogs_tpu.data.synthetic import ring_cameras as j_ring_cameras
from dogs_tpu.fields import model as jmodel
from dogs_tpu.train import optim as joptim
from dogs_tpu.train import schedule as jschedule
from dogs_tpu.train import trainer as jtrainer
from dogs_tpu.train.checkpoint import CheckpointManager as JCheckpointManager
from dogs_tpu.train.checkpoint import _flatten_with_paths
from dogs_tpu.utils import config as jconfig
from dogs_tpu_torch import factory
from dogs_tpu_torch.core import gaussians as tgs
from dogs_tpu_torch.data import synthetic
from dogs_tpu_torch.fields import model as tmodel
from dogs_tpu_torch.train import schedule as tschedule
from dogs_tpu_torch.train import trainer as ttrainer
from dogs_tpu_torch.train.__main__ import main as cli_main
from dogs_tpu_torch.train.checkpoint import CheckpointManager, save_train_state, train_state_arrays
from dogs_tpu_torch.train.optim import SparseAdamState
from dogs_tpu_torch.utils import config as tconfig
from tests.test_torch_core import jax_params

REPO = Path(__file__).resolve().parents[1]
NAMES = tgs.PARAM_NAMES
STATS = ("grad_accum", "denom", "max_radii2d")
PARAM_ATOL = 1e-6
CONFIGS = sorted((REPO / "config" / "gaussian_splatting").glob("*.yaml"))


def np_(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def logit(p):
    return np.log(np.float32(p) / (1 - np.float32(p))).astype(np.float32)


# ---- model surgery -----------------------------------------------------------


def model_arrays(n, capacity, opacity=0.5, scale=0.1):
    """tests/test_fields_model.py:small_state as numpy arrays: n points of a
    seeded draw in `capacity` slots, SH degree 1, the given opacity and
    isotropic scale."""
    pts = np.random.RandomState(0).randn(n, 3).astype(np.float32)
    j = jmodel.init_from_points(jnp.asarray(pts), jnp.full((n, 3), 0.5), capacity, max_sh_degree=1)
    params = {k: np.array(getattr(j.params, k)) for k in NAMES}
    alive = np.array(j.alive)
    params["log_scale"][alive] = np.log(np.float32(scale))
    params["logit_opacity"][alive] = logit(opacity)
    stats = {k: np.zeros(capacity, np.float32) for k in STATS}
    return params, alive, stats


def mixed_arrays():
    """56 of 64 slots alive with random rotations and scales on both sides of
    percent_dense * extent, about half hot, a few below min_opacity or with
    a large screen or world size: clones, splits, every prune rule and an
    overflow in one event."""
    rng = np.random.RandomState(7)
    n = 56
    params, alive, stats = model_arrays(n, 64)
    params["quat"][:n] = rng.randn(n, 4)
    params["log_scale"][:n] = np.log(rng.uniform(0.001, 0.015, (n, 3)))
    params["log_scale"][:2] = np.log(0.5)  # big in world space
    params["logit_opacity"][:n, 0] = logit(rng.uniform(0.05, 0.9, n))
    params["logit_opacity"][2:4] = logit(0.002)
    stats["denom"][:n] = rng.randint(0, 4, n)
    stats["grad_accum"][:n] = stats["denom"][:n] * rng.uniform(0.0, 1.0, n)
    stats["max_radii2d"][:n] = rng.uniform(0.0, 105.0, n)
    return params, alive, stats


CASES = {
    # name: (arrays, edits, densify_and_prune keyword arguments)
    "clone": (lambda: model_arrays(8, 32, scale=0.001), dict(grad=[0]), dict(grad_threshold=0.5, max_screen_size=None)),
    "split": (lambda: model_arrays(8, 32, scale=0.5), dict(grad=[1]), dict(grad_threshold=0.5, max_screen_size=None)),
    "prune_opacity": (lambda: model_arrays(8, 32), dict(low_opacity=[3]),
                      dict(grad_threshold=10.0, max_screen_size=None)),
    "prune_screen_and_world": (lambda: model_arrays(8, 32, scale=0.01), dict(big_screen=[2], big_world=[4]),
                               dict(grad_threshold=10.0, max_screen_size=100.0)),
    "prune_bbox_z": (lambda: model_arrays(8, 32), dict(grad=[0, 5]),
                     dict(grad_threshold=0.5, max_screen_size=None, bbox_z_min=-0.3)),
    "overflow": (lambda: model_arrays(30, 32, scale=0.001), dict(grad=list(range(32))),
                 dict(grad_threshold=0.5, max_screen_size=None)),
    "mixed": (mixed_arrays, {}, dict(grad_threshold=0.5, max_screen_size=100.0, percent_dense=0.01)),
}


def case_arrays(name):
    make, edits, kw = CASES[name]
    params, alive, stats = make()
    for i in edits.get("grad", []):
        stats["grad_accum"][i], stats["denom"][i] = 1.0, 1.0
    for i in edits.get("low_opacity", []):
        params["logit_opacity"][i] = logit(0.001)
    for i in edits.get("big_screen", []):
        stats["max_radii2d"][i] = 500.0
    for i in edits.get("big_world", []):
        params["log_scale"][i] = np.log(5.0)
    kw = dict(dict(min_opacity=0.005, scene_extent=1.0), **kw)
    return params, alive, stats, kw


def jax_state(params, alive, stats):
    return jmodel.GaussianModelState(params=jax_params(params), alive=jnp.asarray(alive),
                                     **{k: jnp.asarray(v) for k, v in stats.items()})


def torch_state(params, alive, stats, device="cpu"):
    return tmodel.GaussianModelState(params=tgs.params_from_numpy(params, device),
                                     alive=torch.as_tensor(alive.copy(), device=device),
                                     **{k: torch.as_tensor(v.copy(), device=device) for k, v in stats.items()})


@pytest.mark.parametrize("case", list(CASES))
def test_densify_and_prune_matches_jax(case):
    params, alive, stats, kw = case_arrays(case)
    key = jax.random.PRNGKey(sorted(CASES).index(case))
    capacity = alive.shape[0]
    jstate = jax_state(params, alive, stats)
    j_need = int(jmodel.required_slots(jstate, kw["grad_threshold"], kw.get("percent_dense", 0.01), 1.0))
    jnew, j_alloc, j_over = jmodel.densify_and_prune(jstate, key, **kw)
    noise = np.array(jax.random.normal(key, (2 * capacity, 3), jnp.float32))

    tstate = torch_state(params, alive, stats)
    xyz_param = tstate.params.xyz
    t_need = int(tmodel.required_slots(tstate, kw["grad_threshold"], kw.get("percent_dense", 0.01), 1.0))
    tnew, t_alloc, t_over = tmodel.densify_and_prune(tstate, torch.from_numpy(noise), **kw)

    assert t_need == j_need
    assert tnew is tstate and tnew.params.xyz is xyz_param  # in place: the Parameters stay
    np.testing.assert_array_equal(np_(tnew.alive), np.asarray(jnew.alive))
    np.testing.assert_array_equal(np_(t_alloc), np.asarray(j_alloc))
    assert int(t_over) == int(j_over)
    for k in NAMES:
        np.testing.assert_allclose(np_(getattr(tnew.params, k)), np.asarray(getattr(jnew.params, k)),
                                   rtol=0, atol=PARAM_ATOL, err_msg=k)
    for k in STATS:
        assert not np_(getattr(tnew, k)).any(), k
    expect = {
        "clone": (9, 1, 0), "split": (9, 2, 0), "prune_opacity": (7, 0, 0), "prune_screen_and_world": (6, 0, 0),
        "overflow": (32, 2, 28),
    }.get(case)
    if expect is not None:  # tests/test_fields_model.py's counts
        assert (int(tnew.num_alive), int(t_alloc.sum()), int(t_over)) == expect
    if case == "mixed":  # every branch ran
        assert int(t_over) > 0 and j_need > 0
        assert np_(t_alloc)[:4].all()  # the pruned slots 0-3 are the first free ones


def test_split_children_subtract_jax_f32_log_of_1p6():
    params, alive, stats, kw = case_arrays("split")
    key = jax.random.PRNGKey(1)
    jnew, j_alloc, _ = jmodel.densify_and_prune(jax_state(params, alive, stats), key, **kw)
    tnew, t_alloc, _ = tmodel.densify_and_prune(
        torch_state(params, alive, stats), torch.from_numpy(np.array(jax.random.normal(key, (64, 3)))), **kw)
    slots = np_(t_alloc)
    np.testing.assert_array_equal(np_(tnew.params.log_scale)[slots], np.asarray(jnew.params.log_scale)[slots])
    np.testing.assert_allclose(np.exp(np_(tnew.params.log_scale)[slots]), 0.5 / 1.6, rtol=1e-6)


def test_reset_opacity_and_prune_only_match_jax():
    params, alive, stats = mixed_arrays()
    jstate, tstate = jax_state(params, alive, stats), torch_state(params, alive, stats)
    j = jmodel.reset_opacity(jstate, ceiling=0.01)
    t = tmodel.reset_opacity(tstate, ceiling=0.01)
    np.testing.assert_allclose(np_(t.params.logit_opacity), np.asarray(j.params.logit_opacity), rtol=0,
                               atol=PARAM_ATOL)
    assert (np_(t.params.opacity)[alive] <= 0.01 + 1e-7).all()
    np.testing.assert_array_equal(np_(t.params.logit_opacity)[~alive], params["logit_opacity"][~alive])
    mask = np.zeros(64, bool)
    mask[[0, 5, 50]] = True
    j = jmodel.prune_only(jstate, jnp.asarray(mask))
    t = tmodel.prune_only(tstate, torch.from_numpy(mask))
    np.testing.assert_array_equal(np_(t.alive), np.asarray(j.alive))
    assert int(t.num_alive) == 53


# ---- capacity and moment surgery -------------------------------------------


def train_states(n_images=3):
    """The same TrainState in both packages: mixed_arrays, random moments,
    step 5."""
    params, alive, stats = mixed_arrays()
    rng = np.random.RandomState(11)
    mu = {k: rng.randn(*a.shape).astype(np.float32) for k, a in params.items()}
    nu = {k: rng.rand(*a.shape).astype(np.float32) for k, a in params.items()}
    jts = jtrainer.train_state_from_model(jax_state(params, alive, stats), n_images, jtrainer.TrainerConfig())
    jts = jts.replace(opt=joptim.SparseAdamState(mu=jax_params(mu), nu=jax_params(nu)), step=jnp.int32(5))
    tts = dataclasses.replace(
        ttrainer.train_state_from_model(torch_state(params, alive, stats), n_images, ttrainer.TrainerConfig()),
        opt=SparseAdamState(mu={k: torch.from_numpy(v.copy()) for k, v in mu.items()},
                            nu={k: torch.from_numpy(v.copy()) for k, v in nu.items()}),
        step=5,
    )
    return jts, tts


def assert_same_leaves(t_arrays: dict, j_arrays: dict):
    """Equal key lists (in order), shapes, dtypes and values."""
    assert list(t_arrays) == list(j_arrays)
    for k, a in j_arrays.items():
        b = t_arrays[k]
        assert (b.shape, b.dtype) == (a.shape, a.dtype), k
        np.testing.assert_array_equal(b, a, err_msg=k)


def test_capacity_and_moment_surgery_matches_jax():
    jts, tts = train_states()
    assert_same_leaves(train_state_arrays(tts), _flatten_with_paths(jts)[0])
    grown_j, grown_t = jtrainer.grow_capacity(jts, 256), ttrainer.grow_capacity(tts, 256)
    assert_same_leaves(train_state_arrays(grown_t), _flatten_with_paths(grown_j)[0])
    assert isinstance(grown_t.model.params.xyz, torch.nn.Parameter)
    shrunk_j, shrunk_t = jtrainer.shrink_capacity(jts, 32), ttrainer.shrink_capacity(tts, 32)
    assert_same_leaves(train_state_arrays(shrunk_t), _flatten_with_paths(shrunk_j)[0])
    mask = np.random.RandomState(3).rand(64) > 0.6
    j_opt = jtrainer.zero_moments_at(jts.opt, jnp.asarray(mask))
    t_opt = ttrainer.zero_moments_at(tts.opt, torch.from_numpy(mask))
    j_opt = jtrainer.zero_opacity_moments(j_opt)
    t_opt = ttrainer.zero_opacity_moments(t_opt)
    assert_same_leaves(train_state_arrays(tts), _flatten_with_paths(jts.replace(opt=j_opt))[0])
    with pytest.raises(ValueError, match="cannot grow"):
        ttrainer.grow_capacity(tts, 64)
    with pytest.raises(ValueError, match="cannot shrink"):
        ttrainer.shrink_capacity(tts, 64)


# ---- schedule, config and factory ------------------------------------------


@pytest.mark.parametrize("cfg", [
    dict(sh_increase_interval=1000, max_sh_degree=3, coarse_to_fine=False, densify_end_iter=15000),
    dict(sh_increase_interval=10, max_sh_degree=2, coarse_to_fine=True, densify_end_iter=2000),
    dict(sh_increase_interval=7, max_sh_degree=4, coarse_to_fine=True, densify_end_iter=2),
])
def test_schedule_copy_matches_dogs_tpu(cfg):
    cfg = SimpleNamespace(**cfg)
    assert tschedule.c2f_interval(cfg) == jschedule.c2f_interval(cfg)
    for step in list(range(0, 60)) + [999, 1000, 4999, 5000, 13333, 30000]:
        assert tschedule.active_sh_degree(cfg, step) == jschedule.active_sh_degree(cfg, step), step
        assert tschedule.training_resolution(cfg, step) == jschedule.training_resolution(cfg, step), step


@pytest.mark.parametrize("path", CONFIGS, ids=[p.stem for p in CONFIGS])
def test_config_and_factory_match_dogs_tpu(path):
    """The resolver on every shipped config, with CLI overrides, and the
    factory's trainer and raster configs against root utils.py's."""
    overrides = ["trainer.max_iterations=1234", "geometry.densify_grad_threshold=3e-4", "seed=7"]
    t = tconfig.load_config(str(path), cli_overrides=overrides)
    j = jconfig.load_config(str(path), cli_overrides=overrides)
    assert json.dumps(t, sort_keys=True) == json.dumps(j, sort_keys=True)
    t_cfg, j_cfg = factory._trainer_config(t), j_utils._trainer_config(j)
    for f in ttrainer.TrainerConfig.__dataclass_fields__:
        if f != "reactive_capacity_growth":  # the port's own default (ROADMAP.md §3)
            assert getattr(t_cfg, f) == getattr(j_cfg, f), f
    t_raster, j_raster = factory._raster_config(t), j_utils._raster_config(j)
    for f in ("antialiasing", "depth_threshold", "max_tiles_per_gaussian"):
        assert getattr(t_raster, f) == getattr(j_raster, f), f


def test_factory_raises_for_unported_fields_and_datasets():
    """Scaffold-GS and block-parallel ADMM scenes raise; a COLMAP scene
    (dataset.name other than synthetic) is built by load_scene, so a missing
    scene directory is a missing file."""
    scaffold = tconfig.load_config(str(REPO / "config" / "scaffold_gs" / "synthetic_smoke.yaml"))
    with pytest.raises(NotImplementedError, match="item 6"):
        factory.create_trainer(scaffold)
    admm = tconfig.load_config(str(REPO / "config" / "gaussian_splatting" / "urban3d_admm.yaml"))
    with pytest.raises(NotImplementedError, match="item 5"):
        factory.create_trainer(admm)
    real = tconfig.load_config(str(REPO / "config" / "gaussian_splatting" / "mipnerf360.yaml"),
                               cli_overrides=[f"dataset.root_dir={REPO / 'no_such_dir'}", "device=cpu"])
    with pytest.raises(FileNotFoundError):
        factory.create_trainer(real)


def test_config_from_dicts_needs_no_yaml(monkeypatch):
    """The card has no PyYAML: a config built from dicts resolves without
    it, and so do dotlist overrides and a shipped YAML file, which the
    port's own reader parses."""
    import sys

    monkeypatch.setitem(sys.modules, "yaml", None)
    cfg = tconfig.resolve(tconfig.merge({"a": {"b": 3}, "c": "${a.b}"}, {"a": {"d": "x_${c}"}}))
    assert cfg.c == 3 and cfg.a.d == "x_3" and cfg.a.b == 3
    assert tconfig.from_dotlist(["a=1", "b.c=[2, 3]", "d=2e-4"]) == {"a": 1, "b": {"c": [2, 3]}, "d": "2e-4"}
    smoke = tconfig.load_config(str(REPO / "config" / "gaussian_splatting" / "synthetic_smoke.yaml"),
                                cli_overrides=["trainer.max_iterations=6"])
    assert smoke.optimizer.lr.position_max_iterations == 6 and smoke.expname == "gs_novel_view_synthesis_synthetic_['toy']"


# ---- checkpoints -------------------------------------------------------------


def tiny_trainers(j_min_capacity, t_min_capacity, n_cams=4):
    """A JAX (None for j_min_capacity None) and a port trainer on the same
    40 points and 4 ring cameras (blank images: nothing is trained)."""
    rng = np.random.RandomState(2)
    pts, cols = rng.randn(40, 3).astype(np.float32), rng.rand(40, 3).astype(np.float32)
    imgs = [np.zeros((32, 32, 3), np.float32)] * n_cams
    jt = None if j_min_capacity is None else jtrainer.GaussianSplatTrainer(
        j_ring_cameras(n_cams, 4.0, 32, 32, 28.8), imgs, pts, cols,
        jtrainer.TrainerConfig(min_capacity=j_min_capacity, max_sh_degree=1), seed=5,
    )
    tt = ttrainer.GaussianSplatTrainer(
        synthetic.ring_cameras(n_cams, 4.0, 32, 32, 28.8, device="cpu"), imgs, pts, cols,
        ttrainer.TrainerConfig(min_capacity=t_min_capacity, max_sh_degree=1), seed=5, device="cpu",
    )
    return jt, tt


def fill_random(arrays: dict, seed: int) -> dict:
    rng = np.random.RandomState(seed)
    out = {}
    for k, a in arrays.items():
        if a.dtype == bool:
            out[k] = rng.rand(*a.shape) > 0.3
        elif a.dtype == np.float32 and not k.startswith((".exposure", ".pose")):
            out[k] = rng.randn(*a.shape).astype(np.float32)
        else:
            out[k] = a
    return out


def port_state_from_arrays(arrays: dict, step: int, n_images: int) -> ttrainer.TrainState:
    model = torch_state({k: arrays[f".model/.params/.{k}"] for k in NAMES}, arrays[".model/.alive"],
                        {k: arrays[f".model/.{k}"] for k in STATS})
    opt = SparseAdamState(**{m: {k: torch.from_numpy(arrays[f".opt/.{m}/.{k}"].copy()) for k in NAMES}
                             for m in ("mu", "nu")})
    return dataclasses.replace(ttrainer.train_state_from_model(model, n_images, ttrainer.TrainerConfig()),
                               opt=opt, step=step)


def test_port_checkpoint_loads_in_the_jax_trainer(tmp_path):
    jt, tt = tiny_trainers(j_min_capacity=16, t_min_capacity=128)
    assert (jt.state.model.capacity, tt.state.model.capacity) == (64, 128)  # JAX grows on load
    tt.state = port_state_from_arrays(fill_random(train_state_arrays(tt.state), 1), 7, 4)
    tt.rng.permutation(4)
    path = tt.save_checkpoint(CheckpointManager(str(tmp_path / "port")))
    assert Path(path).name == "model_000007.npz"
    assert jt.load_checkpoint(JCheckpointManager(str(tmp_path / "jax")), path) == 7
    with np.load(path) as data:
        assert_same_leaves(_flatten_with_paths(jt.state)[0], {k: data[k] for k in data.files if k != "__meta__"})
    np.testing.assert_array_equal(jt.rng.get_state()[1], tt.rng.get_state()[1])
    assert jt.spatial_lr_scale == tt.spatial_lr_scale


def test_jax_checkpoint_loads_in_the_port_trainer(tmp_path):
    jt, tt = tiny_trainers(j_min_capacity=16, t_min_capacity=128)
    treedef = jax.tree_util.tree_structure(jt.state)
    arrays = fill_random(_flatten_with_paths(jt.state)[0], 2)
    jt.state = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(a) for a in arrays.values()])
    jt.state = jt.state.replace(step=jnp.int32(9))
    jt.rng.permutation(4)
    path = jt.save_checkpoint(JCheckpointManager(str(tmp_path / "jax")))
    assert tt.load_checkpoint(CheckpointManager(str(tmp_path / "port")), path) == 9
    assert tt.state.model.capacity == 64  # shrunk from 128 by the probe
    with np.load(path) as data:
        assert_same_leaves(train_state_arrays(tt.state), {k: data[k] for k in data.files if k != "__meta__"})
    np.testing.assert_array_equal(tt.rng.get_state()[1], jt.rng.get_state()[1])


def test_checkpoint_leaves_match_jax_keys_shapes_and_dtypes(tmp_path):
    jt, tt = tiny_trainers(j_min_capacity=64, t_min_capacity=64)
    j_path = jt.save_checkpoint(JCheckpointManager(str(tmp_path / "jax")))
    t_path = tt.save_checkpoint(CheckpointManager(str(tmp_path / "port")))
    with np.load(j_path) as j, np.load(t_path) as t:
        assert j.files == t.files  # same keys, same order
        for k in j.files[1:]:  # after __meta__
            assert (t[k].shape, t[k].dtype) == (j[k].shape, j[k].dtype), k
        assert t[".step"].dtype == np.int32 and t[".model/.alive"].dtype == bool
        j_meta, t_meta = json.loads(str(j["__meta__"])), json.loads(str(t["__meta__"]))
    assert t_meta["format_version"] == j_meta["format_version"] == 1
    assert set(j_meta["extra"]) <= set(t_meta["extra"])


def test_checkpoint_manager_retention_and_version_guard(tmp_path):
    _, tt = tiny_trainers(j_min_capacity=64, t_min_capacity=64)
    port, ref = CheckpointManager(str(tmp_path / "port"), max_to_keep=2), JCheckpointManager(
        str(tmp_path / "jax"), max_to_keep=2)
    assert port.latest_path() is None and port.load(tt.state) == (None, {})
    jt_state = jtrainer.train_state_from_model(
        jmodel.init_from_points(jnp.zeros((4, 3)), jnp.zeros((4, 3)), 8, 1), 1, jtrainer.TrainerConfig())
    for step in (1, 2, 3):
        tt.state.step = step
        port.save(step, tt.state, {"k": step})
        ref.save(step, jt_state)
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(
        p.name for p in (tmp_path / "jax").iterdir()) == [
        "checkpoints.txt", "model.npz", "model_000002.npz", "model_000003.npz"]
    assert (tmp_path / "port" / "checkpoints.txt").read_text() == "model_000002.npz\nmodel_000003.npz\n"
    state, extra = port.load(tt.state)
    assert state.step == 3 and extra == {"k": 3, "step": 3}
    newer = tmp_path / "newer.npz"
    np.savez(newer, __meta__=json.dumps({"extra": {}, "format_version": 2}),
             **train_state_arrays(tt.state))
    with pytest.raises(ValueError, match="format_version 2"):
        port.load(tt.state, str(newer))
    tt.state = ttrainer.grow_capacity(tt.state, 128)
    with pytest.raises(ValueError, match="resize the template"):
        port.load(tt.state)


# ---- resume and the CLI -------------------------------------------------------


@pytest.mark.parametrize("reactive", [False, True], ids=["grow_first", "reactive"])
def test_resume_continues_bit_for_bit(tmp_path, caplog, reactive):
    """Save at step 7, resume in a fresh trainer, and continue across the
    densify event at step 10: every leaf and every metric equal the
    uninterrupted run's. Densify every 5 steps splits every Gaussian, so
    capacity grows (grow-first: before the event; reactive: after the
    logged overflow at step 5)."""
    scene = synthetic.make_scene(n_gaussians=40, n_cams=8, width=32, height=32, seed=3, device="cpu")
    cfg = ttrainer.TrainerConfig(densify_start_iter=2, densification_interval=5, opacity_reset_interval=10**6,
                                 max_sh_degree=2, sh_increase_interval=4, min_capacity=64,
                                 reactive_capacity_growth=reactive)

    def make():
        return ttrainer.GaussianSplatTrainer(scene.cameras, scene.images, scene.points, scene.colors, cfg,
                                             seed=4, device="cpu")

    whole, first, resumed = make(), make(), make()
    caplog.set_level("INFO")
    whole.train(12, log_every=1)
    # Reactive: the event at step 5 drops candidates (logged), the next one
    # grows first; grow-first grows before the event and drops nothing.
    assert ("densify overflow: " in caplog.text) == reactive
    assert ("reactive capacity growth" if reactive else "growing capacity") in caplog.text
    first.train(7, log_every=1)
    first.save_checkpoint(CheckpointManager(str(tmp_path)))
    assert resumed.load_checkpoint(CheckpointManager(str(tmp_path))) == 7
    resumed.train(5, log_every=1)
    assert whole.state.model.capacity == resumed.state.model.capacity > 64
    assert_same_leaves(train_state_arrays(resumed.state), train_state_arrays(whole.state))
    drop = ("iters_per_sec",)
    assert [{k: v for k, v in m.items() if k not in drop} for m in resumed.metrics_history] == [
        {k: v for k, v in m.items() if k not in drop} for m in whole.metrics_history[7:]]
    assert resumed._order == whole._order
    assert torch.equal(resumed.noise_gen.get_state(), whole.noise_gen.get_state())


def test_resume_from_another_device_type_reseeds_the_split_noise(tmp_path, caplog):
    """A checkpoint whose split-noise state is a CUDA generator's (16 bytes of
    Philox state, with or without its device type) resumes on the CPU: the
    generator is reseeded from the seed and the step, and that is logged. A
    CPU generator's state is restored as it was saved."""
    _, tt = tiny_trainers(None, 64)
    tt.state.step = 7
    expect = torch.Generator().manual_seed(ttrainer.split_noise_seed(5, 7)).get_state()
    caplog.set_level("INFO")
    for i, device_key in enumerate(({"noise_rng_device": "cuda"}, {})):
        path = str(tmp_path / f"cuda_noise_{i}.npz")
        save_train_state(path, tt.state, {"noise_rng": list(range(16)), **device_key})
        _, resumed = tiny_trainers(None, 64)
        assert resumed.load_checkpoint(CheckpointManager(str(tmp_path / "m")), path) == 7
        assert torch.equal(resumed.noise_gen.get_state(), expect)
    assert caplog.text.count("split noise reseeded at step 7") == 2
    tt.noise_gen.manual_seed(123)
    tt._split_noise(64)
    tt.save_checkpoint(CheckpointManager(str(tmp_path / "cpu")))
    _, resumed = tiny_trainers(None, 64)
    assert resumed.load_checkpoint(CheckpointManager(str(tmp_path / "cpu"))) == 7
    assert torch.equal(resumed.noise_gen.get_state(), tt.noise_gen.get_state())


@pytest.mark.parametrize("field", ["coarse_to_fine", "profile_num_steps"])
def test_unported_host_features_raise(field):
    cfg = ttrainer.TrainerConfig(**{field: 1})
    with pytest.raises(NotImplementedError, match="item 7"):
        ttrainer.GaussianSplatTrainer([], [], np.zeros((4, 3), np.float32), np.zeros((4, 3), np.float32), cfg,
                                      device="cpu")


def test_cli_trains_writes_a_checkpoint_and_resumes(tmp_path, caplog):
    args = ["--config", str(REPO / "config" / "gaussian_splatting" / "synthetic_smoke.yaml"),
            "device=cpu", "trainer.max_iterations=3", "trainer.n_tensorboard=1", "trainer.n_validation=2",
            f"root_dir={tmp_path}"]
    caplog.set_level("INFO")
    cli_main(args)
    run = tmp_path / "gs_novel_view_synthesis_synthetic_toy"
    assert (run / "model" / "model_000003.npz").exists() and (run / "model" / "model.npz").exists()
    assert any(p.name.startswith("events.out.tfevents") for p in (run / "logs").iterdir())
    assert "final val" in caplog.text
    with np.load(run / "model" / "model.npz") as data:
        assert int(data[".step"]) == 3 and data[".model/.params/.feat_rest"].shape[1] == 15  # SH 3
    caplog.clear()
    cli_main(args + ["trainer.resume=true"])
    assert "resumed from step 3" in caplog.text and "nothing to do" in caplog.text
