"""Scaffold-GS's decode half against dogs_tpu: voxelization and the initial
draws, the frustum prefilter, the per-view MLP decode, the render, and one
step's gradient of every leaf and of the means2d offset through the MLP
heads, at init and after 10 steps. JAX runs on the CPU with the XLA raster
path; the same numpy arrays go to both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dogs_tpu.data.synthetic import make_scene as j_make_scene
from dogs_tpu.fields import scaffold as js
from dogs_tpu.raster.ssim import ssim as j_ssim
from dogs_tpu.raster.tiled import RasterConfig as JRasterConfig
from dogs_tpu.raster.tiled import render_tiled as j_render_tiled
from dogs_tpu_torch.data import synthetic
from dogs_tpu_torch.fields import scaffold as ts
from dogs_tpu_torch.raster.tiled import RasterConfig

J_RASTER = JRasterConfig(tile_batch=16, chunk=32)  # the XLA path, as tests/test_scaffold.py runs it
T_RASTER = RasterConfig()
RTOL, ATOL = 1e-5, 1e-6  # the decode
RENDER_ATOL = 3e-4  # tests/test_pallas_blend.py:32
GRAD_ATOL = 2e-3  # max-normalized, tests/test_pallas_blend.py:60
HEADS = {"plain": {}, "bank_app": dict(use_feat_bank=True, appearance_dim=8)}


def np_(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def j_arrays(tree) -> dict:
    """The leaves of a JAX pytree keyed as dogs_tpu's checkpoints key them."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(p) for p in path): np.asarray(leaf) for path, leaf in flat}


def j_params(arrays: dict) -> js.ScaffoldParams:
    """A JAX ScaffoldParams from arrays keyed as `ScaffoldParams.leaves`."""
    fields = {"mlp_feat_bank": {}}
    for key, a in arrays.items():
        name, _, sub = key[1:].partition("/")
        if sub:
            fields.setdefault(name, {})[sub[2:-2]] = jnp.asarray(a)
        else:
            fields[name] = jnp.asarray(a)
    return js.ScaffoldParams(**fields)


def t_arrays(sp: ts.ScaffoldParams) -> dict:
    return {k: np_(v) for k, v in sp.leaves().items()}


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
    kw = dict(n_gaussians=40, n_cams=6, width=64, height=48, seed=3)
    jsc = j_make_scene(raster_cfg=J_RASTER, **kw)
    tsc = synthetic.make_scene(**kw, device="cpu")
    np.testing.assert_array_equal(tsc.points, jsc.points)
    return jsc, tsc


def warm(arrays: dict, seed: int) -> dict:
    """Features and MLP weights moved off their init (numpy draws), so that
    the decode is not dominated by the view direction."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, a in arrays.items():
        if k.startswith((".anchor_feat", ".mlp_", ".app_embedding")):
            a = (a + rng.randn(*a.shape).astype(np.float32) * (0.5 if k == ".anchor_feat" else 0.1)).astype(np.float32)
        out[k] = a
    return out


@pytest.mark.parametrize("heads", list(HEADS))
def test_voxelize_and_init_draw_dogs_tpu_arrays(scenes, heads):
    """Anchors, the RandomState draws (features, offsets, the MLP heads in
    dogs_tpu's order) and the alive mask are equal, bit for bit."""
    jsc, _ = scenes
    np.testing.assert_array_equal(ts.voxelize_points(jsc.points, 0.25), js.voxelize_points(jsc.points, 0.25))
    kw = dict(voxel_size=0.25, k_offsets=5, seed=7, num_cameras=5, **HEADS[heads])
    jsp, jalive = js.init_scaffold(jsc.points, **kw)
    arrays, alive = ts.init_scaffold_arrays(jsc.points, **kw)
    want = j_arrays(jsp)
    assert list(arrays) == list(want)  # dogs_tpu's leaf order
    for k in want:
        assert arrays[k].dtype == want[k].dtype and arrays[k].shape == want[k].shape, k
        np.testing.assert_array_equal(arrays[k], want[k], err_msg=k)
    np.testing.assert_array_equal(alive, np.asarray(jalive))
    sp, talive = ts.init_scaffold(jsc.points, device="cpu", **kw)
    assert sp.num_anchors == jsp.num_anchors and sp.k_offsets == 5
    assert sp.appearance_dim == jsp.appearance_dim and bool(sp.mlp_feat_bank) == bool(jsp.mlp_feat_bank)
    assert all(v.requires_grad for v in sp.leaves().values()) and not talive.requires_grad


@pytest.mark.parametrize("cam", [0, 3])
def test_anchor_frustum_mask_matches(scenes, cam):
    jsc, tsc = scenes
    arrays, _ = ts.init_scaffold_arrays(jsc.points, voxel_size=0.25, k_offsets=5)
    # Anchors spread past the frustum, and some behind the camera.
    arrays[".anchor_xyz"] = (np.random.RandomState(cam).randn(256, 3) * 4.0).astype(np.float32)
    want = np.asarray(js.anchor_frustum_mask(j_params(arrays), jsc.cameras[cam]))
    got = np_(ts.anchor_frustum_mask(ts.scaffold_params_from_numpy(arrays, "cpu"), tsc.cameras[cam]))
    assert 0 < want.sum() < want.size
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("state", ["init", "warm"])
@pytest.mark.parametrize("heads", list(HEADS))
def test_generate_neural_gaussians_matches(scenes, heads, state):
    """Every decoded field at rtol 1e-5 / atol 1e-6 (the opacity through its
    sigmoid, see below). The alive mask is equal except where the tanh
    opacity is within rounding of 0: those entries are counted and bounded."""
    jsc, tsc = scenes
    arrays, alive = ts.init_scaffold_arrays(jsc.points, voxel_size=0.25, k_offsets=5, num_cameras=5,
                                            **HEADS[heads])
    if state == "warm":
        arrays = warm(arrays, 1)
    rng = np.random.RandomState(2)
    visible = rng.rand(alive.size) > 0.2
    cam_j, cam_t = jsc.cameras[2], tsc.cameras[2]
    jg, jc, jna, jaux = js.generate_neural_gaussians(j_params(arrays), cam_j, alive=jnp.asarray(alive),
                                                     visible_mask=jnp.asarray(visible), with_aux=True)
    tg, tc, tna, taux = ts.generate_neural_gaussians(ts.scaffold_params_from_numpy(arrays, "cpu"), cam_t,
                                                     alive=torch.from_numpy(alive),
                                                     visible_mask=torch.from_numpy(visible), with_aux=True)
    for k in ("xyz", "feat_dc", "feat_rest", "log_scale", "quat"):
        np.testing.assert_allclose(np_(getattr(tg, k)), np.asarray(getattr(jg, k)), rtol=RTOL, atol=ATOL, err_msg=k)
    # The logit of an opacity clipped near 1e-4 amplifies the tanh's f32
    # rounding by 1 / (op (1 - op)) ~ 1e4; the rasterizer reads its sigmoid.
    np.testing.assert_allclose(np_(tg.opacity), np.asarray(jg.opacity), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np_(tc), np.asarray(jc), rtol=RTOL, atol=ATOL)
    op = np.asarray(jaux["neural_opacity"])
    np.testing.assert_allclose(np_(taux["neural_opacity"]), op, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np_(taux["scale"]), np.asarray(jaux["scale"]), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(np_(taux["anchor_ok"]), np.asarray(jaux["anchor_ok"]))
    near_zero = (np.abs(op) < 1e-6).reshape(-1)
    differ = np_(tna) != np.asarray(jna)
    assert not (differ & ~near_zero).any()
    assert near_zero.sum() <= 2, near_zero.sum()  # ties of tanh at 0: rare, and bounded
    assert 0 < np.asarray(jna).sum() < jna.size


@pytest.mark.parametrize("heads", list(HEADS))
def test_render_scaffold_matches(scenes, heads):
    jsc, tsc = scenes
    arrays, alive = ts.init_scaffold_arrays(jsc.points, voxel_size=0.25, k_offsets=5, num_cameras=5,
                                            **HEADS[heads])
    arrays = warm(arrays, 3)
    bg = np.array([0.1, 0.3, 0.2], np.float32)
    want = jax.jit(lambda sp, cam, a: js.render_scaffold(sp, cam, J_RASTER, background=jnp.asarray(bg),
                                                            alive=a).image)(j_params(arrays), jsc.cameras[1],
                                                                            jnp.asarray(alive))
    with torch.no_grad():
        out = ts.render_scaffold(ts.scaffold_params_from_numpy(arrays, "cpu"), tsc.cameras[1], T_RASTER,
                                 background=torch.from_numpy(bg), alive=torch.from_numpy(alive))
    assert out.bin_valid > 0
    np.testing.assert_allclose(np_(out.image), np.asarray(want), atol=RENDER_ATOL)


def j_loss(sp, offset2d, camera, gt, alive, cfg):
    """dogs_tpu's scaffold loss_fn (fields/scaffold.py:654-692), whose
    closure the trainer does not expose, with the JAX package's functions."""
    visible = js.anchor_frustum_mask(sp, camera)
    gauss, colors, neural_alive, aux = js.generate_neural_gaussians(sp, camera, alive=alive, visible_mask=visible,
                                                                    with_aux=True)
    out = j_render_tiled(gauss, camera, J_RASTER, alive=neural_alive, active_sh_degree=0, color_override=colors,
                         means2d_offset=offset2d)
    img = jnp.clip(out.image, 0.0, 1.0)
    vol = jnp.prod(aux["scale"].reshape(-1, 3), axis=-1)
    n_alive = jnp.maximum(jnp.sum(neural_alive.astype(jnp.float32)), 1.0)
    loss_scaling = jnp.sum(jnp.where(neural_alive, vol, 0.0)) / n_alive
    return ((1.0 - cfg.lambda_dssim) * jnp.mean(jnp.abs(img - gt)) + cfg.lambda_dssim * (1.0 - j_ssim(img, gt))
            + cfg.lambda_scale * loss_scaling)


@pytest.fixture(scope="module")
def grad_states(scenes):
    """The initial arrays with the feat bank and the appearance embedding,
    and the port's state after 10 steps from them (no anchor events)."""
    jsc, tsc = scenes
    kw = dict(voxel_size=0.25, k_offsets=5, **HEADS["bank_app"])
    arrays, alive = ts.init_scaffold_arrays(jsc.points, num_cameras=5, **kw)
    cfg = ts.ScaffoldConfig(max_iterations=100, stat_start_iter=0, densify_start_iter=10**6, **kw)
    state = ts.init_scaffold_state(ts.scaffold_params_from_numpy(arrays, "cpu"), torch.from_numpy(alive))
    step = ts.make_scaffold_step(cfg, T_RASTER)
    for i in range(10):
        state, _ = step(state, tsc.cameras[i % 5], tsc.images[i % 5])
    return cfg, alive, {"init": arrays, "after_10_steps": t_arrays(state.params)}


@pytest.mark.parametrize("when", ["init", "after_10_steps"])
def test_gradients_through_the_mlps_match(scenes, grad_states, when):
    """One step's gradient of every ScaffoldParams leaf and of the means2d
    offset, max-normalized, at init (the untrained covariance head's raw
    quaternions) and after 10 steps; the camera reads its appearance row."""
    jsc, tsc = scenes
    cfg, alive, states = grad_states
    arrays = states[when]
    cam = 3
    n = alive.size * 5
    grad_fn = jax.jit(jax.grad(j_loss, argnums=(0, 1)), static_argnums=(5,))
    jg_sp, jg_off = grad_fn(j_params(arrays), jnp.zeros((n, 2), jnp.float32), jsc.cameras[cam],
                            jsc.images[cam], jnp.asarray(alive), cfg)
    want = dict(j_arrays(jg_sp), offset=np.asarray(jg_off))
    sp = ts.scaffold_params_from_numpy(arrays, "cpu")
    _, grads, g_off, _ = ts.scaffold_loss_and_grads(sp, tsc.cameras[cam], tsc.images[cam], torch.from_numpy(alive),
                                                    cfg, T_RASTER)
    got = dict(zip(sp.leaves(), map(np_, grads)), offset=np_(g_off))
    assert list(got) == list(want)
    for k, w in want.items():
        if w.size == 0:
            continue
        scale = np.abs(w).max()
        assert scale > 0, k
        np.testing.assert_allclose(got[k] / scale, w / scale, atol=GRAD_ATOL, err_msg=k)


def test_anchor_at_the_camera_centre_gets_a_finite_gradient(scenes):
    """A divergence by design: a camera at the origin (as bench.py's stand),
    where the padding anchors sit. dogs_tpu's max(|view|, 1e-12) gives those
    anchors' xyz a NaN gradient (0 * inf), which here reaches some MLP
    leaves in the same step, and its Adam step writes into the parameters;
    the port floors the squared norm under the square root, the same value
    with a zero gradient there: every gradient is finite, and each leaf
    that dogs_tpu keeps finite agrees at the usual bar."""
    from dogs_tpu.core.camera import look_at_camera as j_look_at_camera
    from dogs_tpu_torch.core.camera import look_at_camera

    jsc, tsc = scenes
    arrays, alive = ts.init_scaffold_arrays(jsc.points, voxel_size=0.25, k_offsets=5)
    view = dict(eye=[0.0, 0.0, 0.0], target=[0.0, 0.0, 1.0], up=[0.0, -1.0, 0.0], fx=50.0, fy=50.0, width=64,
                height=48)
    cam_j, cam_t = j_look_at_camera(**view), look_at_camera(**view, device="cpu")
    assert not np.asarray(cam_j.camera_center).any() and not np_(cam_t.camera_center).any()
    cfg = ts.ScaffoldConfig(voxel_size=0.25, k_offsets=5)
    n = alive.size * 5
    jg_sp, jg_off = jax.jit(jax.grad(j_loss, argnums=(0, 1)), static_argnums=(5,))(
        j_params(arrays), jnp.zeros((n, 2), jnp.float32), cam_j, jsc.images[1], jnp.asarray(alive), cfg)
    want = dict(j_arrays(jg_sp), offset=np.asarray(jg_off))
    sp = ts.scaffold_params_from_numpy(arrays, "cpu")
    _, grads, g_off, _ = ts.scaffold_loss_and_grads(sp, cam_t, tsc.images[1], torch.from_numpy(alive), cfg, T_RASTER)
    got = dict(zip(sp.leaves(), map(np_, grads)), offset=np_(g_off))
    at_centre = ~np.abs(arrays[".anchor_xyz"]).any(axis=1)
    assert np.array_equal(at_centre, ~alive)  # the padding slots
    assert np.isnan(want[".anchor_xyz"][at_centre]).all() and not np.isnan(want[".anchor_xyz"][alive]).any()
    assert all(np.isfinite(g).all() for g in got.values())
    assert not got[".anchor_xyz"][at_centre].any()
    want[".anchor_xyz"] = np.where(at_centre[:, None], 0.0, want[".anchor_xyz"])
    finite = [k for k, w in want.items() if w.size and np.isfinite(w).all()]
    assert {".anchor_xyz", ".anchor_feat", ".offsets", "offset"} <= set(finite), finite
    for k in finite:
        scale = np.abs(want[k]).max()
        assert scale > 0, k
        np.testing.assert_allclose(got[k] / scale, want[k] / scale, atol=GRAD_ATOL, err_msg=k)


def f32_neighbours(x: float, n: int) -> np.ndarray:
    """The 2n + 1 float32 values around float32(x), in order."""
    up, down = [np.float32(x)], [np.float32(x)]
    for _ in range(n):
        up.append(np.nextafter(up[-1], np.float32(np.inf)))
        down.append(np.nextafter(down[-1], np.float32(-np.inf)))
    return np.array(down[:0:-1] + up, np.float32)


def exact_in_both(values_t: torch.Tensor, values_j, target: np.float32) -> np.ndarray:
    return (np_(values_t) == target) & (np.asarray(values_j) == target)


def test_clamp_ties_of_the_decode_differ_from_jax_only_at_the_tie_entries(scenes):
    """A divergence by design, bounded: at an exact tie torch.clamp passes
    the whole gradient, where jnp.clip and jnp.maximum pass half. The
    opacity MLP's last-layer columns 1 and 3 are zero with biases whose tanh
    is exactly 1e-4 and 1 - 1e-4 (the opacity clip's bounds) for every
    anchor; the covariance MLP's scale column of offset 2, dim 1 is zero with
    a bias such that base scale x sigmoid x 2 is exactly 1e-8 (the scale
    floor) at three anchors. Under a fixed linear functional of every
    decoded field, each gradient leaf equals JAX's at the usual bar except
    at the entries these ties feed: the two opacity bias and weight columns
    carry twice JAX's gradient; the scale column's bias, its weights and the
    three anchors' log_scaling entries carry JAX's plus the half it drops,
    0.5 x the functional's weight on the tied log-scale (x (1 - sigmoid)
    through the bias)."""
    jsc, tsc = scenes
    arrays, alive = ts.init_scaffold_arrays(jsc.points, voxel_size=0.25, k_offsets=5)
    arrays = warm(arrays, 4)
    k = 5
    k_lo, k_hi, k_s, d_s = 1, 3, 2, 1
    col = k_s * 7 + d_s
    ties = np.flatnonzero(alive)[[0, 7, 20]]
    lo, hi, floor = np.float32(1e-4), np.float32(1.0 - 1e-4), np.float32(1e-8)

    # Biases whose tanh is exactly each opacity bound in both packages.
    cand = {t: f32_neighbours(np.arctanh(np.float64(t)), 64) for t in (lo, hi)}
    pick = {t: c[exact_in_both(torch.tanh(torch.from_numpy(c)), jnp.tanh(jnp.asarray(c)), t)] for t, c in cand.items()}
    assert all(len(p) for p in pick.values()), pick
    # A log base scale x and a bias b with exp(x) sigmoid(b) 2 == 1e-8 in both.
    xs = f32_neighbours(np.log(1e-8), 8)
    bs = np.linspace(-1e-4, 1e-4, 4001).astype(np.float32)
    prod_t = torch.exp(torch.from_numpy(xs))[:, None] * torch.sigmoid(torch.from_numpy(bs))[None, :] * 2.0
    prod_j = jnp.exp(jnp.asarray(xs))[:, None] * jax.nn.sigmoid(jnp.asarray(bs))[None, :] * 2.0
    i, j = np.argwhere(exact_in_both(prod_t, prod_j, floor))[0]
    x_s, b_s = xs[i], bs[j]

    w_op, b_op, w_cov, b_cov = ".mlp_opacity/['w1']", ".mlp_opacity/['b1']", ".mlp_cov/['w1']", ".mlp_cov/['b1']"
    arrays[w_op][:, [k_lo, k_hi]] = 0.0
    arrays[b_op][k_lo], arrays[b_op][k_hi] = pick[lo][0], pick[hi][0]
    arrays[w_cov][:, col] = 0.0
    arrays[b_cov][col] = b_s
    arrays[".log_scaling"][ties, 3 + d_s] = x_s

    cam_j, cam_t = jsc.cameras[2], tsc.cameras[2]
    n = alive.size * k
    rng = np.random.RandomState(9)
    weights = {f: rng.uniform(-1.0, 1.0, shape).astype(np.float32)
               for f, shape in (("xyz", (n, 3)), ("log_scale", (n, 3)), ("quat", (n, 4)), ("logit_opacity", (n, 1)),
                                ("colors", (n, 3)))}

    def j_functional(sp):
        g, colors, _, aux = js.generate_neural_gaussians(sp, cam_j, alive=jnp.asarray(alive), with_aux=True)
        fields = dict(xyz=g.xyz, log_scale=g.log_scale, quat=g.quat, logit_opacity=g.logit_opacity, colors=colors)
        return sum(jnp.sum(jnp.asarray(weights[f]) * v) for f, v in fields.items()), aux

    (_, jaux), jgrad = jax.value_and_grad(j_functional, has_aux=True)(j_params(arrays))
    want = j_arrays(jgrad)
    sp = ts.scaffold_params_from_numpy(arrays, "cpu")
    g, colors, _, taux = ts.generate_neural_gaussians(sp, cam_t, alive=torch.from_numpy(alive), with_aux=True)
    fields = dict(xyz=g.xyz, log_scale=g.log_scale, quat=g.quat, logit_opacity=g.logit_opacity, colors=colors)
    total = sum((torch.from_numpy(weights[f]) * v).sum() for f, v in fields.items())
    leaves = {key: v for key, v in sp.leaves().items() if v.numel()}
    got = dict(zip(leaves, map(np_, torch.autograd.grad(total, list(leaves.values())))))

    # The ties are where they were put, in both packages, and nowhere else.
    for aux in (taux, jaux):
        op, scale = np_(aux["neural_opacity"]), np_(aux["scale"])
        assert (op[:, k_lo] == lo).all() and (op[:, k_hi] == hi).all()
        assert ((op == lo) | (op == hi)).sum() == 2 * op.shape[0]
        assert sorted(zip(*np.nonzero(scale == floor))) == [(a, k_s, d_s) for a in ties]
    tied = {key: np.zeros(w.shape, bool) for key, w in want.items()}
    tied[w_op][:, [k_lo, k_hi]] = tied[b_op][[k_lo, k_hi]] = True
    tied[w_cov][:, col] = tied[b_cov][col] = True
    tied[".log_scaling"][ties, 3 + d_s] = True
    for key, w in want.items():
        assert key in got or not w.size, key
        if not w.size:
            continue
        scale = np.abs(w).max()
        assert scale > 0, key
        np.testing.assert_allclose(got[key][~tied[key]] / scale, w[~tied[key]] / scale, atol=GRAD_ATOL, err_msg=key)

    # What JAX drops at each tie, exactly: half the gradient there.
    assert np.abs(got[w_cov][:, col] - want[w_cov][:, col]).max() > GRAD_ATOL * np.abs(want[w_cov][:, col]).max()
    np.testing.assert_allclose(got[b_op][[k_lo, k_hi]], 2.0 * want[b_op][[k_lo, k_hi]], rtol=RTOL)
    np.testing.assert_allclose(got[w_op][:, [k_lo, k_hi]], 2.0 * want[w_op][:, [k_lo, k_hi]], rtol=RTOL, atol=ATOL)
    dropped = 0.5 * weights["log_scale"][ties * k + k_s, d_s]
    np.testing.assert_allclose(got[".log_scaling"][ties, 3 + d_s] - want[".log_scaling"][ties, 3 + d_s], dropped,
                               rtol=RTOL, atol=ATOL)
    sig = float(torch.sigmoid(torch.tensor(b_s)))
    np.testing.assert_allclose(got[b_cov][col] - want[b_cov][col], dropped.sum() * (1.0 - sig), rtol=RTOL, atol=ATOL)
