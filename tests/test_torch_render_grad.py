"""The slice's backward as a whole: dogs_tpu_torch's render_tiled gradients
against jax.grad of dogs_tpu's render_tiled, through the stream kernels
(Pallas, interpret mode) and through the XLA path, on the same numpy scene.

Gradients are taken w.r.t. the six parameter leaves, `means2d_offset`,
`invd_offset`, `color_override` and the background, with the loss of
tests/test_pallas_blend.py:test_pallas_grads_match_xla. The port's plain
versions run here; the CUDA kernels are held against them on the card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dogs_tpu.core.camera import look_at_camera as j_look_at
from dogs_tpu.raster.projection import project_gaussians as j_project
from dogs_tpu.raster.tiled import RasterConfig as JRasterConfig
from dogs_tpu.raster.tiled import render_tiled as j_render
from dogs_tpu_torch.core import look_at_camera, params_from_numpy
from dogs_tpu_torch.core.gaussians import PARAM_NAMES
from dogs_tpu_torch.data import synthetic
from dogs_tpu_torch.raster import tiled
from dogs_tpu_torch.raster.projection import project_gaussians
from dogs_tpu_torch.raster.tiled import RasterConfig, render_tiled
from tests.test_torch_core import jax_params

ATOL = 2e-3  # max-normalized gradient bar of tests/test_pallas_blend.py:58-61
BF16_ATOL = 8e-3  # bf16-packed reduce against f32, tests/test_pallas_blend.py:87
BG = np.array([0.1, 0.2, 0.3], np.float32)
J_XLA = JRasterConfig(tile_size=16, max_tiles_per_gaussian=36, tile_batch=8, chunk=16)
J_STREAM = dataclasses.replace(J_XLA, use_pallas=True, pallas_stream=True, reduce_dtype="f32")

# case -> (scene, JAX config, port RasterConfig fields, extra inputs)
CASES = {
    "xla_f32": ("random_seed0", J_XLA, {}, ("means2d_offset", "invd_offset")),
    "stream_f32": ("random_seed0", J_STREAM, {}, ("means2d_offset", "invd_offset")),
    "stream_bf16": ("random_seed0", dataclasses.replace(J_STREAM, reduce_dtype="bf16"),
                    dict(reduce_dtype="bf16"), ("means2d_offset",)),
    "stream_saturation": ("saturation", J_STREAM, {}, ("means2d_offset",)),
    "xla_depth_threshold_color_override": (
        "random_seed3", dataclasses.replace(J_XLA, depth_threshold=4.5), dict(depth_threshold=4.5),
        ("means2d_offset", "color_override"),
    ),
}
SCENES = {
    "random_seed0": (lambda: synthetic.random_scene_arrays(seed=0), synthetic.RANDOM_SCENE_VIEW, 2),
    "random_seed3": (lambda: synthetic.random_scene_arrays(seed=3), synthetic.RANDOM_SCENE_VIEW, 2),
    "saturation": (synthetic.saturation_scene_arrays, synthetic.SATURATION_SCENE_VIEW, 1),
    "empty_tiles": (
        lambda: synthetic.random_scene_arrays(n=16, seed=2, spread=0.3), synthetic.RANDOM_SCENE_VIEW, 2
    ),
}


def extra_inputs(names, n):
    """Zero offsets (their gradients are the densify and importance signals)
    and a colour override drawn from numpy."""
    made = {
        "means2d_offset": np.zeros((n, 2), np.float32),
        "invd_offset": np.zeros((n,), np.float32),
        "color_override": np.random.RandomState(0).uniform(0.05, 1.0, (n, 3)).astype(np.float32),
    }
    return {k: made[k] for k in names}


def loss_terms(image, alpha, invdepth, target):
    return ((image - target) ** 2).sum() + 0.3 * (alpha**2).sum() + 0.1 * (invdepth**2).sum()


def grads_both(scene, jcfg, tkw, names, loss=loss_terms, background=BG):
    """(JAX grads, port grads, port render) with the grads as dicts of numpy
    arrays: the six leaves, the named extra inputs and "background"."""
    make, view, deg = SCENES[scene]
    arrays = make()
    extras = extra_inputs(names, arrays["xyz"].shape[0])
    target = np.random.RandomState(1).rand(view["height"], view["width"], 3).astype(np.float32)

    def jloss(p, ex, bg):
        out = j_render(p, j_look_at(**view), jcfg, background=bg, active_sh_degree=deg, **ex)
        return loss(out.image, out.alpha, out.invdepth, target)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(
        jax_params(arrays), {k: jnp.asarray(v) for k, v in extras.items()}, jnp.asarray(background)
    )
    want = {k: np.asarray(getattr(jg[0], k)) for k in PARAM_NAMES}
    want |= {k: np.asarray(v) for k, v in jg[1].items()}
    want["background"] = np.asarray(jg[2])
    got, out = port_grads(scene, tkw, names, loss, background)
    return want, got, out


def port_grads(scene, tkw, names, loss=loss_terms, background=BG):
    make, view, deg = SCENES[scene]
    arrays = make()
    extras = extra_inputs(names, arrays["xyz"].shape[0])
    target = np.random.RandomState(1).rand(view["height"], view["width"], 3).astype(np.float32)
    params = params_from_numpy(arrays, "cpu")
    ex = {k: torch.from_numpy(v).requires_grad_(True) for k, v in extras.items()}
    bg = torch.from_numpy(background).requires_grad_(True)
    cfg = RasterConfig(max_tiles_per_gaussian=36, **tkw)
    out = render_tiled(params, look_at_camera(**view, device="cpu"), cfg, background=bg, active_sh_degree=deg, **ex)
    leaves = [getattr(params, k) for k in PARAM_NAMES] + list(ex.values()) + [bg]
    # With color_override the SH leaves are unused: their gradient is zero.
    tg = torch.autograd.grad(loss(out.image, out.alpha, out.invdepth, torch.from_numpy(target)), leaves,
                             materialize_grads=True)
    return dict(zip(PARAM_NAMES + tuple(ex) + ("background",), (g.numpy() for g in tg))), out


def assert_grads_close(got, want, skip=(), atol=ATOL):
    for k, a in want.items():
        if k in skip:
            continue
        scale = np.abs(a).max() + 1e-6
        np.testing.assert_allclose(got[k] / scale, a / scale, atol=atol, err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_render_gradients_match_jax(case):
    scene, jcfg, tkw, names = CASES[case]
    want, got, _ = grads_both(scene, jcfg, tkw, names)
    assert set(got) == set(want)
    assert_grads_close(got, want)
    if "color_override" in names:  # the override replaces SH colour entirely
        assert not got["feat_dc"].any() and np.abs(got["color_override"]).max() > 0
    if tkw.get("reduce_dtype") == "bf16":
        # The port's default reduce is "f32", the JAX package's "bf16": the
        # divergence is bf16 rounding of the per-entry gradients, bounded by
        # the bf16-against-f32 bar of tests/test_pallas_blend.py:87.
        got_f32, _ = port_grads(scene, {}, names)
        assert_grads_close(got_f32, want, atol=BF16_ATOL)


def test_clamp_tie_gradient_differs_only_at_background():
    """Known divergence: at a tie, jnp.clip passes half the gradient and
    torch.clamp all of it. The train loss clips the image to [0, 1], and an
    empty pixel is exactly the background (0 here). So d_bg differs by half
    the clipped-loss gradient at the tie pixels, and the parameter gradients
    do not differ (a pixel with nothing blended has no parameter gradient)."""
    assert float(jax.grad(lambda x: jnp.clip(x, 0.0, 1.0))(0.0)) == 0.5
    x = torch.zeros((), requires_grad=True)
    assert float(torch.autograd.grad(torch.clamp(x, 0.0, 1.0), [x])[0]) == 1.0

    def l1_clip(image, alpha, invdepth, target):
        clipped = image.clip(0.0, 1.0) if isinstance(image, jnp.ndarray) else torch.clamp(image, 0.0, 1.0)
        return abs(clipped - target).mean()

    want, got, out = grads_both("empty_tiles", J_XLA, {}, (), loss=l1_clip,
                                background=np.zeros(3, np.float32))
    assert_grads_close(got, want, skip=("background",))
    img = out.image.detach().numpy()
    tie = (img == 0.0) | (img == 1.0)
    assert tie.sum() > 100  # many empty pixels
    view = synthetic.RANDOM_SCENE_VIEW
    target = np.random.RandomState(1).rand(view["height"], view["width"], 3).astype(np.float32)
    g_clipped = np.sign(np.clip(img, 0, 1) - target) / img.size
    one_minus_a = (1.0 - out.alpha.detach().numpy())[..., None]
    half_tie = 0.5 * (g_clipped * tie * one_minus_a).sum(axis=(0, 1))
    np.testing.assert_allclose(got["background"] - want["background"], half_tie, atol=1e-6)
    assert np.abs(half_tie).min() > 1e-3


def test_gradient_reaches_every_leaf_and_skips_binning_and_depth():
    make, view, deg = SCENES["random_seed0"]
    params = params_from_numpy(make(), "cpu")
    seen = {}
    real_bins = tiled.build_tile_bins

    def spy(proj, *a, **kw):
        seen["binning_input_requires_grad"] = any(
            getattr(proj, f.name).requires_grad for f in dataclasses.fields(proj)
        )
        return real_bins(proj, *a, **kw)

    tiled.build_tile_bins = spy
    try:
        out = render_tiled(params, look_at_camera(**view, device="cpu"),
                           RasterConfig(max_tiles_per_gaussian=36), active_sh_degree=deg)
    finally:
        tiled.build_tile_bins = real_bins
    assert seen == {"binning_input_requires_grad": False}
    assert out.image.requires_grad
    grads = torch.autograd.grad(out.image.sum() + out.invdepth.sum(),
                                [getattr(params, k) for k in PARAM_NAMES])
    for k, g in zip(PARAM_NAMES, grads):
        assert g.abs().max() > 0, k
    proj = project_gaussians(params, look_at_camera(**view, device="cpu"), active_sh_degree=deg)
    ent_n = tiled.entry_matrix(proj)
    assert ent_n.requires_grad
    (g_depth,) = torch.autograd.grad(ent_n[:, 10].sum(), [params.xyz])
    assert not g_depth.any()  # the depth column is cut from the graph


def test_tile_blend_saves_no_sorted_entry_matrix():
    """The blend reads the N-space matrix through sorted_idx: the graph
    keeps ent_n (N, 16) for the backward and no (K, 16) sorted copy."""
    make, view, deg = SCENES["random_seed0"]
    params = params_from_numpy(make(), "cpu")
    cam = look_at_camera(**view, device="cpu")
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = render_tiled(params, cam, RasterConfig(max_tiles_per_gaussian=36), active_sh_degree=deg)
    n, k = params.capacity, out.bin_valid
    assert k > n  # the scene has more entries than Gaussians
    assert (n, 16) in shapes
    assert (k, 16) not in shapes
    grads = torch.autograd.grad(out.image.sum(), [params.xyz])
    assert torch.isfinite(grads[0]).all()


@pytest.mark.parametrize("antialiasing", [False, True])
def test_projection_gradients_match_jax(antialiasing):
    arrays = synthetic.random_scene_arrays(seed=6)
    n = arrays["xyz"].shape[0]
    view = synthetic.RANDOM_SCENE_VIEW
    rng = np.random.RandomState(6)
    alive = rng.rand(n) > 0.2
    w = {f: rng.randn(*s).astype(np.float32) for f, s in
         dict(means2d=(n, 2), depth=(n,), conic=(n, 3), color=(n, 3), opacity=(n,)).items()}
    offset = np.zeros((n, 2), np.float32)

    def jloss(p, off):
        proj = j_project(p, j_look_at(**view), alive=jnp.asarray(alive), active_sh_degree=2,
                         antialiasing=antialiasing, means2d_offset=off)
        return sum(jnp.sum(getattr(proj, f) * w[f]) for f in w)

    jg = jax.grad(jloss, argnums=(0, 1))(jax_params(arrays), jnp.asarray(offset))
    params = params_from_numpy(arrays, "cpu")
    off = torch.from_numpy(offset).requires_grad_(True)
    proj = project_gaussians(params, look_at_camera(**view, device="cpu"), alive=torch.from_numpy(alive),
                             active_sh_degree=2, antialiasing=antialiasing, means2d_offset=off)
    loss = sum((getattr(proj, f) * torch.from_numpy(w[f])).sum() for f in w)
    tg = torch.autograd.grad(loss, [getattr(params, k) for k in PARAM_NAMES] + [off])
    want = {k: np.asarray(getattr(jg[0], k)) for k in PARAM_NAMES} | {"offset": np.asarray(jg[1])}
    got = dict(zip(PARAM_NAMES + ("offset",), (g.numpy() for g in tg)))
    for k, a in want.items():
        scale = np.abs(a).max() + 1e-6
        np.testing.assert_allclose(got[k] / scale, a / scale, atol=1e-5, err_msg=k)
