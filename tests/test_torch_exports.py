"""The port's import surface against dogs_tpu's: every name that
dogs_tpu/raster/__init__.py and dogs_tpu/core/__init__.py export imports
from the port's packages, and the four names the port lacked
(`bins_membership`, `dssim_loss`, `init_appearance_params`, `constant_lr`)
against their dogs_tpu counterparts on the same numpy inputs."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dogs_tpu.core
import dogs_tpu.raster
import dogs_tpu_torch.core
import dogs_tpu_torch.raster
from dogs_tpu.core.camera import look_at_camera as j_look_at
from dogs_tpu.fields.appearance import init_appearance_params as j_init_appearance_params
from dogs_tpu.raster.binning import bins_membership as j_bins_membership
from dogs_tpu.raster.binning import build_tile_bins as j_build_tile_bins
from dogs_tpu.raster.projection import project_gaussians as j_project_gaussians
from dogs_tpu.raster.ssim import dssim_loss as j_dssim_loss
from dogs_tpu.train.optim import constant_lr as j_constant_lr
from dogs_tpu_torch.core import look_at_camera, params_from_numpy
from dogs_tpu_torch.data import synthetic
from dogs_tpu_torch.fields.appearance import flatten, init_appearance_params
from dogs_tpu_torch.raster import (
    RasterConfig,
    bins_membership,
    build_tile_bins,
    dssim_loss,
    project_gaussians,
    render_reference,
    render_tiled,
)
from dogs_tpu_torch.train.optim import constant_lr
from tests.test_torch_core import jax_params

FWD_ATOL = 3e-4  # forward parity bar of tests/test_pallas_blend.py:32
MAX_TILES = 36  # every Gaussian of random_scene keeps its whole tile rect


def np_(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("ref, port", [(dogs_tpu.raster, dogs_tpu_torch.raster), (dogs_tpu.core, dogs_tpu_torch.core)],
                         ids=["raster", "core"])
def test_every_exported_name_imports_from_the_port(ref, port):
    names = sorted(n for n, v in vars(ref).items() if not n.startswith("_") and not inspect.ismodule(v))
    assert len(names) >= 12, names
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, missing
    assert all(getattr(port, n).__module__.startswith("dogs_tpu_torch.") for n in names)


@pytest.mark.parametrize("seed", [0, 3])
def test_bins_membership_matches_and_the_dense_oracle_equals_the_tiled_render_under_it(seed):
    """The (tile, Gaussian) membership of the port's binning equals
    dogs_tpu's on random_scene; with it as each Gaussian's support the dense
    oracle equals render_tiled at the forward bar."""
    arrays = synthetic.random_scene_arrays(seed=seed)
    view = synthetic.RANDOM_SCENE_VIEW
    h, w = view["height"], view["width"]
    jp = j_project_gaussians(jax_params(arrays), j_look_at(**view), active_sh_degree=2)
    want = np.asarray(j_bins_membership(j_build_tile_bins(jp, h, w, max_tiles_per_gaussian=MAX_TILES), 64))
    params = params_from_numpy(arrays, "cpu")
    cam = look_at_camera(**view, device="cpu")
    with torch.no_grad():
        bins = build_tile_bins(project_gaussians(params, cam, active_sh_degree=2), h, w,
                               max_tiles_per_gaussian=MAX_TILES)
        member = bins_membership(bins, params.capacity)
        bg = torch.tensor([0.15, 0.25, 0.35])
        tiled = render_tiled(params, cam, RasterConfig(max_tiles_per_gaussian=MAX_TILES), background=bg,
                             active_sh_degree=2)
        ref = render_reference(params, cam, background=bg, active_sh_degree=2, tile_membership=member)
    assert member.dtype == torch.bool and member.shape == want.shape == (-(-h // 16) * -(-w // 16), 64)
    assert 0 < int(member.sum()) == bins.num_valid
    np.testing.assert_array_equal(np_(member), want)
    for f in ("image", "alpha", "invdepth"):
        np.testing.assert_allclose(np_(getattr(ref, f)), np_(getattr(tiled, f)), atol=FWD_ATOL, err_msg=f)


@pytest.mark.parametrize("seed", [0, 1])
def test_dssim_loss_matches(seed):
    rng = np.random.RandomState(seed)
    a = rng.rand(40, 56, 3).astype(np.float32)
    b = np.clip(a + rng.randn(40, 56, 3).astype(np.float32) * 0.1, 0, 1).astype(np.float32)
    got = dssim_loss(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(float(got), float(j_dssim_loss(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5)
    assert float(dssim_loss(torch.from_numpy(a), torch.from_numpy(a))) == pytest.approx(0.0, abs=1e-6)


@pytest.mark.parametrize("rng_seed", [None, 5])
def test_init_appearance_params_match(rng_seed):
    """The same draws in dogs_tpu's order, bit for bit, as leaves that
    require grad on the asked device."""
    rng = lambda: None if rng_seed is None else np.random.RandomState(rng_seed)  # noqa: E731
    got = flatten(init_appearance_params(7, rng(), device="cpu"))
    want = flatten_jax(j_init_appearance_params(7, rng()))
    assert list(got) == list(want)
    for k, v in got.items():
        assert v.requires_grad and v.device.type == "cpu" and v.dtype == torch.float32, k
        np.testing.assert_array_equal(np_(v), want[k], err_msg=k)


def flatten_jax(tree: dict) -> dict:
    """The leaves keyed by their jax.tree_util path, as `flatten` keys them."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(p) for p in path): np.asarray(leaf) for path, leaf in flat}


def test_constant_lr_matches():
    got, want = constant_lr(2.5e-3), j_constant_lr(2.5e-3)
    for step in (0, 1, 1000, 30000):
        assert isinstance(got(step), float)
        # dogs_tpu returns the value as a float32 scalar, the port as a float.
        assert got(step) == 2.5e-3 and float(want(step)) == float(np.float32(2.5e-3))
