"""CUDA lane: the hand-written blend kernel against its plain PyTorch
version on the card. Every test here needs a CUDA device and skips without
one. The file imports no JAX, so it runs on a machine with the card alone:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(`--noconftest` skips tests/conftest.py, which sets up JAX for the CPU suite.)
"""

import pytest
import torch

from dogs_tpu_torch.core import look_at_camera, params_from_numpy
from dogs_tpu_torch.data import synthetic
from dogs_tpu_torch.raster import blend
from dogs_tpu_torch.raster.binning import build_tile_bins
from dogs_tpu_torch.raster.projection import project_gaussians
from dogs_tpu_torch.raster.tiled import RasterConfig, render_tiled, sorted_entries

pytestmark = pytest.mark.cuda
ATOL = 3e-4  # forward parity bar of tests/test_pallas_blend.py
MT = 36

SCENES = {
    "random_seed0": (lambda: synthetic.random_scene_arrays(seed=0), synthetic.RANDOM_SCENE_VIEW, 2),
    "saturation": (synthetic.saturation_scene_arrays, synthetic.SATURATION_SCENE_VIEW, 1),
    "empty_tiles": (
        lambda: synthetic.random_scene_arrays(n=16, seed=2, spread=0.3),
        synthetic.RANDOM_SCENE_VIEW, 2,
    ),
    "non_aligned_200x130": (
        lambda: synthetic.random_scene_arrays(n=400, seed=5),
        dict(synthetic.RANDOM_SCENE_VIEW, width=200, height=130, fx=120.0, fy=120.0), 2,
    ),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the blend kernel has no CPU build")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("scene", list(SCENES))
def test_blend_kernel_matches_reference_on_card(scene, cuda):
    make, view, deg = SCENES[scene]
    h, w = view["height"], view["width"]
    params = params_from_numpy(make(), cuda)
    with torch.no_grad():
        proj = project_gaussians(params, look_at_camera(**view, device=cuda), active_sh_degree=deg)
        bins = build_tile_bins(proj, h, w, max_tiles_per_gaussian=MT)
        args = (sorted_entries(proj, bins), bins.tile_starts, -(-h // 16), -(-w // 16), w, h)
        before = blend.blend_forward.launches
        got = blend.blend_forward(*args)
        want = blend.blend_forward_reference(*args)
    torch.cuda.synchronize()
    assert blend.blend_forward.launches == before + 1
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_render_uses_kernel_on_card(cuda):
    make, view, deg = SCENES["random_seed0"]
    params = params_from_numpy(make(), cuda)
    cam = look_at_camera(**view, device=cuda)
    bg = torch.tensor([0.15, 0.25, 0.35], device=cuda)
    before = blend.blend_forward.launches
    got = render_tiled(params, cam, RasterConfig(max_tiles_per_gaussian=MT), background=bg,
                       active_sh_degree=deg)
    assert blend.blend_forward.launches == before + 1
    want = render_tiled(params, cam, RasterConfig(max_tiles_per_gaussian=MT, use_kernel=False),
                        background=bg, active_sh_degree=deg)
    assert blend.blend_forward.launches == before + 1
    for f in ("image", "alpha", "invdepth"):
        torch.testing.assert_close(getattr(got, f), getattr(want, f), atol=ATOL, rtol=0)
