"""LightGaussian importance pruning.

Port of dogs_tpu/fields/lightgaussian.py (the reference's
conerf/model/gaussian_fields/prune.py:13-65): accumulate each Gaussian's
total blend weight over all training cameras, score it by importance x
normalized volume^v_pow, and drop the lowest percentile of the alive ones.

A Gaussian's summed blend weight over an image equals d(sum(invdepth)) /
d(invd_i), so the importance is one extra cotangent through the existing
rasterizer: `render_tiled`'s `invd_offset` hook, differentiated by
autograd. On the card that is the blend forward kernel, then the blend
backward and segment-sum kernels; there is no separate count kernel.
Everything stays on the device: the 90th percentile is a sort with the
linear interpolation written out (`torch.quantile` refuses more than 2^24
elements, which a city-scale capacity exceeds), and the prune threshold a
sorted gather, so no host sync is made.
"""

from __future__ import annotations

from typing import Sequence

import torch

from dogs_tpu_torch.core.camera import Camera
from dogs_tpu_torch.core.gaussians import PARAM_NAMES, GaussianParams
from dogs_tpu_torch.fields.model import GaussianModelState, prune_only
from dogs_tpu_torch.raster.tiled import RasterConfig, render_tiled


def importance_render(
    model: GaussianModelState,
    camera: Camera,
    raster_cfg: RasterConfig = RasterConfig(),
    active_sh_degree: int = 3,
) -> torch.Tensor:
    """(C,) summed blend weights of every Gaussian for one view. Renders
    from detached copies of the parameters (the same storage, no grad), so
    nothing lands in the model's `.grad`s and no graph is kept for them."""
    params = GaussianParams(**{k: getattr(model.params, k).detach() for k in PARAM_NAMES})
    params.requires_grad_(False)
    offset = torch.zeros((model.capacity,), dtype=torch.float32, device=params.xyz.device, requires_grad=True)
    out = render_tiled(params, camera, raster_cfg, alive=model.alive, active_sh_degree=active_sh_degree,
                       invd_offset=offset)
    (imp,) = torch.autograd.grad(out.invdepth.sum(), offset)
    return imp


def prune_list(
    model: GaussianModelState,
    cameras: Sequence[Camera],
    raster_cfg: RasterConfig = RasterConfig(),
    active_sh_degree: int = 3,
) -> torch.Tensor:
    """(C,) importance accumulated over `cameras`, in their order (prune.py:13-33)."""
    imp = torch.zeros((model.capacity,), dtype=torch.float32, device=model.alive.device)
    for cam in cameras:
        imp = imp + importance_render(model, cam, raster_cfg, active_sh_degree)
    return imp


def _nanpercentile_alive(values: torch.Tensor, alive: torch.Tensor, percent: float) -> torch.Tensor:
    """0-d percentile of `values[alive]` with linear interpolation, in f32
    as `jnp.nanpercentile` computes it over the values with the dead ones
    set to NaN."""
    sorted_vals = torch.sort(torch.where(alive, values, torch.nan)).values  # NaN sorts last
    count = alive.sum(dtype=torch.float32)
    q = torch.tensor(percent / 100.0, dtype=torch.float32, device=values.device) * (count - 1.0)
    low, high = torch.floor(q), torch.ceil(q)
    high_weight = q - low
    low_weight = 1.0 - high_weight
    low = torch.clamp(torch.minimum(low, count - 1.0), min=0.0).long().view(1)
    high = torch.clamp(torch.minimum(high, count - 1.0), min=0.0).long().view(1)
    return (sorted_vals.index_select(0, low) * low_weight + sorted_vals.index_select(0, high) * high_weight)[0]


@torch.no_grad()
def calculate_v_imp_score(model: GaussianModelState, importance: torch.Tensor, v_pow: float) -> torch.Tensor:
    """importance x (volume / 90th-percentile alive volume)^v_pow (prune.py:34-50)."""
    volume = torch.prod(model.params.scale, dim=-1)
    v90 = _nanpercentile_alive(volume, model.alive, 90.0)
    return importance * (volume / torch.clamp(v90, min=1e-12)) ** v_pow


@torch.no_grad()
def prune_gaussians(model: GaussianModelState, percent: float, scores: torch.Tensor) -> GaussianModelState:
    """Kill the lowest `percent` of the alive Gaussians by score, in place
    (gaussian_splat_model.py:410-432): k = int(percent x (n_alive - 1)) in
    f32, and every alive Gaussian scoring at most the k-th smallest alive
    score is pruned."""
    n_alive = model.alive.sum(dtype=torch.int32)
    k = (torch.tensor(percent, dtype=torch.float32, device=scores.device) * (n_alive.float() - 1.0)).to(torch.int32)
    masked = torch.where(model.alive, scores, torch.inf)
    threshold = torch.sort(masked).values.index_select(0, torch.clamp(k, min=0).long().view(1))
    return prune_only(model, model.alive & (scores <= threshold))
