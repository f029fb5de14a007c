"""Gaussian model state: padded parameters, alive mask, densify statistics.

Port of dogs_tpu/fields/model.py: the state container, initialisation from a
point cloud and the densify statistics. The fixed-capacity layout with an
`alive` mask is kept, so a `dogs_tpu` checkpoint loads slot for slot.
Densify, clone/split and prune come with the host-loop slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dogs_tpu_torch.core.gaussians import GaussianParams, empty_params, inverse_sigmoid
from dogs_tpu_torch.core.knn import mean_knn_dist_sq
from dogs_tpu_torch.core.sh import rgb_to_sh


@dataclasses.dataclass
class GaussianModelState:
    """Padded model + alive mask + densification bookkeeping."""

    params: GaussianParams
    alive: torch.Tensor  # (C,) bool
    grad_accum: torch.Tensor  # (C,) sum of screen-space grad norms
    denom: torch.Tensor  # (C,) number of accumulation events
    max_radii2d: torch.Tensor  # (C,) running max screen radius

    @property
    def capacity(self) -> int:
        return self.params.capacity

    @property
    def num_alive(self) -> torch.Tensor:
        return self.alive.sum(dtype=torch.int32)


def fresh_stats(capacity: int, device: torch.device | str = "cuda"):
    """Zeroed (grad_accum, denom, max_radii2d)."""
    return tuple(torch.zeros((capacity,), dtype=torch.float32, device=device) for _ in range(3))


def init_from_points(
    points: np.ndarray | torch.Tensor,
    colors: np.ndarray | torch.Tensor,
    capacity: int,
    max_sh_degree: int = 3,
    device: torch.device | str = "cuda",
) -> GaussianModelState:
    """Initialise from a point cloud, as dogs_tpu's init_from_points (the
    reference init_from_colmap_pcd): DC SH from RGB, isotropic log-scale from
    sqrt(mean 3-NN squared distance), identity quats, opacity 0.1. Slots past
    the points keep the inert defaults and are not alive."""
    points = torch.as_tensor(np.asarray(points, np.float32), device=device)
    colors = torch.as_tensor(np.asarray(colors, np.float32), device=device)
    n = points.shape[0]
    if n > capacity:
        raise ValueError(f"{n} points do not fit capacity {capacity}")
    params = empty_params(capacity, max_sh_degree, device)
    alive = torch.arange(capacity, device=device) < n
    pad = capacity - n
    xyz = torch.nn.functional.pad(points, (0, 0, 0, pad))
    rgb = torch.nn.functional.pad(colors, (0, 0, 0, pad))
    dist2 = torch.clamp(mean_knn_dist_sq(xyz, valid=alive), min=1e-7)
    log_scale = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)
    opacity0 = inverse_sigmoid(torch.full((capacity, 1), 0.1, device=device))
    with torch.no_grad():
        params.xyz.copy_(xyz)
        params.feat_dc.copy_(rgb_to_sh(rgb)[:, None, :])
        params.log_scale.copy_(torch.where(alive[:, None], log_scale, -10.0))
        params.logit_opacity.copy_(torch.where(alive[:, None], opacity0, -10.0))
    ga, de, mr = fresh_stats(capacity, device)
    return GaussianModelState(params=params, alive=alive, grad_accum=ga, denom=de, max_radii2d=mr)


@torch.no_grad()
def update_densify_stats(
    state: GaussianModelState,
    means2d_grad: torch.Tensor,
    radii: torch.Tensor,
    width: int,
    height: int,
) -> GaussianModelState:
    """Accumulate screen-space gradient stats of the visible Gaussians, in
    place (the reference add_densification_stats).

    `means2d_grad` is in pixels (the gradient of the loss w.r.t. a zero
    `means2d_offset`); the reference thresholds are calibrated for NDC-scale
    gradients, so it is scaled by (0.5 W, 0.5 H) first, as dogs_tpu does."""
    visible = radii > 0.0
    scale = torch.tensor([0.5 * width, 0.5 * height], dtype=means2d_grad.dtype, device=means2d_grad.device)
    norm = torch.linalg.vector_norm(means2d_grad * scale, dim=-1)
    state.grad_accum.copy_(torch.where(visible, state.grad_accum + norm, state.grad_accum))
    state.denom.copy_(torch.where(visible, state.denom + 1.0, state.denom))
    state.max_radii2d.copy_(torch.where(visible, torch.maximum(state.max_radii2d, radii), state.max_radii2d))
    return state
