"""Gaussian model state: padded parameters, alive mask, densify statistics,
and the fixed-capacity model surgery (densify, clone/split, prune, opacity
reset).

Port of dogs_tpu/fields/model.py. The fixed-capacity layout with an `alive`
mask is kept, so a `dogs_tpu` checkpoint loads slot for slot and a densify
event is a fixed number of launches with no host sync: clone/split write
into free (dead) slots by a scatter, prune clears `alive` bits, and the
trainer grows capacity in power-of-two buckets when free slots run out.
The surgery writes the state's tensors in place (the parameters are
`nn.Parameter`s that the optimizer state is keyed beside).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dogs_tpu_torch.core.gaussians import PARAM_NAMES, GaussianParams, empty_params, inverse_sigmoid
from dogs_tpu_torch.core.knn import mean_knn_dist_sq
from dogs_tpu_torch.core.sh import rgb_to_sh
from dogs_tpu_torch.core.transforms import quat_to_rotmat
from dogs_tpu_torch.utils import trace

# Split children get log_scale - log(1.6) (scale / (0.8 * 2)). The constant is
# the float32 log of float32 1.6, as jnp.log(1.6) computes it; torch.log on
# the CPU rounds it one ulp lower.
LOG_1P6 = float(np.log(np.float32(1.6)))


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
    with trace.readback("densify_stats_scale"):
        scale = torch.tensor([0.5 * width, 0.5 * height], dtype=means2d_grad.dtype, device=means2d_grad.device)
    norm = torch.linalg.vector_norm(means2d_grad * scale, dim=-1)
    state.grad_accum.copy_(torch.where(visible, state.grad_accum + norm, state.grad_accum))
    state.denom.copy_(torch.where(visible, state.denom + 1.0, state.denom))
    state.max_radii2d.copy_(torch.where(visible, torch.maximum(state.max_radii2d, radii), state.max_radii2d))
    return state


def densify_masks(
    state: GaussianModelState,
    grad_threshold: float,
    percent_dense: float,
    scene_extent: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(clone, split) selection masks: alive Gaussians whose mean screen
    gradient reaches the threshold, cloned when small and split when large
    against percent_dense * extent."""
    grads = torch.where(state.denom > 0, state.grad_accum / state.denom, 0.0)
    max_scale = torch.amax(state.params.scale, dim=-1)
    hot = (grads >= grad_threshold) & state.alive
    small = max_scale <= percent_dense * scene_extent
    return hot & small, hot & ~small


def required_slots(
    state: GaussianModelState,
    grad_threshold: float,
    percent_dense: float,
    scene_extent: float,
) -> torch.Tensor:
    """Upper bound on the slots the next densify needs beyond the free ones
    (a 0-d device tensor; > 0 means grow capacity first)."""
    clone, split = densify_masks(state, grad_threshold, percent_dense, scene_extent)
    n_free = (~state.alive).sum(dtype=torch.int32)
    # A split adds two children and frees its parent's slot.
    return clone.sum(dtype=torch.int32) + split.sum(dtype=torch.int32) - n_free


@torch.no_grad()
def densify_and_prune(
    state: GaussianModelState,
    noise: torch.Tensor,
    grad_threshold: float,
    min_opacity: float,
    scene_extent: float,
    max_screen_size: float | None,
    percent_dense: float = 0.01,
    bbox_z_min: float | None = None,
) -> tuple[GaussianModelState, torch.Tensor, torch.Tensor]:
    """One densify + prune round under fixed capacity, IN PLACE.

    `noise` is the split draw, (2C, 3) standard normal (the caller draws it,
    so a test can feed JAX's draw). Returns (state, allocated, n_overflow):
    `allocated` (C,) marks the slots that received a new Gaussian (the
    trainer zeroes their Adam moments), `n_overflow` (0-d int32 on the
    device) counts the candidates dropped for want of a free slot. The
    candidates are C clone rows followed by 2C split rows; the k-th valid
    candidate goes to the k-th free slot in ascending order, the surplus is
    dropped. The prune
    selection folds into candidate validity before allocation (children
    inherit their parent's opacity and scale), and the densify statistics
    are zeroed. A fixed number of launches and no host sync."""
    c = state.capacity
    params = state.params
    clone, split = densify_masks(state, grad_threshold, percent_dense, scene_extent)

    prune = (params.opacity[:, 0] < min_opacity) & state.alive
    if max_screen_size is not None:
        big_vs = state.max_radii2d > max_screen_size
        big_ws = torch.amax(params.scale, dim=-1) > 0.1 * scene_extent
        prune |= (big_vs | big_ws) & state.alive
    if bbox_z_min is not None:
        prune |= (params.xyz[:, 2] < bbox_z_min) & state.alive
    clone &= ~prune
    split &= ~prune
    alive_after = state.alive & ~prune & ~split

    # Slot allocation, as a gather: the k-th free slot (ascending) takes the
    # k-th valid candidate when there is one. This is dogs_tpu's scatter of
    # the k-th valid candidate to the k-th free slot with the surplus
    # dropped, with no scatter: on the card a scatter's dropped rows would
    # all write to one row.
    cand_valid = torch.cat([clone, split, split])
    free = ~alive_after
    free_rank = torch.cumsum(free, 0, dtype=torch.int32) - 1
    n_valid = cand_valid.sum(dtype=torch.int32)
    allocated = free & (free_rank < n_valid)
    valid_cands = torch.argsort((~cand_valid).to(torch.uint8), stable=True)  # valid ones first, ascending
    cand = valid_cands[free_rank.clamp(min=0).long()]
    parent, is_split = cand % c, cand >= c

    # Split rows: two replicas at xyz + R(q) (noise * scale), the sum over j
    # in the order of JAX's einsum; clone rows are the parameters themselves.
    rot = quat_to_rotmat(params.quat)
    v = noise.view(2, c, 3) * params.scale
    offs = rot[None, :, :, 0] * v[..., 0:1] + rot[None, :, :, 1] * v[..., 1:2] + rot[None, :, :, 2] * v[..., 2:3]
    for k in PARAM_NAMES:
        p = getattr(params, k)
        rows = p[parent]
        if k == "xyz":
            rows = torch.where(is_split[:, None], rows + offs.view(2 * c, 3)[(cand - c).clamp(min=0)], rows)
        elif k == "log_scale":
            rows = torch.where(is_split[:, None], rows - LOG_1P6, rows)
        p.copy_(torch.where(allocated.view((-1,) + (1,) * (p.dim() - 1)), rows, p))
    state.alive.copy_(alive_after | allocated)
    overflow = torch.clamp(n_valid - free.sum(dtype=torch.int32), min=0)
    for s in (state.grad_accum, state.denom, state.max_radii2d):
        s.zero_()  # the reference zeroes the stats after densify
    return state, allocated, overflow


@torch.no_grad()
def prune_only(state: GaussianModelState, prune_mask: torch.Tensor) -> GaussianModelState:
    """Kill Gaussians by mask, in place (the LightGaussian percentile prune)."""
    state.alive &= ~prune_mask
    return state


@torch.no_grad()
def reset_opacity(state: GaussianModelState, ceiling: float = 0.01) -> GaussianModelState:
    """Clamp the opacities of alive Gaussians to at most `ceiling`, in place
    (the periodic opacity reset of 3DGS; the trainer zeroes the opacity
    moments)."""
    p = state.params.logit_opacity
    new_op = inverse_sigmoid(torch.clamp(torch.clamp(state.params.opacity, max=ceiling), 1e-6, 1.0 - 1e-6))
    p.copy_(torch.where(state.alive[:, None], new_op, p))
    return state
