"""Plain 3DGS training steps and the densify rule: the reference that the
training cells are compared with.

One step renders a view (raster.py), takes the loss (1 - l) L1 + l D-SSIM
plus lambda_scale times the mean volume prod(scale) of the alive Gaussians,
its gradient by autograd, and the sparse Adam of the 3DGS reference
(SparseGaussianAdam: b1 0.9, b2 0.999, eps 1e-15, no bias correction; a
Gaussian not drawn in the view keeps its parameters and moments). The
learning rates are 3DGS's, the position's log-linear from init to final
over `position_lr_max_steps`, times the scene extent.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import raster
from benchmark.reference.loss import photometric

LEAVES = ("xyz", "feat_dc", "feat_rest", "log_scale", "quat", "logit_opacity")


def learning_rates(cfg: dict, step: int, extent: float) -> dict:
    t = min(max(step / cfg["position_lr_max_steps"], 0.0), 1.0)
    lo, hi = math.log(cfg["position_lr_final"] * extent), math.log(cfg["position_lr_init"] * extent)
    return dict(xyz=math.exp((1 - t) * hi + t * lo), feat_dc=cfg["feature_lr"], feat_rest=cfg["feature_lr"] / 20.0,
                log_scale=cfg["scaling_lr"], quat=cfg["quaternion_lr"], logit_opacity=cfg["opacity_lr"])


def loss_and_grads(p: dict, alive: torch.Tensor, view: raster.View, gt: torch.Tensor, cfg: dict,
                   sh_degree: int) -> tuple:
    """(loss, {leaf: gradient}, drawn (N,) bool, the mean's gradient (N, 2)
    in pixels) of one view."""
    leaves = {k: p[k].detach().requires_grad_(True) for k in LEAVES}
    offset = torch.zeros((p["xyz"].shape[0], 2), dtype=p["xyz"].dtype, device=p["xyz"].device,
                         requires_grad=True)
    g = dict(xyz=leaves["xyz"], log_scale=leaves["log_scale"], quat=leaves["quat"],
             logit_opacity=leaves["logit_opacity"], feat=torch.cat([leaves["feat_dc"], leaves["feat_rest"]], 1))
    proj = raster.project(g, view, sh_degree, alive=alive, offset2d=offset)
    rows = raster.entry_rows(proj, cfg.get("depth_threshold", 0.0))
    lists = raster.tile_lists(proj, view.width, view.height, cfg["max_tiles_per_gaussian"])
    color, alpha, _, _ = raster.blend(rows.detach(), *lists, view.width, view.height)
    color.requires_grad_(True)
    alpha.requires_grad_(True)
    photo = photometric(torch.clamp(color, 0.0, 1.0), gt.to(color.dtype), cfg["lambda_dssim"])
    d_color, d_alpha = torch.autograd.grad(photo, [color, alpha], allow_unused=True, materialize_grads=True)
    d_rows = raster.blend_vjp(rows.detach(), *lists, view.width, view.height, d_color, d_alpha)
    n_alive = torch.clamp(alive.sum().to(rows.dtype), min=1.0)
    vol = torch.exp(leaves["log_scale"]).prod(-1)
    reg = torch.where(alive, vol, torch.zeros_like(vol)).sum() / n_alive
    grads = torch.autograd.grad([rows, cfg["lambda_scale"] * reg], list(leaves.values()) + [offset],
                                grad_outputs=[d_rows, torch.ones_like(reg)], allow_unused=True,
                                materialize_grads=True)
    loss = float(photo.detach()) + cfg["lambda_scale"] * float(reg.detach())
    return loss, dict(zip(LEAVES, grads[:-1])), proj["radius"] > 0, grads[-1]


@torch.no_grad()
def sparse_adam(p: dict, grads: dict, mu: dict, nu: dict, drawn: torch.Tensor, lr: dict) -> None:
    for k in LEAVES:
        m = 0.9 * mu[k] + 0.1 * grads[k]
        v = 0.999 * nu[k] + 0.001 * grads[k] * grads[k]
        mask = drawn.view((-1,) + (1,) * (m.dim() - 1))
        p[k] = torch.where(mask, p[k] - lr[k] * m / (torch.sqrt(v) + 1e-15), p[k])
        mu[k] = torch.where(mask, m, mu[k])
        nu[k] = torch.where(mask, v, nu[k])


def follow(p0: dict, alive: torch.Tensor, views: list, gts: list, cfg: dict, sh_degree: int, extent: float,
           start_step: int = 0) -> dict:
    """Train from `p0` (never modified) one step per (view, gt), at global
    steps start_step, start_step + 1, ... Returns the losses, the first
    step's gradient as the optimizer takes it (drawn rows only) and the
    parameters after the last step."""
    p = {k: p0[k].clone() for k in LEAVES}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first = [], None
    for i, (view, gt) in enumerate(zip(views, gts)):
        loss, grads, drawn, _ = loss_and_grads(p, alive, view, gt, cfg, sh_degree)
        losses.append(loss)
        if first is None:
            first = {k: torch.where(drawn.view((-1,) + (1,) * (g.dim() - 1)), g, torch.zeros_like(g))
                     for k, g in grads.items()}
        sparse_adam(p, grads, mu, nu, drawn, learning_rates(cfg, start_step + i, extent))
        del grads
    return dict(losses=losses, first_grad=first, params=p)


@torch.no_grad()
def densify(state: dict, noise: torch.Tensor, cfg: dict, extent: float, max_screen_size: float | None) -> dict:
    """The 3DGS densify-and-prune event on a fixed-capacity model (dogs_tpu's
    slot rule). `state` holds the leaves, alive (C,), grad_accum, denom,
    max_radii2d; `noise` (2C, 3) is the split draw. Gaussians whose mean
    screen gradient reaches the threshold are cloned when their largest
    scale is at most percent_dense * extent, else split into two children at
    xyz + R (noise * scale) with scale / 1.6; Gaussians under min_opacity
    (and, with max_screen_size, too large) are pruned first. The k-th valid
    candidate (clones, then first children, then second children, each by
    slot) takes the k-th free slot. Returns the new leaves and alive."""
    c = state["alive"].shape[0]
    alive = state["alive"]
    grads = torch.where(state["denom"] > 0, state["grad_accum"] / state["denom"], torch.zeros_like(state["denom"]))
    scale = torch.exp(state["log_scale"])
    hot = (grads >= cfg["densify_grad_threshold"]) & alive
    small = scale.amax(-1) <= cfg["percent_dense"] * extent
    prune = (torch.sigmoid(state["logit_opacity"][:, 0]) < cfg["min_opacity"]) & alive
    if max_screen_size is not None:
        prune |= ((state["max_radii2d"] > max_screen_size) | (scale.amax(-1) > 0.1 * extent)) & alive
    clone, split = hot & small & ~prune, hot & ~small & ~prune
    kept = alive & ~prune & ~split
    cand = torch.cat([clone, split, split]).nonzero()[:, 0]
    free = (~kept).nonzero()[:, 0]
    n = min(cand.shape[0], free.shape[0])
    src, dst = cand[:n], free[:n]
    parent, is_split = src % c, src >= c
    out = {k: state[k].clone() for k in LEAVES}
    for k in LEAVES:
        out[k][dst] = state[k][parent]
    R = raster.rotation(state["quat"][parent])
    off = (R * (noise[(src - c).clamp(min=0)] * scale[parent])[:, None, :]).sum(-1)
    out["xyz"][dst] = torch.where(is_split[:, None], state["xyz"][parent] + off, state["xyz"][parent])
    out["log_scale"][dst] = torch.where(is_split[:, None], state["log_scale"][parent] - math.log(1.6),
                                        state["log_scale"][parent])
    new_alive = kept.clone()
    new_alive[dst] = True
    out["alive"] = new_alive
    out["dropped"] = cand.shape[0] - n
    return out
