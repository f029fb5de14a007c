"""Plain block-parallel ADMM as DOGS (arXiv 2405.13943, section 3.3) trains
it: each block's train step with the scaled-dual penalty, the dense
consensus round and the residual balancing of rho, in one process.

- Penalty: sum_p 0.5 rho_p sum_alive (x_p + u_p - z_p)^2 / max(n_alive
  * width_p, 1), u and z constants; its gradient by autograd.
- A block's step (`follow`): the 3DGS step of gs3d.py with the VastGaussian
  mask (appearance.py) in the loss, L1 on render x mask and SSIM on the
  render, plus the penalty; the Gaussians' sparse Adam as gs3d.py's, the
  mask's bias-corrected Adam at its own learning rate. It starts from fresh
  moments and a fresh mask, or from a block's warm state (`Warm`).
- Round (`consensus_round`): z[g] = sum over blocks of the alive slots
  that hold global row g, over their count (0 where none is alive), the
  sums in float64 (or, for a control, in a lower precision); each
  block's z_local = z at its slots' rows; u += (1 + alpha)(x - z) on alive
  slots; primal_p = sum over blocks of mean_alive((z - x)^2); dual_p = mean
  over blocks of rho_p mean_alive((z_new - z_old)^2) (DOGS' master,
  master_gaussian_trainer.py:399-456).
- `adapt_rho`: rho x tau_inc where primal > mu dual, rho / tau_dec where
  dual > mu primal (Boyd et al. 2011, section 3.4.1), in float32.

Departures from the paper's description, each as DOGS' code has it: the
penalty is a mean over alive elements rather than a sum; z averages the raw
parameters (log scales, unnormalized quaternions, opacity logits); the
dual update is over-relaxed by alpha; the primal residual sums over blocks
and the dual averages over them. Plain float32 with TF32 off.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference import appearance, gs3d, raster
from benchmark.reference.loss import ssim

LEAVES = gs3d.LEAVES


ALPHAS = ("alpha_xyz", "alpha_fdc", "alpha_fr", "alpha_s", "alpha_q", "alpha_o")  # LEAVES order


def initial_rho(cfg: dict, n_global: int) -> dict:
    """rho_p = alpha_p / the number of global Gaussians, in float32."""
    return {k: np.float32(cfg[a] / max(n_global, 1)) for k, a in zip(LEAVES, ALPHAS)}


def camera_orders(seed: int, n_cams: list, steps: int) -> list:
    """out[s][k]: block k's camera at master step s of a trainer that has
    drawn nothing yet from its RandomState(seed): the blocks draw in block
    order each step; a block whose list is empty draws a permutation of its
    cameras and takes them from its end (DOGS' slaves, each over its own
    cameras, with one seeded generator)."""
    rng = np.random.RandomState(seed)
    lists = [[] for _ in n_cams]
    out = []
    for _ in range(steps):
        row = []
        for k, n in enumerate(n_cams):
            if not lists[k]:
                lists[k] = [int(i) for i in rng.permutation(n)]
            row.append(lists[k].pop())
        out.append(row)
    return out


def penalty(p: dict, u: dict, z: dict, alive: torch.Tensor, rho: dict) -> torch.Tensor:
    n_alive = torch.clamp(alive.sum().to(torch.float32), min=1.0)
    total = 0.0
    for k in LEAVES:
        x = p[k]
        width = int(np.prod(x.shape[1:]))
        sq = torch.where(alive.view((-1,) + (1,) * (x.dim() - 1)), (x + u[k] - z[k]) ** 2, 0.0)
        total = total + 0.5 * rho[k] * sq.sum() / torch.clamp(n_alive * width, min=1.0)
    return total


def loss_and_grads(p: dict, alive: torch.Tensor, view: raster.View, gt: torch.Tensor, cfg: dict, sh_degree: int,
                   mask_params: dict, image_index: int, u: dict, z: dict, rho: dict) -> tuple:
    """(loss, {leaf: gradient}, drawn (N,) bool, {mask leaf: gradient},
    penalty) of one view; the loss includes the penalty."""
    leaves = {k: p[k].detach().requires_grad_(True) for k in LEAVES}
    offset = torch.zeros((p["xyz"].shape[0], 2), dtype=p["xyz"].dtype, device=p["xyz"].device, requires_grad=True)
    g = dict(xyz=leaves["xyz"], log_scale=leaves["log_scale"], quat=leaves["quat"],
             logit_opacity=leaves["logit_opacity"], feat=torch.cat([leaves["feat_dc"], leaves["feat_rest"]], 1))
    proj = raster.project(g, view, sh_degree, alive=alive, offset2d=offset)
    rows = raster.entry_rows(proj, cfg.get("depth_threshold", 0.0))
    lists = raster.tile_lists(proj, view.width, view.height, cfg["max_tiles_per_gaussian"])
    color, alpha, _, _ = raster.blend(rows.detach(), *lists, view.width, view.height)
    color.requires_grad_(True)
    alpha.requires_grad_(True)
    img = torch.clamp(color, 0.0, 1.0)
    gt = gt.to(img.dtype)
    mask_leaves = appearance.leaves(mask_params)
    with appearance.exact_f32():
        m = appearance.mask(mask_params, img, image_index)
        l1, mask_reg = appearance.loss_terms(m, img, gt, cfg["lambda_mask"])
        photo = (1 - cfg["lambda_dssim"]) * l1 + cfg["lambda_dssim"] * (1 - ssim(img, gt)) + mask_reg
        grads = torch.autograd.grad(photo, [color, alpha] + list(mask_leaves.values()), allow_unused=True,
                                    materialize_grads=True)
    d_rows = raster.blend_vjp(rows.detach(), *lists, view.width, view.height, grads[0], grads[1])
    n_alive = torch.clamp(alive.sum().to(rows.dtype), min=1.0)
    vol = torch.exp(leaves["log_scale"]).prod(-1)
    reg = torch.where(alive, vol, torch.zeros_like(vol)).sum() / n_alive
    pen = penalty(leaves, u, z, alive, rho)
    g_leaves = torch.autograd.grad([rows, cfg["lambda_scale"] * reg + pen], list(leaves.values()) + [offset],
                                   grad_outputs=[d_rows, torch.ones_like(reg)], allow_unused=True,
                                   materialize_grads=True)
    loss = float(photo.detach()) + cfg["lambda_scale"] * float(reg.detach()) + float(pen.detach())
    return (loss, dict(zip(LEAVES, g_leaves[:-1])), proj["radius"] > 0, dict(zip(mask_leaves, grads[2:])),
            float(pen.detach()))


@dataclasses.dataclass
class Warm:
    """A block's optimizer and mask state to continue from: the Gaussians'
    moments `mu` and `nu` (dicts by leaf), the mask's parameters `mask`
    (nested as `appearance.init_params` nests them) and their moments
    `mask_mu` and `mask_nu` (dicts keyed by `appearance.leaves` paths)."""

    mu: dict
    nu: dict
    mask: dict
    mask_mu: dict
    mask_nu: dict


def follow(p0: dict, alive: torch.Tensor, views: list, gts: list, image_indices: list, cfg: dict, sh_degree: int,
           extent: float, start_step: int, u: dict, z: dict, rho: dict, n_images: int, warm: Warm | None = None) -> dict:
    """One block's steps from `p0` (never modified), with fresh moments and
    a fresh mask or from `warm` (copied), one step per (view, gt, image
    index), at global steps start_step, start_step + 1, ...; u, z and rho
    fixed. Returns the losses, the penalty of each step, the first step's
    gradient as the optimizer takes it (drawn rows only) and the parameters
    after the last step."""
    p = {k: p0[k].clone() for k in LEAVES}
    if warm is None:
        mu = {k: torch.zeros_like(v) for k, v in p.items()}
        nu = {k: torch.zeros_like(v) for k, v in p.items()}
        mask_params = appearance.init_params(n_images, p0["xyz"].device)
        m_mu = {k: torch.zeros_like(v) for k, v in appearance.leaves(mask_params).items()}
        m_nu = {k: torch.zeros_like(v) for k, v in appearance.leaves(mask_params).items()}
    else:
        mu = {k: v.clone() for k, v in warm.mu.items()}
        nu = {k: v.clone() for k, v in warm.nu.items()}
        mask_params = _tree_clone(warm.mask)
        m_mu = {k: v.clone() for k, v in warm.mask_mu.items()}
        m_nu = {k: v.clone() for k, v in warm.mask_nu.items()}
    losses, penalties, first = [], [], None
    for i, (view, gt, index) in enumerate(zip(views, gts, image_indices)):
        step = start_step + i
        loss, grads, drawn, g_mask, pen = loss_and_grads(p, alive, view, gt, cfg, sh_degree, mask_params, index, u,
                                                         z, rho)
        losses.append(loss)
        penalties.append(pen)
        if first is None:
            first = {k: torch.where(drawn.view((-1,) + (1,) * (g.dim() - 1)), g, torch.zeros_like(g))
                     for k, g in grads.items()}
        gs3d.sparse_adam(p, grads, mu, nu, drawn, gs3d.learning_rates(cfg, step, extent))
        appearance.adam(mask_params, g_mask, m_mu, m_nu, cfg["mask_lr"], step)
        del grads
    return dict(losses=losses, penalties=penalties, first_grad=first, params=p)


def _tree_clone(tree: dict) -> dict:
    return {k: _tree_clone(v) if isinstance(v, dict) else v.detach().clone().requires_grad_(True)
            for k, v in tree.items()}


@torch.no_grad()
def consensus_round(x: list, alive: list, slot_map: list, u: list, z_old: list, rho: dict, n_global: int,
                    over_relaxation: float, sum_dtype: torch.dtype = torch.float64) -> dict:
    """The dense round over every block in one process. `x`, `u` and `z_old`
    hold a dict of (C, ...) leaves per block, `slot_map` each slot's global
    row (n_global: none); z's sums and counts are kept in `sum_dtype`.
    Returns z (the global rows), z_local and u per block, and primal and
    dual (dicts of floats)."""
    dev = alive[0].device
    counts = torch.zeros((n_global + 1,), dtype=sum_dtype, device=dev)
    sums = {k: torch.zeros((n_global + 1,) + x[0][k].shape[1:], dtype=sum_dtype, device=dev) for k in LEAVES}
    for xb, al, sm in zip(x, alive, slot_map):
        rows = sm.to(dev, torch.int64)[al]
        counts.index_add_(0, rows, torch.ones_like(rows, dtype=sum_dtype))
        for k in LEAVES:
            sums[k].index_add_(0, rows, xb[k][al].to(dev, sum_dtype))
    z = {k: (s[:n_global] / torch.clamp(counts[:n_global], min=1.0).view((-1,) + (1,) * (s.dim() - 1)))
         .to(torch.float32) for k, s in sums.items()}
    z_local, u_new = [], []
    primal = {k: 0.0 for k in LEAVES}
    dual = {k: 0.0 for k in LEAVES}
    for xb, al, sm, ub, zo in zip(x, alive, slot_map, u, z_old):
        idx = torch.clamp(sm.to(dev, torch.int64), max=n_global - 1)
        zl = {k: z[k][idx] for k in LEAVES}
        z_local.append(zl)
        u_new.append({k: torch.where(al.view((-1,) + (1,) * (ub[k].dim() - 1)),
                                     ub[k] + (1.0 + over_relaxation) * (xb[k] - zl[k]), ub[k]) for k in LEAVES})
        for k in LEAVES:
            primal[k] += _mean_alive(zl[k] - xb[k], al)
            dual[k] += float(rho[k]) * _mean_alive(zl[k] - zo[k], al)
    return dict(z=z, z_local=z_local, u=u_new, primal=primal, dual={k: v / len(x) for k, v in dual.items()})


def _mean_alive(d: torch.Tensor, alive: torch.Tensor) -> float:
    mask = alive.view((-1,) + (1,) * (d.dim() - 1))
    n = max(int(alive.sum()), 1) * int(np.prod(d.shape[1:]))
    return float(torch.where(mask, d.double() ** 2, 0.0).sum()) / n


def adapt_rho(rho: dict, primal: dict, dual: dict, mu: float, tau_inc: float, tau_dec: float) -> dict:
    f32 = np.float32
    out = {}
    for k in rho:
        r, p, d = f32(rho[k]), f32(primal[k]), f32(dual[k])
        if p > f32(mu) * d:
            r = r * f32(tau_inc)
        elif d > f32(mu) * p:
            r = r / f32(tau_dec)
        out[k] = f32(r)
    return out
