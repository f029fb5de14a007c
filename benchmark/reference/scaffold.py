"""Plain Scaffold-GS (arXiv 2312.00109): the anchor initialisation, the
per-view decode of each anchor's k neural Gaussians by three MLPs, the
render, the loss and the dense Adam, as the reference that the
`scaffold_mip360` cells are compared with.

Anchors are the centres of the occupied voxels of the point cloud; each has
a 32-d feature, k offsets and 6 log-scales (3 for the offsets' extent, 3
for the Gaussians' base scale). Per view, the feature and the view
direction go through the opacity (tanh), colour (sigmoid) and covariance
heads (35 -> 64 -> k, 3k, 7k, ReLU between); a neural Gaussian with
opacity <= 0, or of a dead or out-of-frustum anchor, is not drawn. The loss
is 0.8 L1 + 0.2 D-SSIM plus lambda_scale times the mean volume of the drawn
Gaussians; every leaf takes bias-corrected Adam (eps 1e-8) at its group's
learning rate. The random draws follow dogs_tpu's order from
RandomState(seed), which is the program's initial state too; matrix
products run in exact float32 (TF32 off).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import raster
from benchmark.reference.loss import photometric

FEAT, HIDDEN = 32, 64
MLPS = ("mlp_opacity", "mlp_color", "mlp_cov")
PREFILTER_MARGIN = 3.0


def init_arrays(points: np.ndarray, voxel: float, k: int, seed: int) -> tuple[dict, np.ndarray]:
    """(leaves keyed `anchor_xyz`, ..., `mlp_cov.w1`, alive) at a capacity of
    the next power-of-two multiple of 256 anchors."""
    rng = np.random.RandomState(seed)
    anchors = (np.unique(np.floor(np.asarray(points, np.float32) / voxel), axis=0) + 0.5) * voxel
    a = anchors.shape[0]
    cap = 256
    while cap < a:
        cap *= 2

    def padded(x):
        out = np.zeros((cap,) + x.shape[1:], np.float32)
        out[:a] = x
        return out

    leaves = dict(
        anchor_xyz=padded(anchors),
        anchor_feat=padded(rng.randn(a, FEAT).astype(np.float32) * 0.01),
        offsets=padded(rng.uniform(-0.5, 0.5, (a, k, 3)).astype(np.float32)),
        log_scaling=np.tile(np.array([np.log(voxel)] * 3 + [np.log(voxel * 0.5)] * 3, np.float32)[None], (cap, 1)),
    )
    for name, out in zip(MLPS, (k, 3 * k, 7 * k)):
        for i, (cin, cout) in enumerate(((FEAT + 3, HIDDEN), (HIDDEN, out))):
            leaves[f"{name}.w{i}"] = (rng.randn(cin, cout).astype(np.float32) * np.sqrt(2.0 / cin)).astype(np.float32)
            leaves[f"{name}.b{i}"] = np.zeros((cout,), np.float32)
    return leaves, np.arange(cap) < a


def _mlp(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(x @ p[f"{name}.w0"] + p[f"{name}.b0"])
    return h @ p[f"{name}.w1"] + p[f"{name}.b1"]


@torch.no_grad()
def in_frustum(p: dict, view: raster.View) -> torch.Tensor:
    xyz, R = p["anchor_xyz"], view.R
    c = xyz[:, 0:1] * R[:, 0] + xyz[:, 1:2] * R[:, 1] + xyz[:, 2:3] * R[:, 2] + view.t
    z = torch.clamp(c[:, 2], min=1e-6)
    u, v = view.fx * c[:, 0] / z + view.cx, view.fy * c[:, 1] / z + view.cy
    r = view.fx * PREFILTER_MARGIN * torch.exp(p["log_scaling"][:, 0:3]).amax(-1) / z
    return (c[:, 2] > 0.01) & (u > -r) & (u < view.width + r) & (v > -r) & (v < view.height + r)


def decode(p: dict, view: raster.View, alive: torch.Tensor) -> tuple:
    """(Gaussians for raster.project, colours (A k, 3), drawn (A k,), scales
    (A k, 3))."""
    a, k = p["offsets"].shape[0], p["offsets"].shape[1]
    d = p["anchor_xyz"] - view.center
    d = d / torch.sqrt(torch.clamp((d * d).sum(-1, keepdim=True), min=1e-24))
    f = torch.cat([p["anchor_feat"], d], -1)
    opacity = torch.tanh(_mlp(p, "mlp_opacity", f))
    color = torch.sigmoid(_mlp(p, "mlp_color", f)).reshape(a * k, 3)
    cov = _mlp(p, "mlp_cov", f).reshape(a, k, 7)
    xyz = p["anchor_xyz"][:, None] + p["offsets"] * torch.exp(p["log_scaling"][:, None, 0:3])
    scale = torch.exp(p["log_scaling"][:, None, 3:6]) * torch.sigmoid(cov[..., 0:3]) * 2.0
    ok = alive & in_frustum(p, view)
    drawn = ((opacity > 0) & ok[:, None]).reshape(-1)
    op = torch.clamp(opacity.reshape(-1, 1), 1e-4, 1 - 1e-4)
    g = dict(xyz=xyz.reshape(-1, 3), log_scale=torch.log(torch.clamp(scale.reshape(-1, 3), min=1e-8)),
             quat=cov[..., 3:7].reshape(-1, 4), logit_opacity=torch.log(op / (1 - op)))
    return g, color, drawn, scale.reshape(-1, 3)


def loss_and_grads(p: dict, alive: torch.Tensor, view: raster.View, gt: torch.Tensor, cfg: dict) -> tuple:
    leaves = {n: t.detach().requires_grad_(True) for n, t in p.items()}
    g, color_in, drawn, scale = decode(leaves, view, alive)
    proj = raster.project(g, view, 0, alive=drawn, colors=color_in)
    rows = raster.entry_rows(proj)
    lists = raster.tile_lists(proj, view.width, view.height, cfg["max_tiles_per_gaussian"])
    color, alpha, _, _ = raster.blend(rows.detach(), *lists, view.width, view.height)
    color.requires_grad_(True)
    photo = photometric(torch.clamp(color, 0.0, 1.0), gt.to(color.dtype), cfg["lambda_dssim"])
    (d_color,) = torch.autograd.grad(photo, [color])
    d_rows = raster.blend_vjp(rows.detach(), *lists, view.width, view.height, d_color, torch.zeros_like(alpha))
    vol = scale.prod(-1)
    reg = torch.where(drawn, vol, torch.zeros_like(vol)).sum() / torch.clamp(drawn.sum().to(vol.dtype), min=1.0)
    grads = torch.autograd.grad([rows, cfg["lambda_scale"] * reg], list(leaves.values()),
                                grad_outputs=[d_rows, torch.ones_like(reg)], allow_unused=True, materialize_grads=True)
    return float(photo.detach()) + cfg["lambda_scale"] * float(reg.detach()), dict(zip(leaves, grads))


def learning_rates(cfg: dict, step: int) -> dict:
    def decay(a, b):
        t = min(max(step / cfg["max_iterations"], 0.0), 1.0)
        return math.exp((1 - t) * math.log(a) + t * math.log(b))

    mlp = decay(cfg["mlp_lr_init"], cfg["mlp_lr_final"])
    return dict(anchor_xyz=decay(cfg["anchor_lr_init"], cfg["anchor_lr_final"]), anchor_feat=cfg["feat_lr"],
                offsets=decay(cfg["offset_lr_init"], cfg["offset_lr_final"]), log_scaling=cfg["scaling_lr"],
                **{m: mlp for m in MLPS})


def follow(p0: dict, alive: torch.Tensor, views: list, gts: list, cfg: dict) -> dict:
    """Steps 0, 1, ... from `p0` (not modified), one per (view, gt):
    losses, the first step's gradients and the parameters after the last."""
    p = {n: t.clone() for n, t in p0.items()}
    mu = {n: torch.zeros_like(t) for n, t in p.items()}
    nu = {n: torch.zeros_like(t) for n, t in p.items()}
    losses, first = [], None
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = cfg.get("allow_tf32", False)
    try:
        for step, (view, gt) in enumerate(zip(views, gts)):
            loss, grads = loss_and_grads(p, alive, view, gt, cfg)
            losses.append(loss)
            first = first or grads
            lr = learning_rates(cfg, step)
            with torch.no_grad():
                for n in p:
                    mu[n] = 0.9 * mu[n] + 0.1 * grads[n]
                    nu[n] = 0.999 * nu[n] + 0.001 * grads[n] * grads[n]
                    m_hat, v_hat = mu[n] / (1 - 0.9 ** (step + 1)), nu[n] / (1 - 0.999 ** (step + 1))
                    p[n] = p[n] - lr[n.split(".")[0]] * m_hat / (torch.sqrt(v_hat) + 1e-8)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return dict(losses=losses, first_grad=first, params=p)
