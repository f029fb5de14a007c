"""Evaluation metrics: PSNR, SSIM, color correction.

Port of dogs_tpu/eval/metrics.py. LPIPS is not ported yet (ROADMAP.md,
queue 1 item 10).
"""

from __future__ import annotations

import math

import torch

from dogs_tpu_torch.raster.ssim import ssim as ssim_fn


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((pred - gt) ** 2)
    return -10.0 * torch.log(torch.clamp(mse, min=1e-12)) / math.log(10.0)


def ssim(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return ssim_fn(pred, gt)


def _lstsq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Least squares through the SVD, as jnp.linalg.lstsq(rcond=-1) does:
    singular values below eps * s_max are dropped. (torch.linalg.lstsq on
    CUDA only has the full-rank QR driver; masked fits can be rank-deficient.)"""
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    keep = (s > 0) & (s >= torch.finfo(s.dtype).eps * s[0])
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)), 0.0)
    return vt.T @ (s_inv * (u.T @ b))


def color_correct(
    img: torch.Tensor, ref: torch.Tensor, num_iters: int = 5, eps: float = 0.5 / 255
) -> torch.Tensor:
    """Full quadratic cross-channel color warp fitted to the reference image
    (the same fit as dogs_tpu: basis [img_c * img_{c..C}, img, 1], saturated
    pixels masked out of each per-channel least-squares fit, refit
    `num_iters` times, output clipped to [0, 1])."""
    nc = img.shape[-1]
    if ref.shape[-1] != nc:
        raise ValueError(f"channel mismatch: img {nc} vs ref {ref.shape[-1]}")
    orig = img.reshape(-1, nc)
    ref_mat = ref.reshape(-1, nc)

    def unclipped(z):
        return (z >= eps) & (z <= 1.0 - eps)

    mask0 = unclipped(orig)
    cur = orig
    for _ in range(num_iters):
        basis = [cur[:, c : c + 1] * cur[:, c:] for c in range(nc)]
        basis.append(cur)
        basis.append(torch.ones_like(cur[:, :1]))
        a = torch.cat(basis, dim=-1)
        cols = []
        for c in range(nc):
            b = ref_mat[:, c]
            m = mask0[:, c] & unclipped(cur[:, c]) & unclipped(b)
            am = torch.where(m[:, None], a, 0.0)
            bm = torch.where(m, b, 0.0)
            cols.append(_lstsq(am, bm))
        warp = torch.stack(cols, dim=-1)
        cur = torch.clamp(a @ warp, 0.0, 1.0)
    return cur.reshape(img.shape)
