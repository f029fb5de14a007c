"""The photometric loss of 3DGS: (1 - l) L1 + l (1 - SSIM), SSIM with an
11 x 11 Gaussian window of sigma 1.5 and zero padding, as the 3DGS paper
(arXiv 2308.04079, section 7) trains; and PSNR."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

C1, C2 = 0.01 ** 2, 0.03 ** 2


def _window(dtype, device) -> torch.Tensor:
    x = torch.arange(11, dtype=torch.float64) - 5
    g = torch.exp(-x * x / (2 * 1.5 ** 2))
    return (g / g.sum()).to(dtype).to(device)


def _blur(x: torch.Tensor) -> torch.Tensor:
    """Separable blur of (C, H, W), written as shifted sums (no convolution
    library, so no TF32)."""
    w = _window(x.dtype, x.device)
    h, wd = x.shape[1], x.shape[2]
    xp = F.pad(x, (0, 0, 5, 5))
    x = sum(w[k] * xp[:, k:k + h] for k in range(11))
    xp = F.pad(x, (5, 5))
    return sum(w[k] * xp[:, :, k:k + wd] for k in range(11))


def ssim(img: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of two (H, W, 3) images."""
    a, b = img.permute(2, 0, 1), gt.permute(2, 0, 1)
    mu_a, mu_b = _blur(a), _blur(b)
    saa = _blur(a * a) - mu_a * mu_a
    sbb = _blur(b * b) - mu_b * mu_b
    sab = _blur(a * b) - mu_a * mu_b
    m = ((2 * mu_a * mu_b + C1) * (2 * sab + C2)) / ((mu_a * mu_a + mu_b * mu_b + C1) * (saa + sbb + C2))
    return m.mean()


def photometric(img: torch.Tensor, gt: torch.Tensor, lambda_dssim: float) -> torch.Tensor:
    return (1 - lambda_dssim) * (img - gt).abs().mean() + lambda_dssim * (1 - ssim(img, gt))


def psnr(img: torch.Tensor, gt: torch.Tensor) -> float:
    mse = float(((img.double() - gt.double()) ** 2).mean())
    return -10.0 * math.log10(max(mse, 1e-20))
