"""SSIM with an 11x11 Gaussian window (sigma 1.5).

Port of dogs_tpu/raster/ssim.py. The separable blur is written as shifted
weighted sums, as there, rather than `conv2d`: on the card cuDNN would run a
float32 convolution in TF32 (`torch.backends.cudnn.allow_tf32` is True by
default) and the SSIM would drift from the CPU result. These sums are plain
f32 on every device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

_C1 = 0.01**2
_C2 = 0.03**2


@functools.lru_cache(maxsize=4)
def _gaussian_window(window_size: int, sigma: float) -> tuple[float, ...]:
    x = np.arange(window_size) - window_size // 2
    g = np.exp(-(x**2) / (2.0 * sigma**2))
    return tuple(float(v) for v in (g / g.sum()).astype(np.float32))


def _blur(x: torch.Tensor, window_size: int, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of (B, H, W, C) with zero 'same' padding."""
    pad = window_size // 2
    w = _gaussian_window(window_size, sigma)

    def axis_blur(x, dim):
        n = x.shape[dim]
        # F.pad lists (before, after) pairs from the last dim backwards.
        widths = [0, 0] * (x.dim() - 1 - dim) + [pad, pad]
        xp = F.pad(x, widths)
        total = w[0] * xp.narrow(dim, 0, n)
        for k in range(1, window_size):
            total = total + w[k] * xp.narrow(dim, k, n)
        return total

    return axis_blur(axis_blur(x, 1), 2)


def ssim_map(
    img1: torch.Tensor,
    img2: torch.Tensor,
    window_size: int = 11,
    sigma: float = 1.5,
) -> torch.Tensor:
    """Per-pixel SSIM map. Inputs (H, W, C) or (B, H, W, C) in [0, 1]."""
    squeeze = img1.dim() == 3
    if squeeze:
        img1, img2 = img1[None], img2[None]
    mu1 = _blur(img1, window_size, sigma)
    mu2 = _blur(img2, window_size, sigma)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu12 = mu1 * mu2
    sigma1_sq = _blur(img1 * img1, window_size, sigma) - mu1_sq
    sigma2_sq = _blur(img2 * img2, window_size, sigma) - mu2_sq
    sigma12 = _blur(img1 * img2, window_size, sigma) - mu12
    num = (2.0 * mu12 + _C1) * (2.0 * sigma12 + _C2)
    den = (mu1_sq + mu2_sq + _C1) * (sigma1_sq + sigma2_sq + _C2)
    out = num / den
    return out[0] if squeeze else out


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Mean SSIM."""
    return ssim_map(img1, img2, window_size).mean()


def dssim_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """1 - SSIM, the structural term of the 3DGS photometric loss."""
    return 1.0 - ssim(pred, gt)
