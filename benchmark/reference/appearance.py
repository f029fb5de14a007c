"""A plain VastGaussian appearance mask (arXiv 2402.17427, section 3.3), as
DOGS trains it with `geometry.mask` (urban3d_admm.yaml): the render is
downsampled x32 (bilinear, antialiased), a per-image 64-d embedding is
concatenated to every downsampled pixel, a 3x3 convolution to 128 channels,
four stages of (3x3 convolution to 512, pixel shuffle x2, ReLU) and a 1x1
head to 3 channels give a map that is upsampled (bilinear) to the render's
size; the mask is 1 + that map. The loss takes L1 on render x mask against
the ground truth and adds lambda_mask * mean((mask - 1)^2); SSIM stays on
the render.

Departures from the paper's description, each as DOGS' JAX code has it:
the pixel shuffle reads input channel (i * r + j) * C + c into output
channel c at offset (i, j) (not `F.pixel_shuffle`'s c * r * r + i * r + j);
a ReLU follows the first convolution too; the initial weights are drawn
from `numpy.random.RandomState(0)` in the order embed, conv_in, head,
up0-up3 (He-normal, zero biases, the embedding normal x 0.01).

Plain float32 PyTorch with TF32 and cuDNN off, so the convolutions are
f32-exact on the card too.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

DOWNSAMPLE = 32
EMBED = 64
HIDDEN = 128
STAGES = 4


def init_params(n_images: int, device) -> dict:
    """The initial parameters (HWIO weights), float32 tensors that require
    grad."""
    rng = np.random.RandomState(0)

    def conv(cin: int, cout: int, k: int = 3) -> dict:
        w = rng.randn(k, k, cin, cout).astype(np.float32) * np.sqrt(2.0 / (k * k * cin))
        return {"w": w.astype(np.float32), "b": np.zeros((cout,), np.float32)}

    arrays = {"embed": rng.randn(n_images, EMBED).astype(np.float32) * 0.01,
              "conv_in": conv(3 + EMBED, HIDDEN), "head": conv(HIDDEN, 3, k=1)}
    for i in range(STAGES):
        arrays[f"up{i}"] = conv(HIDDEN, 4 * HIDDEN)

    def tensors(a):
        if isinstance(a, dict):
            return {k: tensors(v) for k, v in a.items()}
        return torch.tensor(np.asarray(a, np.float32), device=device, requires_grad=True)

    return tensors(arrays)


def leaves(params: dict, prefix: str = "") -> dict:
    """The parameter tensors keyed by path, in sorted key order."""
    out = {}
    for k in sorted(params):
        v = params[k]
        out.update(leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


@contextlib.contextmanager
def exact_f32():
    matmul = torch.backends.cuda.matmul
    tf32 = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
            yield
    finally:
        matmul.allow_tf32 = tf32


def _conv(x: torch.Tensor, p: dict) -> torch.Tensor:
    w = p["w"].permute(3, 2, 0, 1)
    return F.conv2d(x, w, p["b"], padding=w.shape[-1] // 2)


def _shuffle(x: torch.Tensor) -> torch.Tensor:
    """(B, 4C, H, W) -> (B, C, 2H, 2W): input channel (2i + j) C + c goes to
    output channel c at row 2h + i, column 2w + j."""
    b, c4, h, w = x.shape
    c = c4 // 4
    out = x.new_zeros((b, c, 2 * h, 2 * w))
    for i in range(2):
        for j in range(2):
            out[:, :, i::2, j::2] = x[:, (2 * i + j) * c:(2 * i + j + 1) * c]
    return out


def mask(params: dict, render: torch.Tensor, image_index: int) -> torch.Tensor:
    """(H, W, 3) render -> (H, W, 3) multiplicative mask."""
    h, w, _ = render.shape
    x = render.permute(2, 0, 1)[None]
    x = F.interpolate(x, size=(max(h // DOWNSAMPLE, 1), max(w // DOWNSAMPLE, 1)), mode="bilinear",
                      align_corners=False, antialias=True)
    e = params["embed"][min(image_index, params["embed"].shape[0] - 1)]
    x = torch.cat([x, e[None, :, None, None].expand(1, EMBED, x.shape[2], x.shape[3])], 1)
    x = torch.relu(_conv(x, params["conv_in"]))
    for i in range(STAGES):
        x = torch.relu(_shuffle(_conv(x, params[f"up{i}"])))
    x = _conv(x, params["head"])
    x = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)
    return 1.0 + x[0].permute(1, 2, 0)


def loss_terms(m: torch.Tensor, render: torch.Tensor, gt: torch.Tensor, lambda_mask: float):
    """(L1 of the masked render, the mask's regularizer)."""
    return (render * m - gt).abs().mean(), lambda_mask * ((m - 1.0) ** 2).mean()


@torch.no_grad()
def adam(params: dict, grads: dict, mu: dict, nu: dict, lr: float, step: int) -> None:
    """Bias-corrected Adam (b1 0.9, b2 0.999, eps 1e-8) at 0-based `step`,
    in place, over the `leaves` of the parameters."""
    t = step + 1.0
    for k, p in leaves(params).items():
        g = grads[k]
        mu[k] = 0.9 * mu[k] + 0.1 * g
        nu[k] = 0.999 * nu[k] + 0.001 * g * g
        p.sub_(lr * (mu[k] / (1 - 0.9 ** t)) / (torch.sqrt(nu[k] / (1 - 0.999 ** t)) + 1e-8))
