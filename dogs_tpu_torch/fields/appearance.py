"""VastGaussian decoupled appearance embedding (the "mask" network).

Port of dogs_tpu/fields/appearance.py: a per-image 64-d embedding is
broadcast-concatenated onto the x32-downsampled render, pushed through a
small conv + pixel-shuffle-upsample CNN, and gives a 3-channel
MULTIPLICATIVE map centred at 1. The training loss uses
L1(render * mask, gt) + lambda_mask * mean((mask - 1)^2).

Parameters are a plain dictionary of tensors in dogs_tpu's layout
(`{"embed": (n_images, 64), "conv_in": {"w": HWIO, "b"}, "head": ...,
"up0".."up3": ...}`), so a checkpoint holds the same arrays in both
packages; the convolutions take the weights as OIHW views. The pixel
shuffle keeps dogs_tpu's channel order, (i * r + j) * c_out + c, which is
not `F.pixel_shuffle`'s c * r * r + i * r + j. On the card the
convolutions run in exact f32 (`exact_f32`: cuDNN off and TF32 off; the
trainer also takes their backward under it). With TF32 off, cuDNN's choice
of f32 algorithm varies from run to run: on an NVIDIA H100 80GB HBM3 at
700 W one choice put conv_in's bias gradients 7.7e-3 of their max from the
CPU's at 96x80 (the bar is 2e-3), others 1.8e-6 to 2.6e-6. PyTorch's own
im2col + cuBLAS convolution is f32-exact there every time and faster at
1152x864, 10.6 against 14.7 ms forward and backward (chip_smoke.py phase
6f; PERF.md). The two bilinear resizes run as matmuls with
`F.interpolate`'s weights, so that the mask's backward, and with it a
train step, gives the same bits on every run on the card.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

DOWNSAMPLE = 32
EMBED_DIM = 64
HIDDEN = 128
UPSTAGES = 4  # 4 x pixel shuffle(2) = x16, then bilinear x2 to full res


def init_appearance_arrays(num_images: int, rng: np.random.RandomState | None = None) -> dict:
    """dogs_tpu's initial parameters as numpy arrays, drawn from
    `RandomState(0)` (or `rng`) in its order: embed, conv_in, head, up0-3."""
    rng = rng or np.random.RandomState(0)

    def conv(cin, cout, k=3):
        w = rng.randn(k, k, cin, cout).astype(np.float32) * np.sqrt(2.0 / (k * k * cin))  # float64
        return {"w": w.astype(np.float32), "b": np.zeros((cout,), np.float32)}

    params = {
        "embed": rng.randn(num_images, EMBED_DIM).astype(np.float32) * 0.01,
        "conv_in": conv(3 + EMBED_DIM, HIDDEN),
        "head": conv(HIDDEN, 3, k=1),
    }
    for i in range(UPSTAGES):
        params[f"up{i}"] = conv(HIDDEN, HIDDEN * 4)
    return params


def appearance_params_from_numpy(arrays: dict, device: torch.device | str = "cuda") -> dict:
    """Nested numpy arrays in dogs_tpu's layout (a JAX parameter tree or
    `init_appearance_arrays`) as float32 tensors that require grad."""
    return {
        k: appearance_params_from_numpy(v, device) if isinstance(v, dict)
        else torch.tensor(np.asarray(v, np.float32), device=device, requires_grad=True)
        for k, v in arrays.items()
    }


def init_appearance_params(num_images: int, rng: np.random.RandomState | None = None,
                           device: torch.device | str = "cuda") -> dict:
    """dogs_tpu's initial parameters (`init_appearance_arrays`) as tensors on
    `device` that require grad."""
    return appearance_params_from_numpy(init_appearance_arrays(num_images, rng), device)


def flatten(params: dict, prefix: str = "") -> dict[str, torch.Tensor]:
    """The leaves of a parameter tree keyed by their `jax.tree_util` path
    string (`['conv_in']/['b']`, ...) in JAX's flattening order (sorted keys)."""
    out = {}
    for k in sorted(params):
        key = f"{prefix}/['{k}']" if prefix else f"['{k}']"
        v = params[k]
        out.update(flatten(v, key) if isinstance(v, dict) else {key: v})
    return out


@contextlib.contextmanager
def exact_f32():
    """Convolutions in exact f32 inside the block: cuDNN off (PyTorch's
    im2col + cuBLAS convolution runs instead) and cuBLAS without TF32; the
    settings are restored after."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    tf32 = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        with cudnn.flags(enabled=False, benchmark=cudnn.benchmark, deterministic=cudnn.deterministic,
                         allow_tf32=False):
            yield
    finally:
        matmul.allow_tf32 = tf32


def _conv(x: torch.Tensor, p: dict) -> torch.Tensor:
    """NCHW convolution with an HWIO weight, padding k // 2 on both sides."""
    w = p["w"].permute(3, 2, 0, 1)
    return F.conv2d(x, w, p["b"], padding=w.shape[-1] // 2)


def _pixel_shuffle(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """(B, C*r^2, H, W) -> (B, C, H*r, W*r) with dogs_tpu's channel order:
    input channel (i * r + j) * C + c goes to output (c, h * r + i, w * r + j)."""
    b, c, h, w = x.shape
    c_out = c // (r * r)
    x = x.reshape(b, r, r, c_out, h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(b, c_out, h * r, w * r)


def _resize_weights(n_in: int, n_out: int, antialias: bool, like: torch.Tensor) -> torch.Tensor:
    """(n_out, n_in) weights of `F.interpolate`'s bilinear resize along one
    axis (align_corners=False), read off by resizing the identity (two
    columns wide: the antialiased resize of a one-wide image weighs
    otherwise), in `like`'s dtype on its device."""
    eye = torch.eye(n_in, dtype=like.dtype, device=like.device)[None, :, :, None].expand(1, n_in, n_in, 2)
    out = F.interpolate(eye, size=(n_out, 2), mode="bilinear", align_corners=False, antialias=antialias)
    return out[0, :, :, 0].T


def _resize(x: torch.Tensor, h: int, w: int, antialias: bool = False) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, h, w) bilinear, as `F.interpolate` weighs it,
    applied as two matmuls: their backward is deterministic on the card,
    where `F.interpolate`'s bilinear backward adds with atomics."""
    wy = _resize_weights(x.shape[-2], h, antialias, x)
    wx = _resize_weights(x.shape[-1], w, antialias, x)
    return torch.matmul(wy, torch.matmul(x, wx.T))


def apply_appearance(params: dict, image: torch.Tensor, image_index: int) -> torch.Tensor:
    """Render (H, W, 3) -> multiplicative mask (H, W, 3), centred at 1. An
    `image_index` past the embedding's rows reads its last row, as
    dogs_tpu's gather does."""
    h, w, _ = image.shape
    hd, wd = max(h // DOWNSAMPLE, 1), max(w // DOWNSAMPLE, 1)
    x = image.permute(2, 0, 1)[None]
    ds = _resize(x, hd, wd, antialias=True)
    embed = params["embed"]
    e = embed[min(int(image_index), embed.shape[0] - 1)]
    x = torch.cat([ds, e[None, :, None, None].expand(1, EMBED_DIM, hd, wd)], dim=1)
    x = torch.relu(_conv(x, params["conv_in"]))
    for i in range(UPSTAGES):
        x = torch.relu(_pixel_shuffle(_conv(x, params[f"up{i}"])))
    x = _conv(x, params["head"])
    x = _resize(x, h, w)
    # Residual around identity: the regularizer mean((mask-1)^2) pulls to 1.
    return 1.0 + x[0].permute(1, 2, 0)


def appearance_loss_terms(mask: torch.Tensor, render: torch.Tensor, gt: torch.Tensor, lambda_mask: float):
    """(masked L1, mask regularizer)."""
    l1 = torch.mean(torch.abs(render * mask - gt))
    reg = lambda_mask * torch.mean((mask - 1.0) ** 2)
    return l1, reg
