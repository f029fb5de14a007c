"""SSIM with an 11x11 Gaussian window (sigma 1.5).

Port of dogs_tpu/raster/ssim.py. The separable blur is written as shifted
weighted sums, as there, rather than `conv2d`: on the card cuDNN would run a
float32 convolution in TF32 (`torch.backends.cudnn.allow_tf32` is True by
default) and the SSIM would drift from the CPU result. These sums are plain
f32 on every device.

`ssim_map` is that plain version on every device. `ssim`, the mean that both
training steps' losses and the evaluator take, runs it on CPU tensors; on
CUDA tensors it is one hand-written kernel pair (csrc/ssim.cu, arithmetic in
csrc/ssim.cuh): the forward computes `ssim_map` bit for bit in one launch,
its mean, and the three derivative maps the backward reads; the backward
writes the gradient in `img1` in one more. `img2` is a constant there (the
target): the wrapper raises if it requires grad, and on a window other than
11 or a dtype other than f32; it hands the kernels a contiguous copy of a
strided image (a crop of a larger one), which they do not take.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from dogs_tpu_torch import kernels

_C1 = 0.01**2
_C2 = 0.03**2
WINDOW = 11  # the one window size the kernels take
SIGMA = 1.5
TILE = (16, 32)  # output rows and columns a CTA (csrc/ssim.cuh kTileH, kTileW)

_VP = ctypes.c_void_p


class KernelArgs(ctypes.Structure):
    """csrc/ssim.cuh's `Args`, field for field."""

    _fields_ = [(name, _VP) for name in ("x", "y", "dmap", "map", "partial", "loss", "grad", "dx")] + [
        ("batch", ctypes.c_longlong), ("height", ctypes.c_int), ("width", ctypes.c_int), ("channels", ctypes.c_int),
        ("window", ctypes.c_float * WINDOW), ("c1", ctypes.c_float), ("c2", ctypes.c_float),
    ]


_ARGTYPES = (ctypes.POINTER(KernelArgs), _VP)


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


def check_kernel_inputs(img1: torch.Tensor, img2: torch.Tensor) -> None:
    """Raise on images the kernels do not take (`ssim` makes strided ones
    contiguous first)."""
    if img1.dtype != torch.float32 or img2.dtype != torch.float32:
        raise ValueError(f"ssim runs the CUDA kernel: images must be float32, not {img1.dtype} and {img2.dtype}")
    if img1.shape != img2.shape or img1.dim() not in (3, 4):
        raise ValueError(f"ssim: images must share one (H, W, C) or (B, H, W, C) shape, not "
                         f"{tuple(img1.shape)} and {tuple(img2.shape)}")
    if not (img1.is_contiguous() and img2.is_contiguous()):
        raise ValueError("ssim runs the CUDA kernel: images must be contiguous")
    if img2.requires_grad:
        raise ValueError("ssim runs the CUDA kernel: img2 is the target and carries no gradient")
    kernels.require_cuda("ssim", img1, img2)


def kernel_args(img1: torch.Tensor, img2: torch.Tensor, **buffers: torch.Tensor | None) -> KernelArgs:
    """The kernels' arguments: the images, then `buffers` (dmap, map,
    partial, loss, grad, dx; absent = null) by `Args` field."""
    b, h, w, c = (1,) * (4 - img1.dim()) + tuple(img1.shape)
    ptrs = {k: (t.data_ptr() if t is not None else None) for k, t in buffers.items()}
    return KernelArgs(x=img1.data_ptr(), y=img2.data_ptr(), **ptrs, batch=b, height=h, width=w, channels=c,
                      window=(ctypes.c_float * WINDOW)(*_gaussian_window(WINDOW, SIGMA)),
                      c1=_C1, c2=_C2)


def num_tiles(img: torch.Tensor) -> int:
    """CTAs of the forward: one a TILE of pixels an image."""
    b, h, w = ((1,) * (4 - img.dim()) + tuple(img.shape))[:3]
    return b * -(-h // TILE[0]) * -(-w // TILE[1])


def ssim_forward(img1: torch.Tensor, img2: torch.Tensor, keep: bool = False,
                 want_map: bool = False) -> tuple[torch.Tensor, torch.Tensor | None, torch.Tensor | None]:
    """One launch of dogs_ssim_forward: the mean SSIM (a 0-d tensor), the
    (3, *img1.shape) derivative maps the backward reads if `keep`, and the
    map if `want_map` (else None)."""
    check_kernel_inputs(img1, img2)
    loss = torch.empty((), dtype=torch.float32, device=img1.device)
    partial = torch.empty(num_tiles(img1), dtype=torch.float32, device=img1.device)
    dmap = torch.empty((3,) + img1.shape, dtype=torch.float32, device=img1.device) if keep else None
    smap = torch.empty_like(img1) if want_map else None
    args = kernel_args(img1, img2, dmap=dmap, map=smap, partial=partial, loss=loss)
    kernels.launch("ssim", "dogs_ssim_forward", _ARGTYPES, ctypes.byref(args), device=img1.device)
    return loss, dmap, smap


def ssim_backward(img1: torch.Tensor, img2: torch.Tensor, dmap: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """One launch of dogs_ssim_backward: the gradient in `img1` of the mean
    SSIM times `grad` (a 0-d cotangent on the card), from the forward's
    derivative maps."""
    kernels.require_cuda("ssim_backward", img1, img2, dmap, grad)
    dx = torch.empty_like(img1)
    args = kernel_args(img1, img2, dmap=dmap, grad=grad, dx=dx)
    kernels.launch("ssim", "dogs_ssim_backward", _ARGTYPES, ctypes.byref(args), device=img1.device)
    return dx


class _SSIM(torch.autograd.Function):
    """The kernel pair as one autograd node: the mean SSIM of (img1, img2),
    differentiable in img1. Saved for the backward: the images and the
    derivative maps, freed once it has run."""

    @staticmethod
    def forward(ctx, img1, img2):
        loss, dmap, _ = ssim_forward(img1, img2, keep=True)
        ctx.save_for_backward(img1, img2, dmap)
        return loss

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        img1, img2, dmap = ctx.saved_tensors
        return ssim_backward(img1, img2, dmap, grad), None


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Mean SSIM of (H, W, C) or (B, H, W, C) images. CUDA tensors: the
    kernel pair on contiguous copies, differentiable in img1 (the render)
    alone, or a raise; otherwise the plain `ssim_map`'s mean."""
    if not img1.is_cuda:
        return ssim_map(img1, img2, window_size).mean()
    if window_size != WINDOW:
        raise ValueError(f"ssim runs the CUDA kernel: window {window_size}, but it takes {WINDOW}")
    img1, img2 = img1.contiguous(), img2.contiguous()
    if torch.is_grad_enabled() and img1.requires_grad:
        return _SSIM.apply(img1, img2)
    return ssim_forward(img1, img2)[0]


def dssim_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """1 - SSIM, the structural term of the 3DGS photometric loss."""
    return 1.0 - ssim(pred, gt)
