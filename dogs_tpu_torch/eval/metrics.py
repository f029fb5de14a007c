"""Evaluation metrics: PSNR, SSIM, LPIPS, color correction.

Port of dogs_tpu/eval/metrics.py. LPIPS is the LPIPS-AlexNet distance with
dogs_tpu's weights: calibrated ones from a local .npz named by the
argument or `DOGS_TPU_LPIPS_WEIGHTS` (keys conv{i}_w in HWIO, conv{i}_b,
lin{i}), else the same deterministic random filters (`RandomState(0)`),
reported as uncalibrated. Nothing is downloaded.
"""

from __future__ import annotations

import functools
import math
import os

import numpy as np
import torch
import torch.nn.functional as F

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


# ---------------------------------------------------------------------------
# LPIPS (AlexNet feature distance)
# ---------------------------------------------------------------------------

_ALEX_CFG = [
    # (out_channels, kernel, stride, padding)
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
]
_POOL_AFTER = {0, 1}  # 3x3 stride-2 max pool after conv1 and conv2
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def _default_lpips_params(seed: int = 0):
    """Random fixed filters (the uncalibrated fallback), drawn as dogs_tpu
    draws them: HWIO weights, zero biases, then the five `lins`."""
    rng = np.random.RandomState(seed)
    params = []
    cin = 3
    for cout, k, _, _ in _ALEX_CFG:
        w = rng.randn(k, k, cin, cout).astype(np.float32) * np.sqrt(2.0 / (k * k * cin))
        params.append({"w": w, "b": np.zeros((cout,), np.float32)})
        cin = cout
    lins = [np.abs(rng.randn(c, 1).astype(np.float32)) * 0.1 for c in (64, 192, 384, 256, 256)]
    return params, lins


def _load_lpips_params(weights_path: str | None):
    """(params, lins, calibrated) from the .npz at `weights_path` if it
    exists, else the fallback filters."""
    if weights_path and os.path.exists(weights_path):
        with np.load(weights_path) as data:
            params = [{"w": data[f"conv{i}_w"], "b": data[f"conv{i}_b"]} for i in range(5)]
            lins = [data[f"lin{i}"] for i in range(5)]
        return params, lins, True
    params, lins = _default_lpips_params()
    return params, lins, False


@functools.lru_cache(maxsize=2)
def _lpips_tensors(weights_path: str | None, device: torch.device):
    """The LPIPS weights on `device`: conv weights OIHW, biases, and the
    lins as (1, C, 1, 1)."""
    params, lins, calibrated = _load_lpips_params(weights_path)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    convs = [(t(p["w"]).permute(3, 2, 0, 1).contiguous(), t(p["b"])) for p in params]
    return convs, [t(w).reshape(1, -1, 1, 1) for w in lins], calibrated


def _alex_features(x: torch.Tensor, convs) -> list[torch.Tensor]:
    """x: (1, 3, H, W), LPIPS-scaled. The ReLU output of each conv layer."""
    feats = []
    h = x
    for i, ((w, b), (_, _, stride, pad)) in enumerate(zip(convs, _ALEX_CFG)):
        h = F.relu(F.conv2d(h, w, b, stride=stride, padding=pad))
        feats.append(h)
        if i in _POOL_AFTER:
            h = F.max_pool2d(h, 3, 2)
    return feats


@torch.no_grad()
def lpips(pred: torch.Tensor, gt: torch.Tensor, weights_path: str | None = None) -> tuple[torch.Tensor, bool]:
    """LPIPS distance of two (H, W, 3) images in [0, 1] on one device;
    returns (0-d value on that device, calibrated). calibrated=False means
    the fallback random filters were used. The convolutions run in f32."""
    weights_path = weights_path or os.environ.get("DOGS_TPU_LPIPS_WEIGHTS")
    convs, lins, calibrated = _lpips_tensors(weights_path, pred.device)
    shift = torch.as_tensor(_SHIFT, device=pred.device)
    scale = torch.as_tensor(_SCALE, device=pred.device)

    def prep(im):
        return ((im.to(torch.float32) * 2.0 - 1.0 - shift) / scale).permute(2, 0, 1)[None]

    cudnn = torch.backends.cudnn  # allows TF32 by default: off for this call only, the rest kept
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark, deterministic=cudnn.deterministic,
                     allow_tf32=False):
        fa = _alex_features(prep(pred), convs)
        fb = _alex_features(prep(gt), convs)
    total = torch.zeros((), dtype=torch.float32, device=pred.device)
    for a, b, lin in zip(fa, fb, lins):
        a = a / torch.clamp(torch.linalg.vector_norm(a, dim=1, keepdim=True), min=1e-10)
        b = b / torch.clamp(torch.linalg.vector_norm(b, dim=1, keepdim=True), min=1e-10)
        total = total + torch.mean(torch.sum((a - b) ** 2 * lin, dim=1))
    return total, calibrated
