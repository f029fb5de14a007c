"""Gaussian field export and import: 3DGS .ply, antimatter15 .splat, COLMAP ply.

Port of dogs_tpu/fields/io.py (the reference's gaussian_splat_model.py:616-709
save_ply / save_colmap_ply / save_splat and load_ply). The writers take the
port's `GaussianParams` and alive mask, bring them to the host with
`.detach().cpu().numpy()` and run dogs_tpu's numpy code on them, so the
files are byte-equal to dogs_tpu's for the same model. `.splat` feeds the
web viewer (webui/src/loaders/SplatLoader.js): 32 bytes per splat [pos
3xf32 | scale 3xf32 | rgba 4xu8 | quat 4xu8], sorted by volume x opacity,
largest first. dogs_tpu's `.ksplat` writer is not ported: no port path
calls it (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch

from dogs_tpu_torch.core.gaussians import PARAM_NAMES, GaussianParams
from dogs_tpu_torch.core.sh import C0
from dogs_tpu_torch.data.ply import read_ply, write_ply, write_point_cloud


def _alive_arrays(params: GaussianParams, alive: torch.Tensor | None = None) -> tuple[np.ndarray, ...]:
    """The six parameter arrays of the alive slots, in PARAM_NAMES order."""
    mask = np.ones(params.capacity, bool) if alive is None else alive.detach().cpu().numpy()
    return tuple(getattr(params, k).detach().cpu().numpy()[mask] for k in PARAM_NAMES)


def save_gaussian_ply(path: str, params: GaussianParams, alive: torch.Tensor | None = None) -> None:
    """Standard 3DGS PLY layout (x y z nx ny nz f_dc_* f_rest_* opacity
    scale_* rot_*), consumable by every 3DGS viewer and tool."""
    xyz, fdc, frest, log_scale, quat, logit_op = _alive_arrays(params, alive)
    n = xyz.shape[0]
    props: dict[str, np.ndarray] = {
        "x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
        "nx": np.zeros(n), "ny": np.zeros(n), "nz": np.zeros(n),
    }
    for i in range(3):
        props[f"f_dc_{i}"] = fdc[:, 0, i]
    # 3DGS stores rest features channel-major: (3, K-1) flattened.
    rest = frest.transpose(0, 2, 1).reshape(n, -1)
    for i in range(rest.shape[1]):
        props[f"f_rest_{i}"] = rest[:, i]
    props["opacity"] = logit_op[:, 0]
    for i in range(3):
        props[f"scale_{i}"] = log_scale[:, i]
    for i in range(4):
        props[f"rot_{i}"] = quat[:, i]
    write_ply(path, props)


def load_gaussian_ply(path: str, device: torch.device | str = "cuda") -> GaussianParams:
    """Inverse of save_gaussian_ply: parameters on `device`, one slot per
    vertex."""
    p = read_ply(path)
    n = p["x"].shape[0]
    xyz = np.stack([p["x"], p["y"], p["z"]], -1).astype(np.float32)
    fdc = np.stack([p["f_dc_0"], p["f_dc_1"], p["f_dc_2"]], -1)[:, None, :]
    rest_names = sorted((k for k in p if k.startswith("f_rest_")), key=lambda s: int(s.split("_")[-1]))
    if rest_names:
        rest = np.stack([p[k] for k in rest_names], -1).astype(np.float32)
        rest = rest.reshape(n, 3, rest.shape[1] // 3).transpose(0, 2, 1)
    else:
        rest = np.zeros((n, 0, 3), np.float32)
    arrays = dict(
        xyz=xyz,
        feat_dc=fdc,
        feat_rest=rest,
        log_scale=np.stack([p["scale_0"], p["scale_1"], p["scale_2"]], -1),
        quat=np.stack([p[f"rot_{i}"] for i in range(4)], -1),
        logit_opacity=p["opacity"][:, None],
    )
    return GaussianParams(**{k: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)
                             for k, a in arrays.items()})


def save_splat(path: str, params: GaussianParams, alive: torch.Tensor | None = None) -> None:
    """antimatter15 .splat export (gaussian_splat_model.py:668-709)."""
    xyz, fdc, _, log_scale, quat, logit_op = _alive_arrays(params, alive)
    n = xyz.shape[0]
    scale = np.exp(log_scale)
    opacity = 1.0 / (1.0 + np.exp(-logit_op[:, 0]))
    order = np.argsort(-(scale.prod(axis=-1) * opacity))  # volume x opacity, descending

    rgb = np.clip(0.5 + C0 * fdc[:, 0, :], 0.0, 1.0)
    q = quat / np.maximum(np.linalg.norm(quat, axis=-1, keepdims=True), 1e-9)

    buf = np.empty((n, 32), np.uint8)
    buf[:, 0:12] = xyz[order].astype(np.float32).view(np.uint8).reshape(n, 12)
    buf[:, 12:24] = scale[order].astype(np.float32).view(np.uint8).reshape(n, 12)
    buf[:, 24:27] = np.clip(rgb[order] * 255.0, 0, 255).astype(np.uint8)
    buf[:, 27] = np.clip(opacity[order] * 255.0, 0, 255).astype(np.uint8)
    buf[:, 28:32] = np.clip(q[order] * 128.0 + 128.0, 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(buf.tobytes())


def load_splat(path: str) -> dict[str, np.ndarray]:
    """Parse a .splat file back: xyz, scale, rgba in [0, 1] and quat."""
    raw = np.fromfile(path, np.uint8).reshape(-1, 32)
    return {
        "xyz": raw[:, 0:12].copy().view(np.float32).reshape(-1, 3),
        "scale": raw[:, 12:24].copy().view(np.float32).reshape(-1, 3),
        "rgba": raw[:, 24:28].astype(np.float32) / 255.0,
        "quat": (raw[:, 28:32].astype(np.float32) - 128.0) / 128.0,
    }


def save_colmap_ply(path: str, params: GaussianParams, alive: torch.Tensor | None = None) -> None:
    """Point-cloud-only export (positions + DC colour),
    gaussian_splat_model.py:642-666."""
    xyz, fdc, *_ = _alive_arrays(params, alive)
    rgb = np.clip(0.5 + C0 * fdc[:, 0, :], 0.0, 1.0)
    write_point_cloud(path, xyz, rgb)
