"""Gaussian field export and import: 3DGS .ply, antimatter15 .splat, COLMAP ply.

Port of dogs_tpu/fields/io.py (the reference's gaussian_splat_model.py:616-709
save_ply / save_colmap_ply / save_splat and load_ply). The writers take the
port's `GaussianParams` and alive mask, bring them to the host with
`.detach().cpu().numpy()` and run dogs_tpu's numpy code on them, so the
files are byte-equal to dogs_tpu's for the same model. `.splat` feeds the
web viewer (webui/src/loaders/SplatLoader.js): 32 bytes per splat [pos
3xf32 | scale 3xf32 | rgba 4xu8 | quat 4xu8], sorted by volume x opacity,
largest first. `.ksplat` (`save_ksplat`, `load_ksplat`) is the viewer's
compressed distribution format (GaussianSplats3D, 24 bytes a splat),
written byte for byte as dogs_tpu writes it.
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


_KSPLAT_HEADER = 4096
_KSPLAT_SECTION_HEADER = 1024
_KSPLAT_BUCKET_SIZE = 256
_KSPLAT_BLOCK = 5.0
_KSPLAT_CSR = 32767  # compression scale range (level 1)


def save_ksplat(path: str, params: GaussianParams, alive: torch.Tensor | None = None) -> None:
    """GaussianSplats3D .ksplat export, compression level 1 (uint16
    bucket-relative centres, float16 scale and rotation, RGBA u8 colour,
    SH degree 0; webui/util/create-ksplat.js's format), dogs_tpu's bytes.
    One section; the splats are grouped into 256-splat buckets of 5.0-unit
    cells, full buckets before partial ones as SplatBuffer.getBucketIndex
    requires.

    dogs_tpu's defect is kept so that the bytes are equal (ROADMAP.md queue
    3): the section header's splatCount and storageSizeBytes stay 0."""
    xyz, fdc, _, log_scale, quat, logit_op = _alive_arrays(params, alive)
    n = xyz.shape[0]
    xyz = xyz.astype(np.float32)
    scale = np.exp(log_scale).astype(np.float32)
    opacity = 1.0 / (1.0 + np.exp(-logit_op[:, 0]))
    rgb = np.clip(0.5 + C0 * fdc[:, 0, :], 0.0, 1.0)
    q = quat / np.maximum(np.linalg.norm(quat, axis=-1, keepdims=True), 1e-9)

    # Cell = floor(xyz / block); each cell's splats split into <= 256-splat
    # buckets whose stored centre is the cell's, so every member's offset
    # fits the half-block uint16 range.
    cell = np.floor(xyz / _KSPLAT_BLOCK).astype(np.int64)
    _, cell_key = np.unique(cell, axis=0, return_inverse=True)
    cell_key = cell_key.reshape(-1)
    order0 = np.argsort(cell_key, kind="stable")
    full_idx, part_idx, full_centers, part_centers, part_lens = [], [], [], [], []
    i = 0
    while i < n:
        j = i
        while j < n and cell_key[order0[j]] == cell_key[order0[i]]:
            j += 1
        members = order0[i:j]
        center = (cell[members[0]] + 0.5) * _KSPLAT_BLOCK
        for k in range(0, len(members), _KSPLAT_BUCKET_SIZE):
            chunk = members[k:k + _KSPLAT_BUCKET_SIZE]
            if len(chunk) == _KSPLAT_BUCKET_SIZE:
                full_idx.append(chunk)
                full_centers.append(center)
            else:
                part_idx.append(chunk)
                part_centers.append(center)
                part_lens.append(len(chunk))
        i = j
    order = np.concatenate([np.concatenate(full_idx) if full_idx else np.empty(0, np.int64)]
                           + ([np.concatenate(part_idx)] if part_idx else [])).astype(np.int64)
    bucket_centers = np.asarray(full_centers + part_centers, np.float32).reshape(-1, 3)
    n_full, n_part = len(full_idx), len(part_idx)

    header = np.zeros(_KSPLAT_HEADER, np.uint8)
    h32, h16, hf = header.view(np.uint32), header.view(np.uint16), header.view(np.float32)
    header[0], header[1] = 0, 1  # version 0.1
    h32[1] = 1  # maxSectionCount
    h32[2] = 1  # sectionCount
    h32[3] = n  # maxSplatCount
    h32[4] = n  # splatCount
    h16[10] = 1  # compressionLevel
    hf[6:9] = xyz.mean(axis=0) if n else 0.0  # sceneCenter

    sec = np.zeros(_KSPLAT_SECTION_HEADER, np.uint8)
    s32, s16, sf = sec.view(np.uint32), sec.view(np.uint16), sec.view(np.float32)
    s32[1] = n  # maxSplatCount
    s32[2] = _KSPLAT_BUCKET_SIZE
    s32[3] = n_full + n_part  # bucketCount
    sf[4] = _KSPLAT_BLOCK
    s16[10] = 12  # bucketStorageSizeBytes (3 x f32)
    s32[6] = _KSPLAT_CSR
    s32[8] = n_full
    s32[9] = n_part
    s16[20] = 0  # sphericalHarmonicsDegree

    # Per-splat records (24 B): [cx cy cz u16 | sx sy sz f16 | qw qx qy qz f16 | r g b a u8]
    csf = (_KSPLAT_BLOCK / 2.0) / _KSPLAT_CSR
    bucket_of = np.repeat(np.arange(n_full + n_part), [len(c) for c in full_idx + part_idx]).astype(np.int64)
    rel = xyz[order] - bucket_centers[bucket_of]
    c16 = np.clip(np.round(rel / csf) + _KSPLAT_CSR, 0, 65535).astype(np.uint16)
    rec = np.zeros((n, 24), np.uint8)
    rec[:, 0:6] = c16.view(np.uint8).reshape(n, 6)
    rec[:, 6:12] = scale[order].astype(np.float16).view(np.uint8).reshape(n, 6)
    rec[:, 12:20] = q[order].astype(np.float16).view(np.uint8).reshape(n, 8)  # (w, x, y, z)
    rec[:, 20:23] = np.clip(rgb[order] * 255.0, 0, 255).astype(np.uint8)
    rec[:, 23] = np.clip(opacity[order] * 255.0, 0, 255).astype(np.uint8)

    with open(path, "wb") as f:
        f.write(header.tobytes())
        f.write(sec.tobytes())
        f.write(np.asarray(part_lens, np.uint32).tobytes())
        f.write(bucket_centers.tobytes())
        f.write(rec.tobytes())


def load_ksplat(path: str) -> dict[str, np.ndarray]:
    """Parse a level-0 or level-1, SH degree 0 .ksplat back: xyz, scale,
    quat (w, x, y, z) and rgba in [0, 1] (the viewer's ksplatToSplat
    decode in numpy)."""
    raw = np.fromfile(path, np.uint8)
    h32, h16 = raw[:_KSPLAT_HEADER].view(np.uint32), raw[:_KSPLAT_HEADER].view(np.uint16)
    max_sections, sections, total, lvl = int(h32[1]), int(h32[2]), int(h32[4]), int(h16[10])
    if lvl not in (0, 1):
        raise ValueError(f"{path}: compression level {lvl}; load_ksplat reads levels 0 and 1")
    out_xyz = np.empty((total, 3), np.float32)
    out_scale = np.empty((total, 3), np.float32)
    out_quat = np.empty((total, 4), np.float32)
    out_rgba = np.empty((total, 4), np.float32)
    base = _KSPLAT_HEADER + max_sections * _KSPLAT_SECTION_HEADER
    o = 0
    for s in range(sections):
        sh = raw[_KSPLAT_HEADER + s * _KSPLAT_SECTION_HEADER:][:_KSPLAT_SECTION_HEADER]
        s32, s16, sfl = sh.view(np.uint32), sh.view(np.uint16), sh.view(np.float32)
        max_splat, bucket_size, bucket_count = int(s32[1]), int(s32[2]), int(s32[3])
        block, bucket_bytes = float(sfl[4]), int(s16[10])
        csr = int(s32[6]) or (_KSPLAT_CSR if lvl else 1)
        n_full, n_part, sh_deg = int(s32[8]), int(s32[9]), int(s16[20])
        if sh_deg != 0:
            raise ValueError(f"{path}: section {s} has SH degree {sh_deg}; load_ksplat reads degree 0")
        bps = 44 if lvl == 0 else 24
        meta = raw[base:base + n_part * 4].view(np.uint32)
        bstart = base + n_part * 4
        centers = raw[bstart:bstart + bucket_bytes * bucket_count].view(np.float32).reshape(-1, 3)
        dstart = bstart + bucket_bytes * bucket_count
        n_here = min(max_splat, total - o)
        rec = raw[dstart:dstart + bps * max_splat].reshape(max_splat, bps)[:n_here]
        if lvl == 0:
            out_xyz[o:o + n_here] = rec[:, 0:12].copy().view(np.float32)
            out_scale[o:o + n_here] = rec[:, 12:24].copy().view(np.float32)
            wxyz = rec[:, 24:40].copy().view(np.float32)
            out_rgba[o:o + n_here] = rec[:, 40:44].astype(np.float32) / 255.0
        else:
            lens = ([bucket_size] * n_full) + list(meta)
            bucket_of = np.repeat(np.arange(len(lens)), lens)[:n_here]
            c16 = rec[:, 0:6].copy().view(np.uint16).astype(np.float32)
            csf = (block / 2.0) / csr
            out_xyz[o:o + n_here] = (c16 - csr) * csf + centers[bucket_of]
            out_scale[o:o + n_here] = rec[:, 6:12].copy().view(np.float16)
            wxyz = rec[:, 12:20].copy().view(np.float16).astype(np.float32)
            out_rgba[o:o + n_here] = rec[:, 20:24].astype(np.float32) / 255.0
        out_quat[o:o + n_here] = wxyz.reshape(n_here, 4)
        o += n_here
        base += n_part * 4 + bucket_bytes * bucket_count + bps * max_splat
    return {"xyz": out_xyz, "scale": out_scale, "quat": out_quat, "rgba": out_rgba}


def save_colmap_ply(path: str, params: GaussianParams, alive: torch.Tensor | None = None) -> None:
    """Point-cloud-only export (positions + DC colour),
    gaussian_splat_model.py:642-666."""
    xyz, fdc, *_ = _alive_arrays(params, alive)
    rgb = np.clip(0.5 + C0 * fdc[:, 0, :], 0.0, 1.0)
    write_point_cloud(path, xyz, rgb)
