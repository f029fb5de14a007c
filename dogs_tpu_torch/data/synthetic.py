"""Synthetic Gaussian scenes for tests, the smoke run and benchmarks.

Port of dogs_tpu/data/synthetic.py plus the numpy body of bench.py's scenes
(`bench_scene`, `_bench_cameras`, the teacher of `_quality_scene`). Every array is drawn with numpy's
`RandomState` in the same order as the JAX package draws it, so a seed gives
the same pre-activation arrays in both packages (the `*_arrays` functions
return them, for feeding both sides of a parity test).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dogs_tpu_torch.core.camera import Camera, look_at_camera, make_camera
from dogs_tpu_torch.core.gaussians import GaussianParams, params_from_numpy
from dogs_tpu_torch.core.sh import C0
from dogs_tpu_torch.raster.tiled import RasterConfig, render_tiled

BENCH_WIDTH, BENCH_HEIGHT = 1152, 864  # bench.py's frame (factor-4 rubble)
BENCH_GAUSSIANS = 500_000


def _rgb_to_sh(rgb: np.ndarray) -> np.ndarray:
    return (rgb.astype(np.float32) - 0.5) / C0


def _logit(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float32)
    return np.log(x / (1.0 - x))


@dataclasses.dataclass
class SyntheticScene:
    gt_params: GaussianParams
    cameras: list[Camera]
    images: list[torch.Tensor]  # (H, W, 3) float32 in [0, 1]
    points: np.ndarray  # noisy init point cloud (N, 3)
    colors: np.ndarray  # (N, 3)


def gt_params_arrays(n: int, seed: int, max_sh_degree: int = 2, spread: float = 1.0):
    rng = np.random.RandomState(seed)
    k = (max_sh_degree + 1) ** 2
    xyz = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    rgb = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    return dict(
        xyz=xyz,
        feat_dc=_rgb_to_sh(rgb)[:, None, :],
        feat_rest=rng.randn(n, k - 1, 3).astype(np.float32) * 0.02,
        log_scale=np.log(rng.uniform(0.08, 0.3, (n, 3))).astype(np.float32),
        quat=rng.randn(n, 4).astype(np.float32),
        logit_opacity=_logit(rng.uniform(0.4, 0.95, (n, 1))),
    )


def make_gt_params(
    n: int, seed: int, max_sh_degree: int = 2, spread: float = 1.0,
    device: torch.device | str = "cuda",
) -> GaussianParams:
    return params_from_numpy(gt_params_arrays(n, seed, max_sh_degree, spread), device)


def ring_cameras(
    n_cams: int, radius: float, width: int, height: int, focal: float,
    elevation: float = -0.8, device: torch.device | str = "cuda",
) -> list[Camera]:
    cams = []
    for i in range(n_cams):
        theta = 2.0 * np.pi * i / n_cams
        eye = np.array([radius * np.cos(theta), elevation, radius * np.sin(theta)])
        cams.append(
            look_at_camera(
                eye=eye, target=[0.0, 0.0, 0.0], up=[0.0, -1.0, 0.0],
                fx=focal, fy=focal, width=width, height=height, image_index=i,
                device=device,
            )
        )
    return cams


def make_scene(
    n_gaussians: int = 96,
    n_cams: int = 12,
    width: int = 96,
    height: int = 80,
    seed: int = 0,
    max_sh_degree: int = 2,
    raster_cfg: RasterConfig | None = None,
    device: torch.device | str = "cuda",
) -> SyntheticScene:
    cfg = raster_cfg or RasterConfig()
    gt = make_gt_params(n_gaussians, seed, max_sh_degree, device=device)
    cams = ring_cameras(
        n_cams, radius=4.0, width=width, height=height, focal=width * 0.9, device=device
    )
    with torch.no_grad():
        images = [render_tiled(gt, c, cfg, active_sh_degree=max_sh_degree).image for c in cams]
    rng = np.random.RandomState(seed + 1)
    xyz = gt.xyz.detach().cpu().numpy()
    points = xyz + rng.randn(n_gaussians, 3).astype(np.float32) * 0.05
    colors = np.clip(gt.feat_dc.detach().cpu().numpy()[:, 0, :] * C0 + 0.5, 0.0, 1.0)
    return SyntheticScene(gt_params=gt, cameras=cams, images=images, points=points, colors=colors)


def bench_scene_arrays(n: int, seed: int = 0) -> dict[str, np.ndarray]:
    """bench.py's scene: Gaussians filling the frustum of `bench_cameras`
    (z in [2, 10]) with ~2-4 px screen footprints, SH degree 3."""
    rng = np.random.RandomState(seed)
    xyz = np.stack(
        [rng.uniform(-4.0, 4.0, n), rng.uniform(-3.0, 3.0, n), rng.uniform(2.0, 10.0, n)], -1
    ).astype(np.float32)
    # Screen radius ~ scale * f / z; aim for ~2-4 px at f~1000.
    scale = (xyz[:, 2:3] / 1000.0) * rng.uniform(1.5, 4.0, (n, 1))
    return dict(
        xyz=xyz,
        feat_dc=_rgb_to_sh(rng.rand(n, 3))[:, None, :],
        feat_rest=np.zeros((n, 15, 3), np.float32),
        log_scale=np.log(np.repeat(scale, 3, 1)).astype(np.float32),
        quat=rng.randn(n, 4).astype(np.float32),
        logit_opacity=_logit(rng.uniform(0.3, 0.9, (n, 1))),
    )


def bench_scene(n: int = BENCH_GAUSSIANS, seed: int = 0, device: torch.device | str = "cuda"):
    return params_from_numpy(bench_scene_arrays(n, seed), device)


def quality_teacher_arrays(n_teacher: int) -> dict[str, np.ndarray]:
    """The teacher of bench.py's quality workload (`_quality_scene`), drawn
    from RandomState(7) in its order: a SURFACE, a bumpy ground plane
    (y = -1.4 + bumps, x and z in [-2.5, 2.5]) and a sphere shell of radius
    ~1.2, with smooth procedural colour (the sphere's by its normal), SH
    degree 3 with zero rest, splat scales of 2-6 px at 1152x864 / f 900 for
    200k points (scaled with the sampling density)."""
    rng_t = np.random.RandomState(7)
    n_pl = n_teacher // 2
    n_sp = n_teacher - n_pl
    px = rng_t.uniform(-2.5, 2.5, n_pl)
    pz = rng_t.uniform(-2.5, 2.5, n_pl)
    py = -1.4 + 0.15 * np.sin(2.3 * px) * np.cos(1.7 * pz)
    plane = np.stack([px, py, pz], -1)
    plane_rgb = np.stack(
        [
            0.5 + 0.4 * np.sin(3.1 * px) * np.sin(2.2 * pz),
            0.5 + 0.35 * np.cos(2.9 * pz),
            0.45 + 0.3 * np.sin(1.3 * px + 2.1 * pz),
        ],
        -1,
    )
    d = rng_t.randn(n_sp, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True) + 1e-9
    sphere = d * (1.2 + 0.05 * np.sin(5.0 * d[:, :1]) * np.cos(4.0 * d[:, 1:2]))
    sphere_rgb = 0.5 + 0.45 * d
    t_rgb = np.clip(np.concatenate([plane_rgb, sphere_rgb]), 0.02, 0.98)
    s_lo = 0.008 * np.sqrt(200_000 / n_teacher)
    return dict(
        xyz=np.concatenate([plane, sphere]).astype(np.float32),
        feat_dc=_rgb_to_sh(t_rgb)[:, None, :],
        feat_rest=np.zeros((n_teacher, 15, 3), np.float32),
        log_scale=np.log(rng_t.uniform(s_lo, s_lo * 3.1, (n_teacher, 3))).astype(np.float32),
        quat=rng_t.randn(n_teacher, 4).astype(np.float32),
        logit_opacity=_logit(rng_t.uniform(0.55, 0.95, (n_teacher, 1))),
    )


def bench_cameras(n_cams: int = 8, device: torch.device | str = "cuda", width: int = BENCH_WIDTH,
                  height: int = BENCH_HEIGHT) -> list[Camera]:
    """bench.py's cameras: looking into the scene box from slightly different
    angles (~±4.5 deg yaw), 1152x864, f = 1000; at another width the focal
    scales with it (the same field of view, for small test frames)."""
    focal = 1000.0 * width / BENCH_WIDTH
    cams = []
    for i in range(n_cams):
        a = (i - n_cams / 2) * 0.02
        b = ((i * 7) % n_cams - n_cams / 2) * 0.012
        ca, sa = np.cos(a), np.sin(a)
        cb, sb = np.cos(b), np.sin(b)
        ry = np.array([[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]])
        rx = np.array([[1, 0, 0], [0, cb, -sb], [0, sb, cb]])
        cams.append(
            make_camera(
                R=ry @ rx, t=np.zeros(3), fx=focal, fy=focal, cx=width / 2, cy=height / 2,
                width=width, height=height, image_index=i, device=device,
            )
        )
    return cams


# Small parity scenes (72x56 is not tile-aligned on purpose), drawn as the
# JAX test suite draws them (tests/test_tiled_render.py random_scene,
# tests/test_pallas_blend.py saturation case).
RANDOM_SCENE_VIEW = dict(
    eye=(0.3, -0.2, -4.0), target=(0.0, 0.0, 0.0), up=(0.0, -1.0, 0.0),
    fx=70.0, fy=70.0, width=72, height=56,
)
SATURATION_SCENE_VIEW = dict(
    eye=(0.0, 0.0, 0.0), target=(0.0, 0.0, 1.0), up=(0.0, -1.0, 0.0),
    fx=60.0, fy=60.0, width=64, height=64,
)


def random_scene_arrays(n: int = 64, seed: int = 0, max_sh_degree: int = 2, spread: float = 1.2):
    rng = np.random.RandomState(seed)
    k = (max_sh_degree + 1) ** 2
    xyz = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    rgb = rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    return dict(
        xyz=xyz,
        feat_dc=_rgb_to_sh(rgb)[:, None, :],
        feat_rest=rng.randn(n, k - 1, 3).astype(np.float32) * 0.05,
        log_scale=np.log(rng.uniform(0.05, 0.35, (n, 3))).astype(np.float32),
        quat=rng.randn(n, 4).astype(np.float32),
        logit_opacity=_logit(rng.uniform(0.2, 0.95, (n, 1))),
    )


def edge_scene_arrays(n: int = 3000, seed: int = 0, max_sh_degree: int = 3):
    """Gaussians for `RANDOM_SCENE_VIEW` that reach every branch of the
    preprocess: a tenth behind or at the near plane, a tenth far to the side
    (past the EWA's 1.3 tan clamp), raw unnormalized quaternions, scales and
    opacities from culled to large, SH coefficients of every degree."""
    rng = np.random.RandomState(seed)
    k = (max_sh_degree + 1) ** 2
    xyz = rng.uniform(-1.5, 1.5, (n, 3))
    xyz[: n // 10, 2] = rng.uniform(-5.5, -3.6, n // 10)
    xyz[n // 10: n // 5, 0] = rng.uniform(-8.0, 8.0, n // 5 - n // 10)
    return dict(
        xyz=xyz.astype(np.float32),
        feat_dc=(rng.randn(n, 1, 3) * 0.5).astype(np.float32),
        feat_rest=(rng.randn(n, k - 1, 3) * 0.3).astype(np.float32),
        log_scale=rng.uniform(-3.5, -1.0, (n, 3)).astype(np.float32),
        quat=rng.randn(n, 4).astype(np.float32),
        logit_opacity=rng.uniform(-3.0, 3.0, (n, 1)).astype(np.float32),
    )


def saturation_scene_arrays(n: int = 64, seed: int = 11):
    """Near-opaque overlapping Gaussians: tiles saturate early and tiny
    per-tile runs share chunk boundaries."""
    rng = np.random.RandomState(seed)
    xyz = np.concatenate(
        [rng.uniform(-0.6, 0.6, (n, 2)), rng.uniform(2.0, 2.5, (n, 1))], axis=1
    ).astype(np.float32)
    return dict(
        xyz=xyz,
        feat_dc=_rgb_to_sh(rng.rand(n, 3))[:, None, :],
        feat_rest=np.zeros((n, 8, 3), np.float32),
        log_scale=np.log(
            np.array([[0.3, 0.12, 0.2]]) * rng.uniform(0.8, 1.2, (n, 3))
        ).astype(np.float32),
        quat=rng.randn(n, 4).astype(np.float32),
        logit_opacity=_logit(np.full((n, 1), 0.97)),
    )
