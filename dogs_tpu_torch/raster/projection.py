"""Per-Gaussian rasterization preprocess: project, EWA, conic, color.

Port of dogs_tpu/raster/projection.py (the reference CUDA `preprocessCUDA`,
forward.cu:157-276): frustum cull, 3D covariance from quat/scale, EWA
projection with the 0.3 px low-pass and the optional antialiasing opacity
rescale, conic, 3-sigma radius, and SH -> RGB. Plain elementwise torch over
all (padded) Gaussians; no matmul, so no TF32 setting can reach it.
"""

from __future__ import annotations

import dataclasses

import torch

from dogs_tpu_torch.core.camera import Camera
from dogs_tpu_torch.core.gaussians import GaussianParams, NeuralGaussians
from dogs_tpu_torch.core.sh import eval_sh
from dogs_tpu_torch.core.transforms import covariance_sym6

LOW_PASS_FILTER = 0.3
NEAR_PLANE = 0.2
ALPHA_MIN = 1.0 / 255.0


@dataclasses.dataclass
class ProjectedGaussians:
    """Screen-space Gaussians ready for binning + blending. All (C, ...)."""

    means2d: torch.Tensor  # (C, 2) pixel coords
    depth: torch.Tensor  # (C,) camera-space z
    conic: torch.Tensor  # (C, 3) inverse 2D covariance (a, b, c)
    color: torch.Tensor  # (C, 3) view-dependent RGB (>= 0)
    opacity: torch.Tensor  # (C,) post-antialiasing opacity
    radius: torch.Tensor  # (C,) 3-sigma screen radius in pixels (0 = culled)


def compute_cov2d(cov3d, p_cam, fx, fy, tan_fovx, tan_fovy, R_w2c):
    """EWA projection of the 3D covariance to screen space, BEFORE the
    low-pass blur. Returns the (a, b, c) entries of the symmetric 2x2."""
    z = p_cam[..., 2]
    limx = 1.3 * tan_fovx
    limy = 1.3 * tan_fovy
    txtz = torch.clamp(p_cam[..., 0] / z, -limx, limx)
    tytz = torch.clamp(p_cam[..., 1] / z, -limy, limy)

    inv_z = 1.0 / z
    j00 = fx * inv_z
    j02 = -fx * txtz * inv_z
    j11 = fy * inv_z
    j12 = -fy * tytz * inv_z

    # T = J @ W, rows t0 (from j00, j02) and t1 (from j11, j12); W = R_w2c.
    w0, w1, w2 = R_w2c[0], R_w2c[1], R_w2c[2]
    t0 = j00[:, None] * w0 + j02[:, None] * w2  # (C, 3)
    t1 = j11[:, None] * w1 + j12[:, None] * w2  # (C, 3)

    s11, s12, s13, s22, s23, s33 = cov3d

    def quad(u, v):
        # u . Sigma . v with symmetric Sigma in 6-component form.
        return (
            u[:, 0] * v[:, 0] * s11
            + u[:, 1] * v[:, 1] * s22
            + u[:, 2] * v[:, 2] * s33
            + (u[:, 0] * v[:, 1] + u[:, 1] * v[:, 0]) * s12
            + (u[:, 0] * v[:, 2] + u[:, 2] * v[:, 0]) * s13
            + (u[:, 1] * v[:, 2] + u[:, 2] * v[:, 1]) * s23
        )

    return quad(t0, t0), quad(t0, t1), quad(t1, t1)


def project_gaussians(
    params: GaussianParams | NeuralGaussians,
    camera: Camera,
    alive: torch.Tensor | None = None,
    active_sh_degree: int = 3,
    antialiasing: bool = False,
    scale_modifier: float = 1.0,
    means2d_offset: torch.Tensor | None = None,
    color_override: torch.Tensor | None = None,
) -> ProjectedGaussians:
    """Vectorized preprocess over all (padded) Gaussians. Reads `params`'
    xyz, scale, quat and opacity (and features without `color_override`),
    so decoded `NeuralGaussians` keep their graph.

    Args:
      alive: (C,) bool mask of live Gaussians (padding slots get radius 0).
      active_sh_degree: SH degree evaluated for the view-dependent color.
      antialiasing: Mip-Splatting opacity rescale sqrt(det(cov)/det(cov+blur)).
      scale_modifier: global scale multiplier.
      means2d_offset: optional (C, 2) added to the screen positions.
      color_override: optional (C, 3) precomputed colors instead of SH.
    """
    xyz = params.xyz
    R = camera.R
    # x_cam = R @ x + t, written as sums so it is exact f32 on every device.
    p_cam = (
        xyz[:, 0:1] * R[:, 0] + xyz[:, 1:2] * R[:, 1] + xyz[:, 2:3] * R[:, 2] + camera.t
    )
    z = p_cam[..., 2]
    in_front = z > NEAR_PLANE
    zsafe = torch.where(in_front, z, torch.ones_like(z))

    u = camera.fx * p_cam[..., 0] / zsafe + camera.cx
    v = camera.fy * p_cam[..., 1] / zsafe + camera.cy
    means2d = torch.stack([u, v], dim=-1)
    if means2d_offset is not None:
        means2d = means2d + means2d_offset

    scale = params.scale * scale_modifier
    cov3d = covariance_sym6(scale, params.quat)
    p_cam_safe = torch.where(in_front[:, None], p_cam, torch.ones_like(p_cam))
    ra, rb, rc = compute_cov2d(
        cov3d, p_cam_safe, camera.fx, camera.fy,
        camera.tan_half_fov_x, camera.tan_half_fov_y, R,
    )
    a = ra + LOW_PASS_FILTER
    b = rb
    c = rc + LOW_PASS_FILTER
    det = a * c - b * b
    det_safe = torch.where(det > 0.0, det, torch.ones_like(det))
    inv_det = 1.0 / det_safe
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)

    opacity = params.opacity[..., 0]
    if antialiasing:
        det_raw = ra * rc - rb**2
        h_factor = torch.sqrt(torch.clamp(det_raw / det_safe, min=0.0) + 1e-12)
        opacity = opacity * h_factor

    # 3-sigma extent from the larger eigenvalue (forward.cu:231-238).
    mid = 0.5 * (a + c)
    lam_max = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam_max))

    visible = in_front & (det > 0.0) & (opacity > ALPHA_MIN)
    if alive is not None:
        visible = visible & alive
    radius = torch.where(visible, radius, torch.zeros_like(radius))

    if color_override is not None:
        color = torch.clamp(color_override, min=0.0)
    else:
        dirs = xyz - camera.camera_center
        dirs = dirs / torch.clamp(
            torch.linalg.vector_norm(dirs, dim=-1, keepdim=True), min=1e-12
        )
        color = torch.clamp(eval_sh(active_sh_degree, params.features, dirs) + 0.5, min=0.0)

    return ProjectedGaussians(
        means2d=means2d, depth=z, conic=conic, color=color, opacity=opacity, radius=radius
    )


def gaussian_alpha(conic: torch.Tensor, opacity: torch.Tensor, means2d: torch.Tensor,
                   pixel_xy: torch.Tensor) -> torch.Tensor:
    """Per-(Gaussian, pixel) alpha of the blend's inner loop. Shapes
    broadcast: conic (..., 3), opacity (...,), means2d (..., 2), pixel_xy
    (..., 2) -> alpha (...,), clamped to <= 0.99 and to 0 below 1/255."""
    d = pixel_xy - means2d
    power = -0.5 * (conic[..., 0] * d[..., 0] * d[..., 0] + conic[..., 2] * d[..., 1] * d[..., 1]) \
        - conic[..., 1] * d[..., 0] * d[..., 1]
    alpha = torch.clamp(opacity * torch.exp(torch.clamp(power, max=0.0)), max=0.99)
    return torch.where(alpha < ALPHA_MIN, 0.0, alpha)
