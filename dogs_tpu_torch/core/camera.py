"""Pinhole camera as a dataclass of tensors.

Port of dogs_tpu/core/camera.py. Convention: COLMAP world-to-camera,
x_cam = R @ x_world + t, +z looking forward, y down. Pose math runs in
float64 numpy and is cast to float32 once, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Camera:
    """Tensor fields are float32 on one device; width/height are ints."""

    R: torch.Tensor  # (3, 3) world->camera rotation
    t: torch.Tensor  # (3,) world->camera translation
    fx: torch.Tensor  # () focal, pixels
    fy: torch.Tensor
    cx: torch.Tensor  # () principal point, pixels
    cy: torch.Tensor
    width: int
    height: int
    near: float = 0.01
    far: float = 100.0
    image_index: int = 0

    @property
    def camera_center(self) -> torch.Tensor:
        """Camera origin in world coordinates, -R^T t (elementwise sums)."""
        return -(self.R * self.t[:, None]).sum(dim=0)

    @property
    def world_to_camera(self) -> torch.Tensor:
        """(4, 4) view matrix."""
        m = torch.eye(4, dtype=self.R.dtype, device=self.R.device)
        m[:3, :3] = self.R
        m[:3, 3] = self.t
        return m

    @property
    def camera_to_world(self) -> torch.Tensor:
        """(4, 4) inverse of the view matrix: [R^T | camera_center]."""
        m = torch.eye(4, dtype=self.R.dtype, device=self.R.device)
        m[:3, :3] = self.R.T
        m[:3, 3] = self.camera_center
        return m

    @property
    def tan_half_fov_x(self) -> torch.Tensor:
        return 0.5 * self.width / self.fx

    @property
    def tan_half_fov_y(self) -> torch.Tensor:
        return 0.5 * self.height / self.fy

    def downsample(self, factor: float) -> "Camera":
        """Rescaled copy for the coarse-to-fine schedule: round(size /
        factor) pixels in each axis (at least 1), the intrinsics scaled by
        new / old in that axis; pose, near, far and image_index kept."""
        new_w = max(int(round(self.width / factor)), 1)
        new_h = max(int(round(self.height / factor)), 1)
        sx, sy = new_w / self.width, new_h / self.height
        return dataclasses.replace(self, fx=self.fx * sx, fy=self.fy * sy, cx=self.cx * sx, cy=self.cy * sy,
                                   width=new_w, height=new_h)

    def project(self, xyz_world: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """World points (..., 3) -> pixel coordinates (..., 2) and camera
        depth (...,), with R applied as elementwise products and sums."""
        p_cam = (xyz_world[..., None, :] * self.R).sum(dim=-1) + self.t
        z = p_cam[..., 2]
        u = self.fx * p_cam[..., 0] / z + self.cx
        v = self.fy * p_cam[..., 1] / z + self.cy
        return torch.stack([u, v], dim=-1), z


def make_camera(
    R: np.ndarray,
    t: np.ndarray,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    width: int,
    height: int,
    image_index: int = 0,
    near: float = 0.01,
    far: float = 100.0,
    device: torch.device | str = "cuda",
) -> Camera:
    """Build a Camera from host-side numpy/pose data (cast to float32)."""

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float64).astype(np.float32), device=device)

    return Camera(
        R=f32(R), t=f32(t), fx=f32(fx), fy=f32(fy), cx=f32(cx), cy=f32(cy),
        width=int(width), height=int(height), near=near, far=far,
        image_index=int(image_index),
    )


def look_at_camera(
    eye,
    target,
    up,
    fx: float,
    fy: float,
    width: int,
    height: int,
    **kwargs,
) -> Camera:
    """Convenience constructor for synthetic scenes."""
    eye = np.asarray(eye, np.float64)
    forward = np.asarray(target, np.float64) - eye
    forward /= np.linalg.norm(forward)
    right = np.cross(forward, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    down = np.cross(forward, right)
    R_c2w = np.stack([right, down, forward], axis=1)  # columns = camera axes in world
    R = R_c2w.T
    t = -R @ eye
    return make_camera(R, t, fx, fy, width / 2.0, height / 2.0, width, height, **kwargs)
