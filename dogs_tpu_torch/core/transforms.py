"""Quaternion / covariance math needed by projection.

Port of the projection subset of dogs_tpu/core/transforms.py. Quaternions
are (w, x, y, z), normalized at point of use; scales are linear (post-exp).
Everything is written elementwise, so no matmul precision flag applies.
"""

from __future__ import annotations

import torch


def normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize along the last axis."""
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternion -> (..., 3, 3) rotation matrix."""
    q = normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = (
        (1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - w * z), 2.0 * (x * z + w * y)),
        (2.0 * (x * y + w * z), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z - w * x)),
        (2.0 * (x * z - w * y), 2.0 * (y * z + w * x), 1.0 - 2.0 * (x * x + y * y)),
    )
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def covariance_sym6(scale: torch.Tensor, quat: torch.Tensor) -> tuple:
    """Sigma = R S S^T R^T as its 6 unique components (s11, s12, s13, s22,
    s23, s33), each (...,)."""
    q = normalize(quat)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    sx, sy, sz = scale[..., 0], scale[..., 1], scale[..., 2]
    m00 = (1.0 - 2.0 * (y * y + z * z)) * sx
    m01 = (2.0 * (x * y - w * z)) * sy
    m02 = (2.0 * (x * z + w * y)) * sz
    m10 = (2.0 * (x * y + w * z)) * sx
    m11 = (1.0 - 2.0 * (x * x + z * z)) * sy
    m12 = (2.0 * (y * z - w * x)) * sz
    m20 = (2.0 * (x * z - w * y)) * sx
    m21 = (2.0 * (y * z + w * x)) * sy
    m22 = (1.0 - 2.0 * (x * x + y * y)) * sz
    s11 = m00 * m00 + m01 * m01 + m02 * m02
    s12 = m00 * m10 + m01 * m11 + m02 * m12
    s13 = m00 * m20 + m01 * m21 + m02 * m22
    s22 = m10 * m10 + m11 * m11 + m12 * m12
    s23 = m10 * m20 + m11 * m21 + m12 * m22
    s33 = m20 * m20 + m21 * m21 + m22 * m22
    return s11, s12, s13, s22, s23, s33
