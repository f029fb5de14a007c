"""Quaternion / covariance math needed by projection, and the SO(3) / SE(3)
exponentials of pose refinement.

Port of the projection and pose subset of dogs_tpu/core/transforms.py.
Quaternions are (w, x, y, z), normalized at point of use; scales are linear
(post-exp). Everything is written elementwise, so no matmul precision flag
applies.
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


def skew(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix [w]x."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [torch.stack([zero, -wz, wy], -1), torch.stack([wz, zero, -wx], -1), torch.stack([-wy, wx, zero], -1)],
        -2,
    )


def matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3, k) as elementwise products and sums: exact f32
    on every device, where a matmul may run in TF32."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) axis-angle -> (..., 3, 3) rotation, in the sinc form
    R = I + a [w]x + b [w]x^2 with series branches below theta^2 = 1e-8.
    Pose deltas start at zero, where the naive normalize-then-rotate form
    has NaN gradients: both branches of each `where` are finite with finite
    gradients there, because every division uses the branch-switched
    denominator."""
    theta_sq = torch.sum(w * w, dim=-1, keepdim=True)
    small = theta_sq < 1e-8
    theta_sq_safe = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(theta_sq_safe)
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(theta)) / theta_sq_safe)
    K = skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + a[..., None] * K + b[..., None] * matmul3(K, K)


def se3_exp(xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., 6) twist [rho, w] -> (R (..., 3, 3), t (..., 3)) with the
    first-order translation t = rho (enough for the small corrections of
    camera refinement, whose deltas start at zero)."""
    return so3_exp(xi[..., 3:6]), xi[..., 0:3]


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> (..., 4) unit wxyz quaternion, in
    dogs_tpu's branch-free Shepperd form: all four candidates are computed
    and the largest pivot is selected (the trace, else the largest diagonal
    entry). The arithmetic is dogs_tpu's on XLA's CPU, rounding for
    rounding, so that the converters write dogs_tpu's bytes: square roots
    correctly rounded (taken in float64; PyTorch's vectorized float32 sqrt
    on the CPU is not), and the final norm's sum of squares as sequential
    fused multiply-adds, as XLA fuses `jnp.linalg.norm`."""

    def sqrt(v):
        return torch.sqrt(v.double()).to(v.dtype)

    def fma_sum_sq(q):
        d = q.double()
        acc = d[..., 0] * d[..., 0]
        for k in range(1, 4):
            acc = (d[..., k] * d[..., k] + acc.to(q.dtype).double())
        return acc.to(q.dtype)

    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def pivot(v):
        return sqrt(torch.clamp(v, min=1e-12)) * 2.0

    s = pivot(tr + 1.0)
    qw = torch.stack([0.25 * s, (m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s], -1)
    s = pivot(1.0 + m00 - m11 - m22)
    qx = torch.stack([(m21 - m12) / s, 0.25 * s, (m01 + m10) / s, (m02 + m20) / s], -1)
    s = pivot(1.0 + m11 - m00 - m22)
    qy = torch.stack([(m02 - m20) / s, (m01 + m10) / s, 0.25 * s, (m12 + m21) / s], -1)
    s = pivot(1.0 + m22 - m00 - m11)
    qz = torch.stack([(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s, 0.25 * s], -1)
    use_w = tr > 0.0
    use_x = ~use_w & (m00 >= m11) & (m00 >= m22)
    use_y = ~use_w & ~use_x & (m11 >= m22)
    q = torch.where(use_w[..., None], qw, torch.where(use_x[..., None], qx, torch.where(use_y[..., None], qy, qz)))
    return q / torch.clamp(sqrt(fma_sum_sq(q))[..., None], min=1e-12)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of wxyz quaternions."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors (..., 3) by wxyz quaternions (..., 4)."""
    return matmul3(quat_to_rotmat(q), v[..., None])[..., 0]


def build_covariance_3d(scale: torch.Tensor, quat: torch.Tensor) -> torch.Tensor:
    """Sigma = R S S^T R^T as the full (..., 3, 3) symmetric matrix."""
    M = quat_to_rotmat(quat) * scale[..., None, :]  # R @ diag(s)
    return matmul3(M, M.transpose(-1, -2))


def covariance_to_symmetric6(cov: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 6) upper-triangular strip (s11, s12, s13, s22, s23, s33)."""
    return torch.stack([cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2], cov[..., 1, 1], cov[..., 1, 2],
                        cov[..., 2, 2]], dim=-1)


def symmetric6_to_covariance(six: torch.Tensor) -> torch.Tensor:
    """(..., 6) strip -> (..., 3, 3) symmetric matrix."""
    a, b, c, d, e, f = six.unbind(-1)
    return torch.stack([torch.stack([a, b, c], -1), torch.stack([b, d, e], -1), torch.stack([c, e, f], -1)], -2)
