"""Trajectory alignment: Umeyama sim(3), ATE, yaw-only alignment.

Port of dogs_tpu/core/align.py (the reference's
conerf/geometry/align_poses.py:1-191), numpy only, as there: the similarity
transform between two camera trajectories (for pose-refinement
evaluation), applied to a third, and the absolute trajectory error.
"""

from __future__ import annotations

import numpy as np


def convert3x4_4x4(mats: np.ndarray) -> np.ndarray:
    """(N, 3, 4) or (3, 4) -> homogeneous (N, 4, 4) / (4, 4)."""
    mats = np.asarray(mats)
    if mats.ndim == 3:
        bottom = np.zeros_like(mats[:, 0:1])
        out = np.concatenate([mats, bottom], axis=1)
        out[:, 3, 3] = 1.0
        return out
    out = np.concatenate([mats, np.array([[0, 0, 0, 1]], mats.dtype)], axis=0)
    out[3, 3] = 1.0
    return out


def align_umeyama(
    model: np.ndarray, data: np.ndarray, known_scale: bool = False
) -> tuple[float, np.ndarray, np.ndarray]:
    """Umeyama 1991 least-squares sim(3): model ≈ s * R @ data + t.

    Returns (s, R (3,3), t (3,)). (align_poses.py:72-118)"""
    model = np.asarray(model, np.float64)
    data = np.asarray(data, np.float64)
    mu_m = model.mean(0)
    mu_d = data.mean(0)
    mz = model - mu_m
    dz = data - mu_d
    n = model.shape[0]

    c = (mz.T @ dz) / n
    sigma2 = (dz * dz).sum() / n
    u, d, vt = np.linalg.svd(c)
    s_mat = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt.T) < 0:
        s_mat[2, 2] = -1
    rot = u @ s_mat @ vt
    s = 1.0 if known_scale else float(np.trace(np.diag(d) @ s_mat) / sigma2)
    t = mu_m - s * rot @ mu_d
    return s, rot, t


def get_best_yaw(c: np.ndarray) -> float:
    """Rotation about z maximizing trace(Rz(theta) @ C)
    (align_poses.py:60-70)."""
    if c.shape != (3, 3):
        raise ValueError(f"get_best_yaw takes a (3, 3) matrix, got {c.shape}")
    a = c[0, 1] - c[1, 0]
    b = c[0, 0] + c[1, 1]
    return float(np.pi / 2 - np.arctan2(b, a))


def align_sim3(
    p_es: np.ndarray, p_gt: np.ndarray, n_aligned: int = -1
) -> tuple[float, np.ndarray, np.ndarray]:
    """s, R, t with gt ≈ R * s * est + t (align_poses.py:130-144)."""
    idx = slice(None) if n_aligned == -1 else slice(0, n_aligned)
    try:
        return align_umeyama(
            np.asarray(p_gt)[idx, :3], np.asarray(p_es)[idx, :3]
        )
    except np.linalg.LinAlgError:
        return 1.0, np.eye(3), np.zeros(3)


def align_ate_c2b_use_a2b(
    traj_a: np.ndarray, traj_b: np.ndarray, traj_c: np.ndarray | None = None
) -> tuple[np.ndarray, float, np.ndarray, np.ndarray]:
    """Align trajectory c to b using the sim3 estimated from a -> b
    (align_poses.py:147-191). Trajectories are camera-to-world (N, 3/4, 4).

    Returns (aligned c (N, 4, 4), s, R, t)."""
    traj_a = np.asarray(traj_a, np.float64)
    traj_b = np.asarray(traj_b, np.float64)
    if traj_c is None:
        traj_c = traj_a.copy()
    traj_c = np.asarray(traj_c, np.float64)

    s, rot, t = align_sim3(traj_a[:, :3, 3], traj_b[:, :3, 3])
    r_c = rot[None] @ traj_c[:, :3, :3]
    t_c = s * (rot[None] @ traj_c[:, :3, 3:4]) + t[None, :, None]
    aligned = convert3x4_4x4(np.concatenate([r_c, t_c], axis=2))
    return aligned.astype(np.float32), float(s), rot, t


def absolute_trajectory_error(
    traj_est: np.ndarray, traj_gt: np.ndarray, align: bool = True
) -> dict:
    """RMSE/mean/median ATE of camera centers, optionally after sim(3)
    alignment — the standard pose-refinement metric."""
    est = np.asarray(traj_est, np.float64)
    gt = np.asarray(traj_gt, np.float64)
    if align:
        est = np.asarray(align_ate_c2b_use_a2b(est, gt)[0], np.float64)
    err = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=-1)
    return {
        "ate_rmse": float(np.sqrt((err**2).mean())),
        "ate_mean": float(err.mean()),
        "ate_median": float(np.median(err)),
    }
