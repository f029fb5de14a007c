"""Scene datasets. Only the spheric test trajectory is ported so far: the
rest of dogs_tpu/data/dataset.py (COLMAP scene loading and normalisation)
comes with the port's data slice (ROADMAP.md queue 1, item 4)."""

from __future__ import annotations

import numpy as np


def spheric_test_poses(n_poses: int, radius: float, height: float = -0.5) -> np.ndarray:
    """(n_poses, 4, 4) float64 camera-to-world matrices on a circle of
    `radius` at `height`, looking at the origin (dogs_tpu's copy of the
    reference's load_colmap.py:677-699 create_spheric_poses)."""
    c2ws = []
    for theta in np.linspace(0.0, 2.0 * np.pi, n_poses, endpoint=False):
        eye = np.array([radius * np.cos(theta), height, radius * np.sin(theta)])
        forward = -eye / np.linalg.norm(eye)
        up = np.array([0.0, -1.0, 0.0])
        right = np.cross(forward, up)
        right /= np.linalg.norm(right)
        down = np.cross(forward, right)
        c2w = np.eye(4)
        c2w[:3, :3] = np.stack([right, down, forward], axis=1)
        c2w[:3, 3] = eye
        c2ws.append(c2w)
    return np.stack(c2ws)
