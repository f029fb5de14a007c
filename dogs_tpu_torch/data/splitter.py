"""Clustering-based scene splitting: KMeans / Spectral variants.

The port's own copy of dogs_tpu/data/splitter.py (numpy only, the same
seeds and the same arithmetic, so both packages label a scene alike): the
reference SceneSplitter (conerf/datasets/scene_spliter.py:12-69) and its
clustering backend (conerf/geometry/cluster.py `clustering`) split a COLMAP
reconstruction into blocks by clustering camera centers or sparse 3D
points. kmeans++-seeded Lloyd iterations; spectral = k-NN affinity graph ->
normalized-Laplacian eigenvectors -> kmeans in the embedding. Small
host-side problems: nothing here runs on the device.
"""

from __future__ import annotations

import os

import numpy as np


def kmeans(
    points: np.ndarray,
    num_clusters: int,
    seed: int = 0,
    num_iters: int = 100,
    tol: float = 1e-6,
) -> tuple[np.ndarray, np.ndarray]:
    """Lloyd's algorithm with kmeans++ seeding.

    Returns (labels (N,), centers (K, D))."""
    pts = np.asarray(points, np.float64)
    n = pts.shape[0]
    k = min(num_clusters, n)
    rng = np.random.RandomState(seed)

    # kmeans++ seeding
    centers = np.empty((k, pts.shape[1]))
    centers[0] = pts[rng.randint(n)]
    d2 = ((pts - centers[0]) ** 2).sum(-1)
    for i in range(1, k):
        probs = d2 / max(d2.sum(), 1e-12)
        centers[i] = pts[rng.choice(n, p=probs)]
        d2 = np.minimum(d2, ((pts - centers[i]) ** 2).sum(-1))

    labels = np.zeros((n,), np.int32)
    for _ in range(num_iters):
        dist = ((pts[:, None, :] - centers[None]) ** 2).sum(-1)  # (N, K)
        labels = dist.argmin(1).astype(np.int32)
        new_centers = centers.copy()
        for j in range(k):
            mask = labels == j
            if mask.any():
                new_centers[j] = pts[mask].mean(0)
            else:  # re-seed empty cluster at the farthest point
                new_centers[j] = pts[dist.min(1).argmax()]
        shift = np.abs(new_centers - centers).max()
        centers = new_centers
        if shift < tol:
            break
    return labels, centers.astype(np.float32)


def spectral_clustering(
    points: np.ndarray,
    num_clusters: int,
    n_neighbors: int = 10,
    seed: int = 0,
) -> np.ndarray:
    """Normalized-cut spectral clustering on a symmetrized k-NN graph."""
    pts = np.asarray(points, np.float64)
    n = pts.shape[0]
    k = min(num_clusters, n)
    nn = min(n_neighbors, n - 1)
    d2 = ((pts[:, None, :] - pts[None]) ** 2).sum(-1)
    sigma2 = max(np.median(d2[d2 > 0]), 1e-12)
    # k-NN adjacency (symmetrized), gaussian affinity
    idx = np.argsort(d2, axis=1)[:, 1 : nn + 1]
    w = np.zeros((n, n))
    rows = np.repeat(np.arange(n), nn)
    cols = idx.reshape(-1)
    w[rows, cols] = np.exp(-d2[rows, cols] / sigma2)
    w = np.maximum(w, w.T)
    deg = w.sum(1)
    d_inv_sqrt = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
    lap = np.eye(n) - d_inv_sqrt[:, None] * w * d_inv_sqrt[None, :]
    vals, vecs = np.linalg.eigh(lap)
    emb = vecs[:, :k]
    emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
    labels, _ = kmeans(emb, k, seed=seed)
    return labels


def clustering(
    points: np.ndarray, num_clusters: int, method: str = "KMeans", seed: int = 0
) -> np.ndarray:
    """Dispatch matching conerf/geometry/cluster.py `clustering`."""
    if method.lower() == "kmeans":
        labels, _ = kmeans(points, num_clusters, seed=seed)
        return labels
    if method.lower() == "spectral":
        return spectral_clustering(points, num_clusters, seed=seed)
    raise ValueError(f"unknown clustering method {method!r}")


class SceneSplitter:
    """Split a scene by camera poses or sparse points
    (scene_spliter.py:12-69). `point3d_image_ids` maps each 3D point index
    to the image indices observing it (for split_type='point')."""

    def __init__(self, point3d_image_ids: list[np.ndarray] | None = None):
        self.point3d_image_ids = point3d_image_ids

    def split(
        self,
        camtoworlds: np.ndarray | None = None,
        points3d: np.ndarray | None = None,
        split_type: str = "camera",
        num_blocks: int = 1,
        method: str = "KMeans",
        save_dir: str = "",
        seed: int = 0,
    ) -> dict[int, int]:
        if split_type == "camera":
            centers = np.asarray(camtoworlds)[..., :3, -1]
            labels_arr = clustering(centers, num_blocks, method, seed)
            labels = {i: int(l) for i, l in enumerate(labels_arr)}
        elif split_type == "point":
            point_labels = clustering(points3d, num_blocks, method, seed)
            labels = {}
            assert self.point3d_image_ids is not None
            for p_idx, p_label in enumerate(point_labels):
                for image_id in np.asarray(self.point3d_image_ids[p_idx]).reshape(-1):
                    labels[int(image_id)] = int(p_label)
        else:
            raise NotImplementedError(split_type)

        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            with open(os.path.join(save_dir, "cluster.txt"), "w") as f:
                for image_id in sorted(labels):
                    print(f"{image_id} {labels[image_id]}", file=f)
        return labels
