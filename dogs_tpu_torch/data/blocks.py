"""Scene block partitioning: OBB-aligned camera/point grids + block manifests.

The port's own copy of dogs_tpu/data/blocks.py (numpy only). The reference's
spatial clustering stack (conerf/geometry/cluster.py:30-232 Grid2DXY /
Grid2DClustering / Grid2DBiPartite, the block path of load_colmap.py:402-491
and the MiniDataset on-disk block format of dataset_base.py:96-150): blocks
are the unit of the DOGS distributed strategy, one `TrainState` each in
parallel/master.py.

The partition runs in float64 as dogs_tpu's does, and the manifest format is
the same (block.npz, images.npz, meta.json), so a block written by either
package loads in the other. `points_in_bounds2d_f32` is the width the
master's fusion crop and re-selection test at: dogs_tpu runs those two calls
on `jnp` arrays, in float32 (x64 is off), so a point within a few float32
ulps of a box edge can fall on the other side than in float64.

Differences from the reference by design (dogs_tpu's):
  * per-block data is an npz manifest + shared image paths instead of
    per-camera torch .pt files;
  * the OBB comes from PCA over camera ground-plane positions instead of
    trimesh.bounds.oriented_bounds (same effect: axis-align the dominant
    street/flight direction before gridding).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from dogs_tpu_torch.data.dataset import CameraRecord


def obb_transform_from_positions(positions: np.ndarray) -> np.ndarray:
    """(4,4) world->OBB transform aligning the xy principal axes.

    Equivalent role to world_to_obb_transform.npy (load_colmap.py:402-450).
    Assumes the scene is up-normalized (z approx up) — valid after
    similarity normalization. When the world-xy camera spread is DEGENERATE
    (a planar rig whose plane is NOT world-xy — e.g. a ring in xz — leaves
    one world-xy axis with ~zero variance), the 2D assumption would make
    the OBB minor axis the rig's normal: every 2D bound in that axis
    collapses to +-pad around the camera plane and the fusion crop then
    deletes scene content (measured: 21%% of a synthetic ring scene's
    INITIAL points fell outside the 1x1 origin box). Fall back to full 3D
    PCA and take the two largest principal axes as the OBB plane.
    """
    center3 = positions.mean(axis=0)
    xy = positions[:, :2]
    center = xy.mean(axis=0)
    d = xy - center
    cov = d.T @ d / max(len(d), 1)
    vals, vecs = np.linalg.eigh(cov)
    if vals[0] < 1e-6 * max(vals[1], 1e-12):
        d3 = positions - center3
        cov3 = d3.T @ d3 / max(len(d3), 1)
        _, vecs3 = np.linalg.eigh(cov3)
        a1 = vecs3[:, -1]  # largest principal axis
        a2 = vecs3[:, -2]
        a3 = np.cross(a1, a2)
        R3 = np.stack([a1, a2, a3], axis=0)  # rows = OBB axes
        T = np.eye(4)
        T[:3, :3] = R3
        T[:3, 3] = -R3 @ center3
        return T
    # Principal axis last from eigh; build right-handed 2D rotation.
    major = vecs[:, -1]
    minor = np.array([-major[1], major[0]])
    R2 = np.stack([major, minor], axis=0)  # rows = OBB axes
    T = np.eye(4)
    T[:2, :2] = R2
    T[:2, 3] = -R2 @ center
    return T


def apply_transform(points: np.ndarray, T: np.ndarray) -> np.ndarray:
    return points @ T[:3, :3].T + T[:3, 3]


def split_compact_grid(
    positions_obb: np.ndarray, mx: int, my: int
) -> tuple[np.ndarray, np.ndarray]:
    """Equal-count mx x my grid over OBB xy (cluster.py:76-140 Grid2DXY):
    split x into mx equal-count rank strips, then each strip by y ranks.

    Rank-based (argsort + array_split), NOT value-quantile: tied
    coordinates collapse quantile edges — a ring rig with two distinct x
    stations put ALL of a strip's cameras on one side of its own y-median
    (y == median for every member, so `y < median` is empty) and left two
    of four blocks with zero cameras. Ranks guarantee every block gets
    floor/ceil(n/b) members whenever n >= mx*my.

    Returns (labels (N,), bounds (mx*my, 2, 2)): per-block [[x0,y0],[x1,y1]]
    in OBB coordinates. Edges sit at midpoints between adjacent strips'
    boundary members; outer edges extend to the data hull padded by 10%.
    Under ties adjacent bounds may touch — labels are authoritative for
    cameras, and point assignment uses the expanded bounds anyway.
    """
    n = positions_obb.shape[0]
    x = positions_obb[:, 0]
    y = positions_obb[:, 1]
    pad = 0.1 * max(float(np.ptp(x)), float(np.ptp(y)), 1e-6)
    x_lo, x_hi = float(x.min()) - pad, float(x.max()) + pad
    y_lo, y_hi = float(y.min()) - pad, float(y.max()) + pad

    def rank_edges(vals, order, parts, lo, hi):
        """Split `order` (indices sorted by vals) into equal-count groups;
        edge i|i+1 = midpoint between the groups' boundary values."""
        groups = np.array_split(order, parts)
        edges = [lo]
        for a, b_ in zip(groups[:-1], groups[1:]):
            if a.size and b_.size:
                edges.append(0.5 * (float(vals[a[-1]]) + float(vals[b_[0]])))
            else:
                edges.append(edges[-1])
        edges.append(hi)
        return groups, np.asarray(edges)

    labels = np.zeros((n,), np.int32)
    bounds = np.zeros((mx * my, 2, 2))
    x_groups, x_edges = rank_edges(x, np.argsort(x, kind="stable"), mx, x_lo, x_hi)
    for i, strip in enumerate(x_groups):
        y_groups, y_edges = rank_edges(
            y, strip[np.argsort(y[strip], kind="stable")], my, y_lo, y_hi
        )
        for j, cell in enumerate(y_groups):
            k = i * my + j
            labels[cell] = k
            bounds[k] = [[x_edges[i], y_edges[j]], [x_edges[i + 1], y_edges[j + 1]]]
    return labels, bounds


def split_bipartite(positions_obb: np.ndarray, num_blocks: int):
    """Recursive longest-axis equal-count bisection
    (cluster.py:30-73 Grid2DBiPartite). num_blocks must be a power of two."""
    assert num_blocks & (num_blocks - 1) == 0, "num_blocks must be 2^k"
    n = positions_obb.shape[0]
    idx_sets = [np.arange(n)]
    while len(idx_sets) < num_blocks:
        nxt = []
        for idx in idx_sets:
            p = positions_obb[idx, :2]
            axis = int(np.argmax(p.max(0) - p.min(0)))
            med = np.median(p[:, axis])
            left = idx[p[:, axis] <= med]
            right = idx[p[:, axis] > med]
            if len(left) == 0 or len(right) == 0:  # degenerate tie: split evenly
                order = idx[np.argsort(p[:, axis], kind="stable")]
                left, right = order[: len(idx) // 2], order[len(idx) // 2 :]
            nxt += [left, right]
        idx_sets = nxt
    labels = np.zeros((n,), np.int32)
    for k, idx in enumerate(idx_sets):
        labels[idx] = k
    return labels


def expand_bounds(bounds: np.ndarray, scale_factor: float | np.ndarray) -> np.ndarray:
    """Expand each block box around its center (cluster.py:177-195;
    bbox_scale_factor 1.4 in urban3d_admm.yaml:20 gives the ADMM overlap)."""
    center = bounds.mean(axis=1, keepdims=True)
    half = (bounds[:, 1:2] - bounds[:, 0:1]) * 0.5
    sf = np.asarray(scale_factor).reshape(1, 1, -1)[..., : bounds.shape[-1]]
    return np.concatenate([center - half * sf, center + half * sf], axis=1)


def points_in_bounds2d(
    points: np.ndarray, bounds_xy: np.ndarray, transform: np.ndarray | None = None
) -> np.ndarray:
    """(P,) bool — inside an OBB-space xy rectangle
    (conerf/datasets/utils.py:186-215 points_in_bbox2D)."""
    p = apply_transform(points, transform) if transform is not None else points
    return (
        (p[:, 0] >= bounds_xy[0, 0])
        & (p[:, 0] <= bounds_xy[1, 0])
        & (p[:, 1] >= bounds_xy[0, 1])
        & (p[:, 1] <= bounds_xy[1, 1])
    )


def points_in_bounds2d_f32(
    points: np.ndarray, bounds_xy: np.ndarray, transform: np.ndarray
) -> np.ndarray:
    """`points_in_bounds2d` in float32, bit for bit as dogs_tpu computes it
    on `jnp` arrays (the master's fusion crop and re-selection): the points,
    the box and the transform cast to float32, the OBB x and y each as
    ((R0 x + R1 y) + R2 z) + t in float32 with no fused multiply-add, the
    order XLA's CPU dot gives these two rows."""
    p = np.asarray(points, np.float32)
    T = np.asarray(transform, np.float32)
    b = np.asarray(bounds_xy, np.float32)

    def row(r):
        return ((T[r, 0] * p[:, 0] + T[r, 1] * p[:, 1]) + T[r, 2] * p[:, 2]) + T[r, 3]

    x, y = row(0), row(1)
    return (x >= b[0, 0]) & (x <= b[1, 0]) & (y >= b[0, 1]) & (y <= b[1, 1])


@dataclasses.dataclass
class BlockPartition:
    """Full partition result for a scene.

    `bounds`/`bounds_expanded` come from the CAMERA grid (image
    assignment); `point_bounds`/`point_bounds_expanded` from the POINT
    grid. The reference keeps both (load_colmap.py:422-429 writes camera
    boxes + point boxes into one table) and CROPS FUSION BY THE POINT
    BOXES (master_gaussian_trainer.py:54-71 uses point_bboxes): scene
    content routinely extends past the camera hull, and cropping merged
    Gaussians to camera-derived boxes deletes real content (measured
    -8 dB fused val on the synthetic ring scene). When the point boxes
    are absent (old manifests), callers fall back to the camera boxes."""

    num_blocks: int
    transform: np.ndarray  # (4,4) world->OBB
    camera_labels: np.ndarray  # (n_cams,)
    bounds: np.ndarray  # (k, 2, 2) CAMERA-grid origin boxes (OBB xy)
    bounds_expanded: np.ndarray  # (k, 2, 2) camera overlap boxes
    point_masks: list[np.ndarray]  # per block (P,) bool over the global cloud
    point_bounds: np.ndarray | None = None  # (k, 2, 2) POINT-grid origin boxes
    point_bounds_expanded: np.ndarray | None = None  # (k, 2, 2)

    def crop_bounds(self, k: int) -> np.ndarray:
        """Origin box for the fusion de-overlap crop (point grid when
        available — reference parity)."""
        src = self.point_bounds if self.point_bounds is not None else self.bounds
        return src[k]

    def select_bounds(self, k: int) -> np.ndarray:
        """Expanded box for post-fusion block re-selection."""
        src = (
            self.point_bounds_expanded
            if self.point_bounds_expanded is not None
            else self.bounds_expanded
        )
        return src[k]


def partition_scene(
    camera_positions: np.ndarray,
    points: np.ndarray,
    mx: int,
    my: int,
    bbox_scale_factor=(1.4, 1.4),
    method: str = "grid",
    seed: int = 0,
) -> BlockPartition:
    """The preprocess_large_scale_data.py block path in one call
    (load_colmap.py:402-450). `method`: "grid" (equal-count OBB grid,
    cluster.py Grid2DXY), or "kmeans"/"spectral" (SceneSplitter camera
    clustering, scene_spliter.py:40-66; block bounds are the compact OBB
    boxes of each cluster's cameras)."""
    T = obb_transform_from_positions(camera_positions)
    cams_obb = apply_transform(camera_positions, T)
    if method in ("kmeans", "spectral"):
        from dogs_tpu_torch.data.splitter import clustering

        labels = clustering(
            camera_positions, mx * my, method="KMeans" if method == "kmeans" else "Spectral",
            seed=seed,
        ).astype(np.int32)
        bounds = np.stack(
            [
                np.stack(
                    [
                        cams_obb[labels == k, :2].min(0),
                        cams_obb[labels == k, :2].max(0),
                    ]
                )
                if (labels == k).any()
                else np.zeros((2, 2), np.float64)
                for k in range(mx * my)
            ]
        )
    else:
        labels, bounds = split_compact_grid(cams_obb, mx, my)
    bounds_exp = expand_bounds(bounds, np.asarray(bbox_scale_factor))

    # POINT-grid boxes (cluster_points_in_grid, load_colmap.py:141-177):
    # the same equal-count grid over the POINT cloud, outlier-clipped at
    # the reference's p0/p1 quantiles so one stray SfM point can't inflate
    # a block. These carry the fusion crop / re-selection; the camera
    # boxes above only assign images. Grid method only: a point-grid cell's
    # index corresponds spatially to the camera grid's cell k, but NOT to
    # an arbitrary kmeans/spectral cluster label — those keep the camera
    # cluster boxes (and their fusion crop stays camera-derived).
    pts_obb = np.asarray(apply_transform(points, T))
    if len(pts_obb) and method == "grid":
        lo = np.quantile(pts_obb[:, :2], 1e-5, axis=0)
        hi = np.quantile(pts_obb[:, :2], 0.99999, axis=0)
        clipped = pts_obb[
            (pts_obb[:, 0] >= lo[0]) & (pts_obb[:, 0] <= hi[0])
            & (pts_obb[:, 1] >= lo[1]) & (pts_obb[:, 1] <= hi[1])
        ]
        _, pbounds = split_compact_grid(clipped, mx, my)
    else:
        pbounds = bounds.copy()
    pbounds_exp = expand_bounds(pbounds, np.asarray(bbox_scale_factor))
    masks = [
        points_in_bounds2d(points, pbounds_exp[k], T) for k in range(mx * my)
    ]
    return BlockPartition(
        num_blocks=mx * my,
        transform=T,
        camera_labels=labels,
        bounds=bounds,
        bounds_expanded=bounds_exp,
        point_masks=masks,
        point_bounds=pbounds,
        point_bounds_expanded=pbounds_exp,
    )


# ---- on-disk block manifests (MiniDataset replacement) ---------------------


def block_dir(root: str, mx: int, my: int, k: int) -> str:
    """blocks_{mx}x{my}/block_{k} layout parity
    (conerf/datasets/utils.py:400-411 get_block_info_dir)."""
    return os.path.join(root, f"blocks_{mx}x{my}", f"block_{k}")


def save_block(
    path: str,
    cameras: list[CameraRecord],
    points: np.ndarray,
    colors: np.ndarray,
    bounds: np.ndarray,
    bounds_expanded: np.ndarray,
    transform: np.ndarray,
    images: list[np.ndarray] | None = None,
) -> None:
    """Write one block's manifest (replaces MiniDataset.write,
    dataset_base.py:111-124).

    `images` embeds pixel data in the manifest (synthetic/e2e-test scenes
    whose images exist only in memory); real scenes rely on `image_path`s."""
    os.makedirs(path, exist_ok=True)
    if images is not None:
        np.savez_compressed(
            os.path.join(path, "images.npz"),
            images=np.stack(images).astype(np.float16),
        )
    np.savez_compressed(
        os.path.join(path, "block.npz"),
        R=np.stack([c.R for c in cameras]) if cameras else np.zeros((0, 3, 3)),
        t=np.stack([c.t for c in cameras]) if cameras else np.zeros((0, 3)),
        intrinsics=np.asarray(
            [[c.fx, c.fy, c.cx, c.cy, c.width, c.height] for c in cameras]
        ).reshape(-1, 6),
        dist=np.stack(
            [
                np.zeros(4) if c.dist is None else np.asarray(c.dist, np.float64)
                for c in cameras
            ]
        ) if cameras else np.zeros((0, 4)),
        image_index=np.asarray([c.image_index for c in cameras], np.int64),
        points=points.astype(np.float32),
        colors=colors.astype(np.float32),
        bounds=bounds,
        bounds_expanded=bounds_expanded,
        transform=transform,
    )
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(
            {
                "num_cameras": len(cameras),
                "num_points": int(points.shape[0]),
                "image_paths": [c.image_path for c in cameras],
            },
            f,
            indent=2,
        )


def load_block(path: str):
    """Read one block's manifest (replaces MiniDataset.read,
    dataset_base.py:126-150)."""
    data = np.load(os.path.join(path, "block.npz"))
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    cameras = []
    for i in range(int(meta["num_cameras"])):
        fx, fy, cx, cy, w, h = data["intrinsics"][i]
        d = data["dist"][i] if "dist" in data else np.zeros(4)
        cameras.append(
            CameraRecord(
                R=data["R"][i], t=data["t"][i], fx=fx, fy=fy, cx=cx, cy=cy,
                width=int(w), height=int(h),
                image_path=meta["image_paths"][i],
                image_index=int(data["image_index"][i]),
                dist=d if np.any(d != 0.0) else None,
            )
        )
    images = None
    img_path = os.path.join(path, "images.npz")
    if os.path.exists(img_path):
        images = list(np.load(img_path)["images"].astype(np.float32))
    return dict(
        cameras=cameras,
        points=data["points"],
        colors=data["colors"],
        bounds=data["bounds"],
        bounds_expanded=data["bounds_expanded"],
        transform=data["transform"],
        images=images,
    )
