"""MatrixCity -> COLMAP converter.

    python -m dogs_tpu_torch.tools.matrix_city_to_colmap <scene_dir> [pose_json ...]

The port of scripts/preprocess/matrix_city_to_colmap.py, which it matches
byte for byte: reads MatrixCity's nerfstudio-style pose files (default:
<scene_dir>/pose/**/transforms*.json, else <scene_dir>/transforms*.json;
fl_x, cx, cy, w, h and each frame's transform_matrix), applies the
MatrixCity -> COLMAP camera-axis flip and the Manhattan-world alignment,
and writes a COLMAP model to <scene_dir>/sparse/0. Its points are a
0.5-unit voxel downsample of <scene_dir>/point_cloud.ply where one exists,
else the camera centres. Needs no JAX.
"""

from __future__ import annotations

import glob
import json
import os
import sys

import numpy as np

from dogs_tpu_torch.data.colmap import ColmapCamera, ColmapImage, write_cameras_bin, write_images_bin, write_points3d_bin
from dogs_tpu_torch.data.ply import read_point_cloud
from dogs_tpu_torch.tools.meganerf_to_colmap import rotmat_to_qvec

# MatrixCity camera axes -> COLMAP camera axes (flip y and z, as Blender's).
MATRIX_CITY_TO_COLMAP = np.diag([1.0, -1.0, -1.0])
# The z-up Manhattan alignment the reference applies to the whole scene.
TO_MANHATTAN_WORLD = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, -1.0, 0.0]])


def convert(scene_dir: str, pose_jsons: list[str] | None = None) -> None:
    if not pose_jsons:
        pose_jsons = sorted(glob.glob(os.path.join(scene_dir, "pose", "**", "transforms*.json"), recursive=True)) \
            or sorted(glob.glob(os.path.join(scene_dir, "transforms*.json")))
    if not pose_jsons:
        raise FileNotFoundError(f"no transforms.json under {scene_dir}")

    cameras: dict[int, ColmapCamera] = {}
    images: dict[int, ColmapImage] = {}
    cam_key_to_id: dict[tuple, int] = {}
    for jpath in pose_jsons:
        with open(jpath) as f:
            meta = json.load(f)
        fx = float(meta["fl_x"])
        cx, cy = float(meta["cx"]), float(meta["cy"])
        w, h = int(meta["w"]), int(meta["h"])
        key = (round(fx, 3), w, h)
        if key not in cam_key_to_id:
            cam_key_to_id[key] = len(cam_key_to_id) + 1
            cam_id = cam_key_to_id[key]
            cameras[cam_id] = ColmapCamera(cam_id, "SIMPLE_PINHOLE", w, h, np.asarray([fx, cx, cy]))
        for frame in meta["frames"]:
            c2w = np.asarray(frame["transform_matrix"], np.float64)
            c2w[:3, :3] = TO_MANHATTAN_WORLD @ (c2w[:3, :3] @ MATRIX_CITY_TO_COLMAP)
            c2w[:3, 3] = TO_MANHATTAN_WORLD @ c2w[:3, 3]
            w2c = np.linalg.inv(c2w)
            image_id = len(images) + 1
            path = frame["file_path"]
            name = path[path.rfind("..") + 3:] if ".." in path else path.lstrip("./")
            images[image_id] = ColmapImage(image_id, rotmat_to_qvec(w2c[:3, :3]), w2c[:3, 3], cam_key_to_id[key], name)

    colmap_dir = os.path.join(scene_dir, "sparse", "0")
    os.makedirs(colmap_dir, exist_ok=True)
    write_cameras_bin(os.path.join(colmap_dir, "cameras.bin"), cameras)
    write_images_bin(os.path.join(colmap_dir, "images.bin"), images)
    # The reference downsamples MatrixCity's depth-fused cloud
    # (matrix_city_to_colmap.py:58-73); without one, the camera centres.
    ply_in = os.path.join(scene_dir, "point_cloud.ply")
    if os.path.exists(ply_in):
        xyz, rgb = read_point_cloud(ply_in)
        xyz = (TO_MANHATTAN_WORLD @ xyz.T).T
        _, keep = np.unique(np.floor(xyz / 0.5), axis=0, return_index=True)
        xyz, rgb = xyz[keep], (rgb[keep] * 255).astype(np.uint8)
    else:
        xyz = np.stack([-(im.rotation().T @ im.tvec) for im in images.values()])
        rgb = np.full((len(xyz), 3), 128, np.uint8)
    write_points3d_bin(os.path.join(colmap_dir, "points3D.bin"), xyz, rgb)
    print(f"{scene_dir}: {len(images)} images, {len(cameras)} cameras, {len(xyz)} points -> {colmap_dir}")


if __name__ == "__main__":
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    convert(sys.argv[1], sys.argv[2:] or None)
