"""Mega-NeRF -> COLMAP converter.

    python -m dogs_tpu_torch.tools.meganerf_to_colmap <data_dir> <scene>

The port of scripts/preprocess/meganerf_to_colmap.py, which it matches byte
for byte: reads Mega-NeRF's per-image metadata (`train/metadata/*.pt` and
`val/metadata/*.pt`, each a DRB-convention (3, 4) camera-to-world `c2w`,
intrinsics [fx, fy, cx, cy], `W` and `H`) and `mappings.txt` (image name <->
metadata file), turns the poses into COLMAP's RDF world-to-camera
convention and writes a COLMAP model to <scene>/sparse/0 with the camera
centres as its points (Mega-NeRF ships no sparse points), and the val split
to <scene>/val_images.txt. Mill-19 (building, rubble) and UrbanScene3D use
this layout. Needs no JAX.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from dogs_tpu_torch.core.transforms import rotmat_to_quat
from dogs_tpu_torch.data.colmap import ColmapCamera, ColmapImage, write_cameras_bin, write_images_bin, write_points3d_bin

# Mega-NeRF stores poses in DRB (down-right-back); COLMAP wants RDF.
DRB_TO_RDF = np.array([[0, 1, 0], [1, 0, 0], [0, 0, -1]], np.float64)


def rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    """(3, 3) -> wxyz quaternion, computed in float32 as the scripts do."""
    return rotmat_to_quat(torch.as_tensor(R, dtype=torch.float32)).numpy().astype(np.float64)


def meganerf_c2w_to_colmap_w2c(c2w34: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The reference's axis shuffle, then the inverse: (qvec, tvec) world-to-camera."""
    c2w = np.eye(4)
    # Column swap: colmap x = -meganerf y, colmap y = meganerf x.
    c2w[:3, 0:1] = -c2w34[:, 1:2]
    c2w[:3, 1:2] = c2w34[:, 0:1]
    c2w[:3, 2:4] = c2w34[:, 2:4]
    c2w[:3, :3] = DRB_TO_RDF @ c2w[:3, :3] @ DRB_TO_RDF
    c2w[:3, 3:] = DRB_TO_RDF @ c2w[:3, 3:]
    w2c = np.linalg.inv(c2w)
    return rotmat_to_qvec(w2c[:3, :3]), w2c[:3, 3]


def read_mappings(path: str) -> dict[str, str]:
    """mappings.txt lines '<image_name>,<metadata_name>' as {metadata: image}."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            img, meta = line.split(",")
            out[meta.strip()] = img.strip()
    return out


def convert(data_dir: str, scene: str) -> None:
    scene_dir = os.path.join(data_dir, scene)
    colmap_dir = os.path.join(scene_dir, "sparse", "0")
    os.makedirs(colmap_dir, exist_ok=True)
    meta_to_image = read_mappings(os.path.join(scene_dir, "mappings.txt"))

    cameras: dict[int, ColmapCamera] = {}
    images: dict[int, ColmapImage] = {}
    val_names: list[str] = []
    cam_key_to_id: dict[tuple, int] = {}
    for split in ["train", "val"]:
        meta_dir = os.path.join(scene_dir, split, "metadata")
        if not os.path.isdir(meta_dir):
            continue
        for fname in sorted(os.listdir(meta_dir)):
            if not fname.endswith(".pt"):
                continue
            md = torch.load(os.path.join(meta_dir, fname), map_location="cpu")
            c2w = np.asarray(md["c2w"], np.float64)
            fx, fy, cx, cy = (float(v) for v in md["intrinsics"])
            w, h = int(md["W"]), int(md["H"])
            key = (round(fx, 3), round(fy, 3), w, h)
            if key not in cam_key_to_id:
                cam_key_to_id[key] = len(cam_key_to_id) + 1
                cam_id = cam_key_to_id[key]
                cameras[cam_id] = ColmapCamera(cam_id, "PINHOLE", w, h, np.asarray([fx, fy, cx, cy]))
            qvec, tvec = meganerf_c2w_to_colmap_w2c(c2w)
            image_id = len(images) + 1
            name = meta_to_image.get(fname.replace(".pt", ""), fname.replace(".pt", ".jpg"))
            images[image_id] = ColmapImage(image_id, qvec, tvec, cam_key_to_id[key], name)
            if split == "val":
                val_names.append(name)

    write_cameras_bin(os.path.join(colmap_dir, "cameras.bin"), cameras)
    write_images_bin(os.path.join(colmap_dir, "images.bin"), images)
    # No sparse points: the camera centres seed the cloud, so that the scale
    # init has one (users re-triangulate with COLMAP).
    centers = np.stack([-(im.rotation().T @ im.tvec) for im in images.values()])
    write_points3d_bin(os.path.join(colmap_dir, "points3D.bin"), centers, np.full((len(centers), 3), 128, np.uint8))
    with open(os.path.join(scene_dir, "val_images.txt"), "w") as f:
        f.write("\n".join(val_names) + "\n")
    print(f"{scene}: {len(images)} images ({len(val_names)} val), {len(cameras)} cameras -> {colmap_dir}")


if __name__ == "__main__":
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    convert(sys.argv[1], sys.argv[2])
