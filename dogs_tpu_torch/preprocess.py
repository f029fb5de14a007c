"""Block preprocessing CLI of the port (the port of the root
preprocess_large_scale_data.py, reference preprocess_large_scale_data.py:13-76).

    python -m dogs_tpu_torch.preprocess --config config/gaussian_splatting/urban3d_admm.yaml \
        [--scene rubble] [key=value ...]

Per scene of `dataset.scene`: loads the scene (a COLMAP scene through
data/dataset.py `load_scene` with the config's keys, or the synthetic
teacher scene for `dataset.name: synthetic`, rendered on `device`, default
the card), partitions its train cameras and points into the OBB-aligned
mx x my grid of data/blocks.py (equal camera counts per cell, expanded
overlapping boxes; `dataset.partition_method` kmeans or spectral clusters the
cameras instead), and writes <root_dir>/<scene>/blocks_{mx}x{my}/: the OBB
transform, the two box tables (camera rows first, point rows after, as
dogs_tpu writes them) and one manifest per block, which either package's
block trainer reads.
"""

from __future__ import annotations

import copy
import logging
import os
import sys

import numpy as np

from dogs_tpu_torch.data.blocks import BlockPartition, block_dir, partition_scene, save_block
from dogs_tpu_torch.data.dataset import CameraRecord
from dogs_tpu_torch.data.synthetic import make_scene
from dogs_tpu_torch.factory import load_config_scene
from dogs_tpu_torch.utils.config import config_parser, load_config

logger = logging.getLogger("dogs_tpu_torch.preprocess")


def synthetic_block_scene(config, device: str = "cuda"):
    """(scene, train records, train images as numpy, n_val) of the synthetic
    teacher scene: the first max(n_cams // val_interval, 1) cameras are the
    val split (train_admm.load_val_split renders them again)."""
    ds = config.dataset
    scene = make_scene(
        n_gaussians=int(ds.get("n_gaussians", 96)),
        n_cams=int(ds.get("n_cams", 12)),
        width=int(ds.get("width", 96)),
        height=int(ds.get("height", 80)),
        seed=int(config.get("seed", 42)),
        device=device,
    )
    n_val = max(len(scene.cameras) // int(ds.get("val_interval", 8)), 1)
    records = [
        CameraRecord(
            R=c.R.cpu().numpy(), t=c.t.cpu().numpy(),
            fx=float(c.fx), fy=float(c.fy), cx=float(c.cx), cy=float(c.cy),
            width=c.width, height=c.height, image_path="", image_index=i,
        )
        for i, c in enumerate(scene.cameras[n_val:])
    ]
    images = [im.cpu().numpy() for im in scene.images[n_val:]]
    return scene, records, images, n_val


def write_partition(
    root: str,
    mx: int,
    my: int,
    part: BlockPartition,
    records: list[CameraRecord],
    points: np.ndarray,
    colors: np.ndarray,
    images: list[np.ndarray] | None = None,
) -> None:
    """The side outputs (load_colmap.py:402-450) and one manifest per block:
    block k holds the cameras labelled k and the points in its expanded
    point box; `images` embeds the pixels (a generated scene)."""
    out_root = os.path.dirname(block_dir(root, mx, my, 0))
    os.makedirs(out_root, exist_ok=True)
    np.save(os.path.join(out_root, "world_to_obb_transform.npy"), part.transform)
    # Reference table format (load_colmap.py:425-429): camera boxes first,
    # point boxes after; fusion crops by the point half.
    pb = part.point_bounds if part.point_bounds is not None else part.bounds
    pbe = part.point_bounds_expanded if part.point_bounds_expanded is not None else part.bounds_expanded
    np.savetxt(os.path.join(out_root, "bounding_boxes_origin.txt"),
               np.concatenate([part.bounds, pb]).reshape(2 * part.num_blocks, -1))
    np.savetxt(os.path.join(out_root, "bounding_boxes.txt"),
               np.concatenate([part.bounds_expanded, pbe]).reshape(2 * part.num_blocks, -1))
    for k in range(part.num_blocks):
        sel = [i for i, lbl in enumerate(part.camera_labels) if lbl == k]
        mask = part.point_masks[k]
        save_block(
            block_dir(root, mx, my, k), [records[i] for i in sel], points[mask], colors[mask],
            part.bounds[k], part.bounds_expanded[k], part.transform,
            images=None if images is None else [images[i] for i in sel],
        )
        logger.info("block %d: %d cameras, %d points", k, len(sel), int(mask.sum()))


def preprocess_scene(config, scene: str) -> None:
    """Partition one scene and write its block manifests."""
    ds = config.dataset
    root = os.path.join(ds.root_dir, scene)
    mx, my = int(ds.get("mx", 2)), int(ds.get("my", 2))
    sf = ds.get("bbox_scale_factor", [1.4, 1.4, 1.4])
    if ds.get("name", "") == "synthetic":
        sc, records, images, _ = synthetic_block_scene(config, config.get("device", "cuda"))
        cam_pos = np.stack([r.center for r in records])
        part = partition_scene(cam_pos, sc.points, mx, my, sf[:2])
        write_partition(root, mx, my, part, records, sc.points, sc.colors, images)
        return
    data = load_config_scene(config, scene)  # as train_admm.load_val_split reads it
    cam_pos = np.stack([c.center for c in data.train_cameras])
    part = partition_scene(cam_pos, data.points, mx, my, sf[:2],
                           method=str(ds.get("partition_method", "grid")), seed=int(config.get("seed", 42)))
    write_partition(root, mx, my, part, data.train_cameras, data.points, data.colors)


def main(argv: list[str] | None = None) -> None:
    args = config_parser().parse_args(argv)
    config = load_config(args.config, cli_overrides=[o for o in args.opts if "=" in o])
    scenes = config.dataset.scene
    if args.scene:
        scenes = [args.scene]
    elif isinstance(scenes, str):
        scenes = [scenes]
    for scene in scenes:
        logger.info("=== partitioning %s ===", scene)
        cfg = copy.deepcopy(config)
        cfg.dataset.scene = scene
        preprocess_scene(cfg, scene)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s %(message)s")
    main(sys.argv[1:])
