"""Trainer factory: the port of the root utils.py (reference utils.py:8-23).

`create_trainer(config)` builds (trainer, checkpoint_manager,
tensorboard_writer) from a resolved config (utils/config.py). The port
supports `neural_field_type: gs` on the synthetic scene and on COLMAP scenes
(every other `dataset.name`: data/dataset.py `load_scene` under
<dataset.root_dir>/<dataset.scene>, the train split streamed through a
`LazyImageList`); Scaffold-GS and block-parallel ADMM
(`dataset.multi_blocks`) raise `NotImplementedError`. The config key
`device` (default "cuda") places the trainer; `device=cpu` runs the plain
PyTorch paths.
"""

from __future__ import annotations

import logging
import os

from dogs_tpu_torch.data.dataset import load_scene
from dogs_tpu_torch.data.reader import LazyImageList
from dogs_tpu_torch.data.synthetic import make_scene
from dogs_tpu_torch.raster.tiled import RasterConfig
from dogs_tpu_torch.train.checkpoint import CheckpointManager
from dogs_tpu_torch.train.trainer import GaussianSplatTrainer, TrainerConfig

logger = logging.getLogger(__name__)


def _build_dataset(config, device) -> dict:
    """The scene as utils.py builds it. A COLMAP scene: `load_scene` with the
    config's keys, the train images streamed lazily (decoded at each
    record's size, undistorted), the val images loaded up front. The
    synthetic teacher-splat scene: the first max(n_cams // val_interval, 1)
    cameras are the val split."""
    ds = config.dataset
    if ds.get("name", "synthetic") != "synthetic":
        data = load_scene(
            os.path.join(ds.root_dir, str(ds.scene)),
            factor=int(ds.get("factor", 1)),
            val_interval=int(ds.get("val_interval", 8)),
            model_folder=ds.get("model_folder", "sparse"),
            normalize=bool(ds.get("scale", True)),
            use_manhattan_world=bool(ds.get("use_manhattan_world", False)),
            scene_name=str(ds.scene),
            dataset_name=str(ds.get("name", "")),
        )
        return dict(
            train_cameras=[r.to_camera(device) for r in data.train_cameras],
            train_images=LazyImageList(data.train_cameras),
            val_cameras=[r.to_camera(device) for r in data.val_cameras],
            val_images=[r.load() for r in data.val_cameras],
            points=data.points,
            colors=data.colors,
        )
    scene = make_scene(
        n_gaussians=int(ds.get("n_gaussians", 96)),
        n_cams=int(ds.get("n_cams", 12)),
        width=int(ds.get("width", 96)),
        height=int(ds.get("height", 80)),
        seed=int(config.get("seed", 42)),
        device=device,
    )
    n_val = max(len(scene.cameras) // int(ds.get("val_interval", 8)), 1)
    return dict(
        train_cameras=scene.cameras[n_val:],
        train_images=scene.images[n_val:],
        val_cameras=scene.cameras[:n_val],
        val_images=scene.images[:n_val],
        points=scene.points,
        colors=scene.colors,
    )


def _trainer_config(config) -> TrainerConfig:
    """utils.py:_trainer_config for the fields the port has."""
    lr = config.optimizer.lr
    geo = config.geometry
    prune = config.get("prune", {}) or {}
    profile = config.trainer.get("profile", {}) or {}
    return TrainerConfig(
        max_iterations=int(config.trainer.max_iterations),
        lambda_dssim=float(config.loss.get("lambda_dssim", 0.2)),
        lambda_scale=float(config.loss.get("lambda_scale", 0.01)),
        position_lr_init=float(lr.get("position_init", 1.6e-4)),
        position_lr_final=float(lr.get("position_final", 1.6e-6)),
        position_lr_delay_mult=float(lr.get("position_delay_mult", 0.01)),
        position_lr_max_steps=int(lr.get("position_max_iterations", config.trainer.max_iterations)),
        feature_lr=float(lr.get("feature", 2.5e-3)),
        opacity_lr=float(lr.get("opacity", 0.025)),
        scaling_lr=float(lr.get("scaling", 5e-3)),
        quaternion_lr=float(lr.get("quaternion", 1e-3)),
        exposure_lr_init=float(lr.get("exposure_lr_init", 0.01)),
        exposure_lr_final=float(lr.get("exposure_lr_final", 0.001)),
        exposure_lr_delay_steps=int(lr.get("exposure_lr_delay_steps", 0)),
        exposure_lr_delay_mult=float(lr.get("exposure_lr_delay_mult", 0.0)),
        percent_dense=float(geo.get("percent_dense", 0.01)),
        densify_start_iter=int(geo.get("densify_start_iter", 500)),
        densify_end_iter=int(geo.get("densify_end_iter", 15000)),
        densification_interval=int(geo.get("densification_interval", 100)),
        opacity_reset_interval=int(geo.get("opacity_reset_interval", 3000)),
        densify_grad_threshold=float(geo.get("densify_grad_threshold", 2e-4)),
        coarse_to_fine=bool(geo.get("coarse-to-fine", False)),
        prune_iterations=tuple(prune.get("iterations", []) or []),
        prune_v_pow=float(prune.get("v_pow", 0.1)),
        prune_decay=float(prune.get("prune_decay", 0.6)),
        prune_percent=float(prune.get("prune_percent", 0.5)),
        max_sh_degree=int(config.texture.get("max_sh_degree", 3)),
        use_trained_exposure=bool(config.get("appearance", {}).get("use_trained_exposure", False)),
        # The reference keys the VastGaussian appearance mask on
        # geometry.mask (urban3d_admm.yaml); either spelling turns it on.
        use_appearance_mask=bool(
            config.get("appearance", {}).get("use_appearance_mask", False) or geo.get("mask", False)
        ),
        lambda_mask=float(config.loss.get("lambda_mask", 0.0)),
        mask_lr=float(lr.get("mask", 1e-3)),
        optimize_camera_poses=bool(lr.get("pose", 0.0)),
        pose_lr=float(lr.get("pose", 0.0) or 1e-4),
        opt_pose_start_iter=int(geo.get("opt_pose_start_iter", 3000)),
        white_background=bool(config.dataset.get("apply_mask", False)),
        spatial_lr_scale=float(geo.get("spatial_lr_scale", -1.0)),
        chain_steps=int(config.trainer.get("chain_steps", 1)),
        profile_start_step=int(profile.get("start_step", 0)),
        profile_num_steps=int(profile.get("num_steps", 0)),
        profile_dir=str(profile.get("dir", "profile")),
    )


def _raster_config(config) -> RasterConfig:
    """The render keys of the config. The TPU budget and schedule keys
    (pipeline.use_pallas, pallas_stream, bin_capacity, base_tiles,
    overflow_capacity, tile_batch, chunk) have no meaning here: binning is
    exact-size and the Hopper kernels have one schedule."""
    pipe = config.get("pipeline", {}) or {}
    return RasterConfig(
        antialiasing=bool(config.texture.get("anti_aliasing", False)),
        depth_threshold=float(config.geometry.get("depth_threshold", 0.0)),
        max_tiles_per_gaussian=int(pipe.get("max_tiles_per_gaussian", 16)),
    )


def create_trainer(config):
    """(trainer, checkpoint_manager, tensorboard_writer) for a resolved
    config, keyed on `neural_field_type` as the reference utils.py is. The
    writer is a tensorboardX SummaryWriter when trainer.enable_tensorboard is
    set and tensorboardX imports, else None."""
    field_type = config.get("neural_field_type", "gs")
    if field_type != "gs":
        raise NotImplementedError(
            f"neural_field_type={field_type!r}: Scaffold-GS is not ported to dogs_tpu_torch yet "
            "(ROADMAP.md queue 1, item 6)"
        )
    if bool(config.dataset.get("multi_blocks", False)):
        raise NotImplementedError(
            "dataset.multi_blocks: block-parallel ADMM is not ported to dogs_tpu_torch yet "
            "(ROADMAP.md queue 1, item 5); set dataset.multi_blocks=false to train the scene on one device"
        )
    device = config.get("device", "cuda")
    cfg, raster_cfg = _trainer_config(config), _raster_config(config)
    data = _build_dataset(config, device)

    out_root = os.path.join(config.get("root_dir", "out"), config.get("expname", "exp"))
    os.makedirs(out_root, exist_ok=True)
    ckpt_manager = CheckpointManager(
        os.path.join(out_root, "model"), max_to_keep=int(config.trainer.get("max_to_keep", 3))
    )
    writer = None
    if bool(config.trainer.get("enable_tensorboard", False)):
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            logger.info("tensorboardX is not installed: no tensorboard logs")
        else:
            writer = SummaryWriter(os.path.join(out_root, "logs"))

    trainer = GaussianSplatTrainer(
        cameras=data["train_cameras"],
        images=data["train_images"],
        points=data["points"],
        colors=data["colors"],
        cfg=cfg,
        raster_cfg=raster_cfg,
        val_cameras=data["val_cameras"],
        val_images=data["val_images"],
        seed=int(config.get("seed", 42)),
        device=device,
    )
    return trainer, ckpt_manager, writer
