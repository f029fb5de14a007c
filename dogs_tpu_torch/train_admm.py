"""Block-parallel ADMM training CLI of the port (the port of the root
train_admm.py; the reference's `torchrun ... -m
conerf.trainers.master_gaussian_trainer`, master_gaussian_trainer.py:839-873).

    python -m dogs_tpu_torch.train_admm --config config/gaussian_splatting/urban3d_admm.yaml \
        [--scene rubble] [--suffix run1] [key=value ...]

Expects the block manifests of `python -m dogs_tpu_torch.preprocess` (or of
dogs_tpu's preprocess_large_scale_data.py) under
<dataset.root_dir>/<scene>/blocks_{mx}x{my}/. One process drives the blocks
(parallel/master.py): independent block training with densify, the fusion
with the post-merge prune at densify_end_iter, then ADMM consensus rounds
every trainer.admm.consensus_interval steps. Checkpoints the whole block
state every trainer.n_checkpoint steps and at the end, resumes from it with
trainer.resume or trainer.ckpt_path, validates the fused model every
trainer.n_validation steps and at the end, and exports the fused model as
.ply and .splat under <root_dir>/<expname>/export. The experiment is named
as train_admm.py names it, ending in `_admm`. `device=cpu` runs on the CPU
(the default is the card; blocks go round robin over the CUDA devices).
"""

from __future__ import annotations

import copy
import logging
import os
import sys

from dogs_tpu_torch.factory import _raster_config, _trainer_config, load_config_scene
from dogs_tpu_torch.fields.io import save_gaussian_ply, save_splat
from dogs_tpu_torch.parallel.admm import AdmmConfig
from dogs_tpu_torch.parallel.master import MasterTrainer
from dogs_tpu_torch.preprocess import synthetic_block_scene
from dogs_tpu_torch.train.checkpoint import CheckpointManager
from dogs_tpu_torch.utils.config import config_parser, load_config

logger = logging.getLogger("dogs_tpu_torch.train_admm")


def admm_config(config) -> AdmmConfig:
    """trainer.admm of the config as an AdmmConfig (train_admm.py's keys and
    defaults)."""
    a = config.trainer.get("admm", {}) or {}
    d = AdmmConfig()
    fields = {f: type(getattr(d, f)) for f in AdmmConfig.__dataclass_fields__}
    return AdmmConfig(**{f: cast(a.get(f, getattr(d, f))) for f, cast in fields.items()})


def load_val_split(config, scene: str, device: str = "cuda"):
    """(cameras on `device`, numpy images) of the val split for the fused
    model's validation (master:314 load_val_dataset): the synthetic scene's
    first cameras, or the COLMAP scene's val split read with the
    preprocess's options."""
    if config.dataset.get("name", "") == "synthetic":
        sc, _, _, n_val = synthetic_block_scene(config, device)
        return sc.cameras[:n_val], [im.cpu().numpy() for im in sc.images[:n_val]]
    data = load_config_scene(config, scene)
    return [r.to_camera(device) for r in data.val_cameras], [r.load() for r in data.val_cameras]


def train_scene(config, scene: str) -> dict:
    """Train one scene's blocks to trainer.max_iterations; returns the final
    validation of the fused model."""
    device = config.get("device", "cuda")
    mx, my = int(config.dataset.get("mx", 2)), int(config.dataset.get("my", 2))
    master = MasterTrainer.from_manifests(
        os.path.join(config.dataset.root_dir, scene), mx, my,
        trainer_cfg=_trainer_config(config),
        raster_cfg=_raster_config(config),
        admm_cfg=admm_config(config),
        spatial_lr_scale=float(config.geometry.get("spatial_lr_scale", -1.0)),
        seed=int(config.get("seed", 42)),
        device=device,
    )
    try:
        out_root = os.path.join(config.get("root_dir", "out"), config.get("expname", "exp"))
        manager = CheckpointManager(os.path.join(out_root, "model"),
                                    max_to_keep=int(config.trainer.get("max_to_keep", 3)))
        if config.trainer.get("ckpt_path", "") or config.trainer.get("resume", False):
            start = master.load_checkpoint(manager, config.trainer.get("ckpt_path") or None)
            if start:
                logger.info("resumed from step %d (admm=%s)", start, master.admm_enabled)

        max_iters = int(config.trainer.max_iterations)
        n_checkpoint = int(config.trainer.get("n_checkpoint", 0))
        n_validation = int(config.trainer.get("n_validation", 0))
        last_ckpt = last_val = master.step
        while master.step < max_iters:
            metrics = master.train_iteration()
            logger.info("step %d %s%s", master.step, " ".join(f"{k}={v:.4g}" for k, v in sorted(metrics.items())),
                        " [admm]" if master.admm_enabled else "")
            if n_validation and master.step - last_val >= n_validation:
                logger.info("step %d val %s", master.step, master.validate(*load_val_split(config, scene, device)))
                last_val = master.step
            if n_checkpoint and master.step - last_ckpt >= n_checkpoint:
                master.save_checkpoint(manager)
                last_ckpt = master.step

        master.save_checkpoint(manager)
        val = master.validate(*load_val_split(config, scene, device))
        logger.info("final val %s", val)

        # The fused model for the eval CLI and viewers (the reference
        # evaluator merges per-block checkpoints; this exports at train end).
        export_dir = os.path.join(out_root, "export")
        os.makedirs(export_dir, exist_ok=True)
        model = master.global_model()
        save_gaussian_ply(os.path.join(export_dir, "point_cloud.ply"), model.params, model.alive)
        save_splat(os.path.join(export_dir, "model.splat"), model.params, model.alive)
        logger.info("exported fused model (%d gaussians) to %s", int(model.num_alive), export_dir)
        return val
    finally:
        master.close()


def experiment_name(config, scene: str, suffix: str = "") -> str:
    """train_admm.py's experiment name: <field>_<task>_<dataset>_<scene>_admm[_<suffix>]."""
    name = f"{config.get('neural_field_type', 'gs')}_{config.get('task', 'nvs')}_{config.dataset.name}_{scene}_admm"
    return f"{name}_{suffix}" if suffix else name


def main(argv: list[str] | None = None) -> None:
    args = config_parser().parse_args(argv)
    config = load_config(args.config, cli_overrides=[o for o in args.opts if "=" in o])
    scenes = config.dataset.scene
    if args.scene:
        scenes = [args.scene]
    elif isinstance(scenes, str):
        scenes = [scenes]
    for scene in scenes:
        cfg = copy.deepcopy(config)
        cfg.dataset.scene = scene
        cfg.expname = experiment_name(cfg, scene, args.suffix)
        logger.info("=== ADMM block training %s ===", cfg.expname)
        train_scene(cfg, scene)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s %(message)s")
    main(sys.argv[1:])
