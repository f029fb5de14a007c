"""Eval CLI of the port (the port of the root eval.py).

    python -m dogs_tpu_torch.eval --config config/gaussian_splatting/synthetic_smoke.yaml \
        [--scene toy] [--suffix run1] [key=value ...]

Per scene of `dataset.scene`: builds the trainer with
`dogs_tpu_torch.factory.create_trainer`, loads the experiment's latest
checkpoint, scores the val split (PSNR, SSIM, LPIPS; metrics.json and PNG
renders under <root_dir>/<expname>/eval/val), exports .splat / .ply / the
COLMAP point cloud to <root_dir>/<expname>/export, and renders the spheric
test trajectory (`eval.n_test_poses` frames at `eval.test_radius`) to
eval/test. `device=cpu` runs on the CPU (the default is the card). Works
on the synthetic scene and on COLMAP scenes (PNG images on a machine
without PIL). A block-parallel ADMM run (`dataset.multi_blocks`, trained by
`python -m dogs_tpu_torch.train_admm`) is scored by `evaluate_admm`: the
fused model rebuilt from its block checkpoint on one device, the val split,
metrics.json and the exports, as eval.py's evaluate_admm does (no test
trajectory). A Scaffold-GS run (`neural_field_type: scaffold_gs`) is scored
through `ScaffoldEvaluator`, as eval.py scores it.
"""

from __future__ import annotations

import copy
import logging
import os
import sys
from typing import Sequence

import torch

from dogs_tpu_torch.core.camera import Camera
from dogs_tpu_torch.core.gaussians import GaussianParams
from dogs_tpu_torch.core.sh import rgb_to_sh
from dogs_tpu_torch.eval.evaluator import EvalConfig, GaussianSplatEvaluator
from dogs_tpu_torch.factory import _raster_config, create_trainer
from dogs_tpu_torch.fields.model import GaussianModelState, fresh_stats
from dogs_tpu_torch.fields.scaffold import ScaffoldGSTrainer, ScaffoldParams, generate_neural_gaussians, render_scaffold
from dogs_tpu_torch.parallel.master import load_fused_from_checkpoint, load_manifest_partition
from dogs_tpu_torch.raster.tiled import RasterConfig
from dogs_tpu_torch.train.checkpoint import CheckpointManager
from dogs_tpu_torch.train_admm import load_val_split
from dogs_tpu_torch.utils.config import config_parser, load_config

logger = logging.getLogger("dogs_tpu_torch.eval")


def _eval_config(config) -> EvalConfig:
    """Output under <root_dir>/<expname>/eval, color correction from
    `eval.color_correct` (default: the val split only), all SH degrees."""
    out_root = os.path.join(config.get("root_dir", "out"), config.get("expname", "exp"))
    cc = config.get("eval", {}).get("color_correct", None)
    return EvalConfig(
        output_dir=os.path.join(out_root, "eval"),
        apply_color_correction=None if cc is None else bool(cc),
        active_sh_degree=int(config.texture.get("max_sh_degree", 3)),
    )


class ScaffoldEvaluator(GaussianSplatEvaluator):
    """eval.py's ScaffoldEvaluator: a Scaffold-GS render is decoded per view
    from the anchor MLPs, so `render` decodes at each camera (with the
    frustum prefilter and the configured background); `model`, which the
    export and the metrics' `num_points` read, is the decode at a canonical
    camera (the first val camera) with the decoded colours as SH DC
    coefficients and no higher bands."""

    def __init__(self, sp: ScaffoldParams, alive: torch.Tensor, raster_cfg: RasterConfig, cfg: EvalConfig,
                 cameras: Sequence[Camera]):
        self.sp, self.alive = sp, alive
        self.raster_cfg, self.cfg = raster_cfg, cfg
        self.device = alive.device
        self._export_camera = cameras[0] if cameras else None

    @torch.no_grad()
    def render(self, camera: Camera) -> torch.Tensor:
        out = render_scaffold(self.sp, camera, self.raster_cfg, alive=self.alive,
                              background=torch.tensor(self.cfg.background, dtype=torch.float32, device=self.device))
        return torch.clamp(out.image, 0.0, 1.0)

    @property
    @torch.no_grad()
    def model(self) -> GaussianModelState:
        g, colors, alive = generate_neural_gaussians(self.sp, self._export_camera, alive=self.alive)
        params = GaussianParams(xyz=g.xyz, feat_dc=rgb_to_sh(colors)[:, None, :], feat_rest=g.feat_rest,
                                log_scale=g.log_scale, quat=g.quat, logit_opacity=g.logit_opacity)
        return GaussianModelState(params, alive, *fresh_stats(params.capacity, self.device))


def create_evaluator(config, trainer) -> GaussianSplatEvaluator:
    """The evaluator of a trained model, configured as eval.py configures it."""
    if isinstance(trainer, ScaffoldGSTrainer):
        return ScaffoldEvaluator(trainer.state.params, trainer.state.alive, trainer.raster_cfg, _eval_config(config),
                                 trainer.val_cameras)
    return GaussianSplatEvaluator(trainer.state.model, trainer.raster_cfg, _eval_config(config))


def evaluate_admm(config) -> dict:
    """Evaluate a block-parallel ADMM run (eval.py:85-127): the fused global
    model rebuilt from the run's block checkpoint (trainer.ckpt_path, else
    the latest) on one device, scored on the val split and exported. Returns
    the val metrics ({} when there is no checkpoint)."""
    device = config.get("device", "cuda")
    scene = config.dataset.scene
    ds = config.dataset
    _, partition = load_manifest_partition(os.path.join(ds.root_dir, scene), int(ds.get("mx", 2)),
                                           int(ds.get("my", 2)))
    out_root = os.path.join(config.get("root_dir", "out"), config.get("expname", "exp"))
    ckpt = config.trainer.get("ckpt_path", "") or CheckpointManager(os.path.join(out_root, "model")).latest_path()
    if not ckpt:
        logger.warning("no ADMM checkpoint found for %s", config.expname)
        return {}
    model = load_fused_from_checkpoint(ckpt, partition, device)
    logger.info("fused model: %d gaussians from %s", int(model.num_alive), ckpt)
    evaluator = GaussianSplatEvaluator(model, _raster_config(config), _eval_config(config))
    result = evaluator.eval(*load_val_split(config, scene, device), split="val")
    evaluator.export(os.path.join(out_root, "export"))
    logger.info("val mean: %s", result["mean"])
    return result


def evaluate(config) -> dict:
    """Evaluate, export and render the trajectory of one experiment;
    returns the val metrics."""
    if bool(config.dataset.get("multi_blocks", False)):
        return evaluate_admm(config)
    trainer, ckpt_manager, writer = create_trainer(config)
    if writer is not None:
        writer.close()
    step = trainer.load_checkpoint(ckpt_manager)
    if step == 0:
        logger.warning("no checkpoint found for %s", config.expname)
    evaluator = create_evaluator(config, trainer)
    result = evaluator.eval(trainer.val_cameras, trainer.val_images, split="val", step=step)
    out_root = os.path.join(config.get("root_dir", "out"), config.get("expname", "exp"))
    evaluator.export(os.path.join(out_root, "export"))
    eval_cfg = config.get("eval", {})
    if trainer.val_cameras and bool(eval_cfg.get("test_trajectory", True)):
        evaluator.eval_test_trajectory(
            trainer.val_cameras[0],
            n_poses=int(eval_cfg.get("n_test_poses", 30)),
            radius=float(eval_cfg.get("test_radius", 3.0)),
        )
    logger.info("val mean: %s", result["mean"])
    return result


def main(argv: list[str] | None = None) -> None:
    args = config_parser().parse_args(argv)
    overrides = [o for o in args.opts if "=" in o]
    config = load_config(args.config, cli_overrides=overrides)
    scenes = config.dataset.scene
    if args.scene:
        scenes = [args.scene]
    elif isinstance(scenes, str):
        scenes = [scenes]
    for scene in scenes:
        cfg = copy.deepcopy(config)
        cfg.dataset.scene = scene
        expname = f"{cfg.get('neural_field_type', 'gs')}_{cfg.get('task', 'nvs')}_{cfg.dataset.name}_{scene}"
        if bool(cfg.dataset.get("multi_blocks", False)):
            expname += "_admm"  # train_admm.py's experiment naming
        if args.suffix:
            expname += f"_{args.suffix}"
        cfg.expname = expname
        logger.info("=== evaluating %s ===", expname)
        evaluate(cfg)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s %(message)s")
    main(sys.argv[1:])
