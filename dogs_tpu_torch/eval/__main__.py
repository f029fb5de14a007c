"""Eval CLI of the port (the port of the root eval.py, for `neural_field_type: gs`).

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
without PIL). Block-parallel ADMM runs (`dataset.multi_blocks`) and
Scaffold-GS raise `NotImplementedError` from the factory.
"""

from __future__ import annotations

import copy
import logging
import os
import sys

from dogs_tpu_torch.eval.evaluator import EvalConfig, GaussianSplatEvaluator
from dogs_tpu_torch.factory import create_trainer
from dogs_tpu_torch.utils.config import config_parser, load_config

logger = logging.getLogger("dogs_tpu_torch.eval")


def create_evaluator(config, trainer) -> GaussianSplatEvaluator:
    """The evaluator of a trained model, configured as eval.py configures
    it: output under <root_dir>/<expname>/eval, color correction from
    `eval.color_correct` (default: the val split only), all SH degrees."""
    out_root = os.path.join(config.get("root_dir", "out"), config.get("expname", "exp"))
    cc = config.get("eval", {}).get("color_correct", None)
    cfg = EvalConfig(
        output_dir=os.path.join(out_root, "eval"),
        apply_color_correction=None if cc is None else bool(cc),
        active_sh_degree=int(config.texture.get("max_sh_degree", 3)),
    )
    return GaussianSplatEvaluator(trainer.state.model, trainer.raster_cfg, cfg)


def evaluate(config) -> dict:
    """Evaluate, export and render the trajectory of one experiment;
    returns the val metrics."""
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
