"""Train CLI of the port (the port of the root train.py).

    python -m dogs_tpu_torch.train --config config/gaussian_splatting/synthetic_smoke.yaml \
        [--scene toy] [--suffix run1] [key=value ...]

Per-scene loop over `dataset.scene`: builds the trainer with
`dogs_tpu_torch.factory.create_trainer`, resumes when `trainer.resume` or
`trainer.ckpt_path` is set, trains with the configured cadences, writes a
final checkpoint and logs the final validation. `device=cpu` runs on the
CPU (the default is the card). Trains the synthetic scene and COLMAP scenes
(every shipped gaussian_splatting and scaffold_gs config; PNG images on a
machine without PIL) on one device; a `dataset.multi_blocks` config
(block-parallel ADMM, whose blocks train with `python -m
dogs_tpu_torch.train_admm`) trains its whole scene on one device, as
train.py does.
"""

from __future__ import annotations

import copy
import logging
import sys

from dogs_tpu_torch.factory import create_trainer
from dogs_tpu_torch.utils.config import config_parser, load_config

logger = logging.getLogger("dogs_tpu_torch.train")


def train(config) -> None:
    trainer, ckpt_manager, writer = create_trainer(config)
    try:
        if config.trainer.get("ckpt_path", "") or config.trainer.get("resume", False):
            start = trainer.load_checkpoint(ckpt_manager, config.trainer.get("ckpt_path") or None)
            if start:
                logger.info("resumed from step %d", start)
        remaining = int(config.trainer.max_iterations) - trainer.state.step
        if remaining <= 0:
            logger.info("nothing to do (max_iterations reached)")
            return
        trainer.train(
            num_iterations=remaining,
            log_every=int(config.trainer.get("n_tensorboard", 100)),
            validate_every=int(config.trainer.get("n_validation", 0)),
            checkpoint_every=int(config.trainer.get("n_checkpoint", 0)),
            checkpoint_manager=ckpt_manager,
            tensorboard_writer=writer,
        )
        trainer.save_checkpoint(ckpt_manager)
        val = trainer.validate()
        if val:
            logger.info("final val: %s", val)
    finally:
        if writer is not None:
            writer.close()


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
        if args.suffix:
            expname += f"_{args.suffix}"
        cfg.expname = expname
        logger.info("=== training %s ===", expname)
        train(cfg)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s %(message)s")
    main(sys.argv[1:])
