"""Evaluator: render a split, compute PSNR/SSIM, write metrics.json.

Port of the render/eval part of dogs_tpu/eval/evaluator.py. Renders stay
on the model's device as tensors, and the metrics run there too. LPIPS,
model export and the test trajectory are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Sequence

import numpy as np
import torch

from dogs_tpu_torch.core.camera import Camera
from dogs_tpu_torch.eval.metrics import color_correct, psnr, ssim
from dogs_tpu_torch.fields.model import GaussianModelState
from dogs_tpu_torch.raster.tiled import RasterConfig, render_tiled

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class EvalConfig:
    output_dir: str = "eval"
    save_images: bool = True
    # None: color-correct the val split, not test (as dogs_tpu does).
    apply_color_correction: bool | None = None
    compute_lpips: bool = False  # LPIPS is not ported yet: True raises
    background: tuple = (0.0, 0.0, 0.0)
    active_sh_degree: int = 3


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class GaussianSplatEvaluator:
    """Evaluates one Gaussian model on the device its parameters live on."""

    def __init__(
        self,
        model: GaussianModelState,
        raster_cfg: RasterConfig = RasterConfig(),
        cfg: EvalConfig = EvalConfig(),
    ):
        if cfg.compute_lpips:
            raise NotImplementedError(
                "LPIPS is not ported to dogs_tpu_torch yet (ROADMAP.md queue 1, "
                "item 10); set EvalConfig.compute_lpips=False"
            )
        self.model = model
        self.raster_cfg = raster_cfg
        self.cfg = cfg
        self.device = model.params.xyz.device

    @torch.no_grad()
    def render(self, camera: Camera) -> torch.Tensor:
        """(H, W, 3) image clipped to [0, 1], on the model's device. Records
        no autograd graph: the parameters are leaves that require grad."""
        out = render_tiled(
            self.model.params,
            camera,
            self.raster_cfg,
            background=torch.tensor(self.cfg.background, dtype=torch.float32, device=self.device),
            alive=self.model.alive,
            active_sh_degree=self.cfg.active_sh_degree,
        )
        return torch.clamp(out.image, 0.0, 1.0)

    def eval(
        self,
        cameras: Sequence[Camera],
        images: Sequence[np.ndarray | torch.Tensor],
        split: str = "val",
        step: int | None = None,
    ) -> dict:
        """Renders the split and writes <output_dir>/<split>/metrics.json
        with per-image and mean psnr, ssim, render_time (seconds, synchronized
        on the card) and, on CUDA, peak device memory in MB."""
        out_dir = os.path.join(self.cfg.output_dir, split)
        os.makedirs(out_dir, exist_ok=True)
        cc = self.cfg.apply_color_correction
        if cc is None:
            cc = split == "val"
        on_cuda = self.device.type == "cuda"
        per_image = []
        for i, (cam, gt) in enumerate(zip(cameras, images)):
            _sync(self.device)
            t0 = time.perf_counter()
            pred = self.render(cam)
            _sync(self.device)
            render_time = time.perf_counter() - t0
            if isinstance(gt, np.ndarray):
                gt = torch.from_numpy(np.array(gt, np.float32))  # owned, writable copy
            gt = gt.to(device=self.device, dtype=torch.float32)
            if cc:
                pred = color_correct(pred, gt)
            entry = {
                "image": i,
                "psnr": float(psnr(pred, gt)),
                "ssim": float(ssim(pred, gt)),
                "render_time": render_time,
            }
            if on_cuda:
                entry["memory"] = round(torch.cuda.max_memory_allocated(self.device) / 2**20, 1)
            per_image.append(entry)
            if self.cfg.save_images:
                self._save_image(os.path.join(out_dir, f"{i:05d}.png"), pred)
                self._save_image(os.path.join(out_dir, f"{i:05d}_gt.png"), gt)
        means = {
            k: float(np.mean([e[k] for e in per_image])) for k in per_image[0] if k != "image"
        }
        means["num_points"] = int(self.model.num_alive)
        if step is not None:
            means["step"] = int(step)
        result = {"mean": means, "per_image": per_image}
        with open(os.path.join(out_dir, "metrics.json"), "w") as f:
            json.dump(result, f, indent=2)
        logger.info("[%s] %s", split, means)
        return result

    @staticmethod
    def _save_image(path: str, img: torch.Tensor) -> None:
        import imageio.v2 as imageio

        arr = (torch.clamp(img, 0, 1) * 255).to(torch.uint8).cpu().numpy()
        imageio.imwrite(path, arr)
