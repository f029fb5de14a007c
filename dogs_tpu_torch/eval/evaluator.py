"""Evaluator: render a split, score it, export the model, render a trajectory.

Port of dogs_tpu/eval/evaluator.py's GaussianSplatEvaluator: PSNR, SSIM and
LPIPS per image with the render time and peak device memory, written to
metrics.json with the renders as PNGs (utils/png.py: no imageio needed);
.splat / .ply / COLMAP point-cloud export (fields/io.py); the spheric test
trajectory as PNG frames, plus a GIF where imageio is installed. Renders
stay on the model's device as tensors, and the metrics run there too.
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

from dogs_tpu_torch.core.camera import Camera, make_camera
from dogs_tpu_torch.data.dataset import spheric_test_poses
from dogs_tpu_torch.eval.metrics import color_correct, lpips, psnr, ssim
from dogs_tpu_torch.fields.io import save_colmap_ply, save_gaussian_ply, save_splat
from dogs_tpu_torch.fields.model import GaussianModelState
from dogs_tpu_torch.raster.tiled import RasterConfig, render_tiled
from dogs_tpu_torch.utils.png import write_png

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class EvalConfig:
    output_dir: str = "eval"
    save_images: bool = True
    # None: color-correct the val split, not test (as dogs_tpu does).
    apply_color_correction: bool | None = None
    compute_lpips: bool = True
    export_models: bool = True
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
        on the card), on CUDA peak device memory in MB, and `lpips` (or
        `lpips_uncalibrated` with the fallback filters)."""
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
            if self.cfg.compute_lpips:
                val, calibrated = lpips(pred, gt)
                entry["lpips" if calibrated else "lpips_uncalibrated"] = float(val)
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

    def eval_test_trajectory(
        self,
        reference_camera: Camera,
        n_poses: int = 60,
        radius: float = 3.0,
        split: str = "test",
        fps: int = 15,
    ) -> str | None:
        """Render the spheric test trajectory (`spheric_test_poses`) with the
        reference camera's intrinsics: PNG frames <output_dir>/<split>/NNNNN.png
        when save_images is set, and trajectory.gif when imageio is
        installed. Returns the GIF's path, or None when there is no GIF."""
        out_dir = os.path.join(self.cfg.output_dir, split)
        os.makedirs(out_dir, exist_ok=True)
        intrinsics = [float(getattr(reference_camera, k)) for k in ("fx", "fy", "cx", "cy")]
        frames = []
        for i, c2w in enumerate(spheric_test_poses(n_poses, radius)):
            R = c2w[:3, :3].T
            cam = make_camera(R, -R @ c2w[:3, 3], *intrinsics, reference_camera.width, reference_camera.height,
                              device=self.device)
            img = (self.render(cam) * 255).to(torch.uint8).cpu().numpy()
            frames.append(img)
            if self.cfg.save_images:
                write_png(os.path.join(out_dir, f"{i:05d}.png"), img)
        try:
            import imageio.v2 as imageio
        except ImportError:
            logger.info("[%s] rendered %d frames; imageio is not installed, so no GIF was written", split,
                        len(frames))
            return None
        gif = os.path.join(out_dir, "trajectory.gif")
        imageio.mimwrite(gif, frames, duration=1000.0 / fps, loop=0)
        logger.info("[%s] wrote %d frames + %s", split, len(frames), gif)
        return gif

    def export(self, out_dir: str, name: str = "model") -> None:
        """<name>.splat, the 3DGS <name>.ply and the COLMAP-style point cloud
        <name>_points.ply of the alive Gaussians, when export_models is set
        (gaussian_splatting_evaluator.py:182-194)."""
        if not self.cfg.export_models:
            return
        os.makedirs(out_dir, exist_ok=True)
        params, alive = self.model.params, self.model.alive
        save_splat(os.path.join(out_dir, f"{name}.splat"), params, alive)
        save_gaussian_ply(os.path.join(out_dir, f"{name}.ply"), params, alive)
        save_colmap_ply(os.path.join(out_dir, f"{name}_points.ply"), params, alive)

    @staticmethod
    def _save_image(path: str, img: torch.Tensor) -> None:
        write_png(path, (torch.clamp(img, 0, 1) * 255).to(torch.uint8).cpu().numpy())
