"""Write a COLMAP scene rendered from a Gaussian model, with known
per-image perturbations, for training the port on a real-data path.

    python -m dogs_tpu_torch.tools.colmap_scene OUT_DIR [--device cpu] [--format {png,jpeg,jpeg-progressive}]

writes OUT_DIR/scene/{images/*.png, sparse/0/{cameras,images,points3D}.bin}
from bench.py's scene model (random weights from a seed, SH degree 3; the
CLI's is CLI_GAUSSIANS Gaussians at CLI_IMAGES cameras of CLI_WIDTH x
CLI_HEIGHT, a CPU-sized scene) at cameras like bench.py's (looking into the
scene box, centres spread on a small arc). `--format jpeg` writes
images/*.JPG instead: the first JPEG_420_IMAGES at 4:2:0 and quality 95,
the rest at 4:2:2 and quality 90 with a restart marker every MCU row, as
drone cameras write them; `--format jpeg-progressive` writes the same
settings as progressive files (the same quantized coefficients, so they
decode to the baseline files' pixels), as web and phone exports write
them. Every image but image 0 (the gauge) carries a
known 3x4 exposure near identity, a smooth multiplicative shading and pose
noise on its stored pose; all images are distorted by the OPENCV camera's
k1 and upsampled (x2 by default) before they are written, so that
`load_scene` at that factor runs the minify and undistort caches. The files
are written on a pool of threads (the encoders release the interpreter
lock). `write_scene` returns the truth: each image's exposure and the pose
delta that undoes its noise, in the trainer's convention (R' = dR R, t' =
dR t + dt).
"""

from __future__ import annotations

import argparse
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from dogs_tpu_torch.core.camera import Camera, make_camera
from dogs_tpu_torch.core.gaussians import GaussianParams
from dogs_tpu_torch.core.sh import C0
from dogs_tpu_torch.core.transforms import rotmat_to_quat, so3_exp
from dogs_tpu_torch.data import colmap
from dogs_tpu_torch.data.synthetic import bench_scene
from dogs_tpu_torch.raster.tiled import RasterConfig, render_tiled
from dogs_tpu_torch.train.trainer import apply_exposure
from dogs_tpu_torch.utils.jpeg import write_jpeg
from dogs_tpu_torch.utils.png import write_png


UPSAMPLE = 2  # written images are this many times the rendered size (the default)
JPEG_420_IMAGES = 9  # --format jpeg: images 0-8 at 4:2:0, quality 95; the rest at 4:2:2, quality 90
FORMATS = ("png", "jpeg", "jpeg-progressive")
K1 = -0.02  # OPENCV radial distortion (barrel: every pixel stays in frame)
EXPOSURE_SIGMA = 0.03  # of each 3x3 entry; the offsets get half
SHADING = 0.05  # amplitude of the smooth multiplicative field
ROT_NOISE, TRANS_NOISE = 3e-4, 3e-4  # pose noise, radians and scene units
POINT_JITTER = 0.01  # of the points3D positions around the model's means
CLI_GAUSSIANS, CLI_IMAGES, CLI_WIDTH, CLI_HEIGHT = 20000, 17, 288, 216  # the CLI's scene


def scene_cameras(n: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """(R, t) world->camera of bench.py's rotations (about +-5 deg of yaw and
    pitch) at centres spread over about +-0.5 in x and +-0.16 in y (a camera
    extent, so the spatial learning rate is not 0)."""
    out = []
    for i in range(n):
        a = (i - n / 2) * 0.02
        b = ((i * 7) % n - n / 2) * 0.012
        ry = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        rx = np.array([[1, 0, 0], [0, np.cos(b), -np.sin(b)], [0, np.sin(b), np.cos(b)]])
        R = ry @ rx
        centre = np.array([(i - (n - 1) / 2) / max(n - 1, 1), 0.02 * ((i * 5) % n - n / 2), 0.0])
        out.append((R, -R @ centre))
    return out


def _distort(img: torch.Tensor, fx: float, fy: float, cx: float, cy: float, k1: float) -> torch.Tensor:
    """The image a lens with radial k1 records of the pinhole image `img`:
    each output pixel samples `img` at its undistorted position (the radial
    model inverted by fixed-point iteration), bilinear, zero outside."""
    h, w, _ = img.shape
    v, u = torch.meshgrid(torch.arange(h, device=img.device, dtype=torch.float32),
                          torch.arange(w, device=img.device, dtype=torch.float32), indexing="ij")
    xd, yd = (u - cx) / fx, (v - cy) / fy
    x, y = xd, yd
    for _ in range(20):
        radial = 1.0 + k1 * (x * x + y * y)
        x, y = xd / radial, yd / radial
    grid = torch.stack([(x * fx + cx) / (w - 1) * 2 - 1, (y * fy + cy) / (h - 1) * 2 - 1], dim=-1)
    out = F.grid_sample(img.permute(2, 0, 1)[None], grid[None], mode="bilinear", padding_mode="zeros",
                        align_corners=True)
    return out[0].permute(1, 2, 0)


def write_image(path: str, img: np.ndarray, i: int, fmt: str) -> None:
    """Image i of a scene in format `fmt` (one of FORMATS): PNG at zlib
    level 1, or JPEG as the module docstring says."""
    progressive = fmt == "jpeg-progressive"
    if fmt == "png":
        write_png(path, img, level=1)
    elif i < JPEG_420_IMAGES:
        write_jpeg(path, img, quality=95, subsampling="4:2:0", progressive=progressive)
    else:
        write_jpeg(path, img, quality=90, subsampling="4:2:2", restart_interval=-(-img.shape[1] // 16),
                   progressive=progressive)


def write_scene(root: str, params: GaussianParams, cameras: list[Camera], fmt: str = "png",
                upsample: int = UPSAMPLE) -> dict[str, np.ndarray]:
    """Render `params` at each camera and write the scene under `root` (see
    the module docstring), its images `upsample` times the cameras' size as
    `fmt` files (one of FORMATS). Returns {"exposure": (n, 3, 4),
    "pose_delta": (n, 6)}: image i's true exposure and the delta [rho, w]
    that maps its stored pose onto the rendered one (identity and zeros for
    image 0)."""
    if fmt not in FORMATS:
        raise ValueError(f"format {fmt!r}: expected one of {FORMATS}")
    rng = np.random.RandomState(0)
    n = len(cameras)
    cam0 = cameras[0]
    w, h = cam0.width, cam0.height
    fx, fy, cx, cy = (float(getattr(cam0, k)) for k in ("fx", "fy", "cx", "cy"))
    model_dir = os.path.join(root, "sparse", "0")
    image_dir = os.path.join(root, "images")
    os.makedirs(model_dir, exist_ok=True)
    os.makedirs(image_dir, exist_ok=True)
    exposure = np.tile(np.eye(3, 4, dtype=np.float32)[None], (n, 1, 1))
    pose_delta = np.zeros((n, 6), np.float32)
    images = {}
    writes = []
    with ThreadPoolExecutor(8) as pool:  # every write is waited for, also when a render fails
        for i, cam in enumerate(cameras):
            with torch.no_grad():
                img = torch.clamp(render_tiled(params, cam, RasterConfig(), active_sh_degree=3).image, 0.0, 1.0)
            R, t = cam.R.cpu().numpy().astype(np.float64), cam.t.cpu().numpy().astype(np.float64)
            if i > 0:
                exposure[i, :, :3] += rng.randn(3, 3).astype(np.float32) * EXPOSURE_SIGMA
                exposure[i, :, 3] = rng.randn(3).astype(np.float32) * EXPOSURE_SIGMA / 2
                f = rng.uniform(0.5, 1.5, 2)
                phase = rng.uniform(0, 2 * np.pi, 2)
                ys = torch.linspace(0, 1, h, device=img.device)[:, None]
                xs = torch.linspace(0, 1, w, device=img.device)[None, :]
                field = 1.0 + SHADING * torch.sin(2 * np.pi * f[0] * xs + phase[0]) * torch.cos(2 * np.pi * f[1] * ys
                                                                                              + phase[1])
                img = torch.clamp(apply_exposure(img, torch.as_tensor(exposure[i], device=img.device))
                                  * field[..., None], 0.0, 1.0)
                pose_delta[i, :3] = rng.randn(3) * TRANS_NOISE
                pose_delta[i, 3:] = rng.randn(3) * ROT_NOISE
                dR = so3_exp(torch.as_tensor(pose_delta[i, 3:], dtype=torch.float64)).numpy()
                R, t = dR.T @ R, dR.T @ (t - pose_delta[i, :3].astype(np.float64))
            img = _distort(img, fx, fy, cx, cy, K1)
            big = F.interpolate(img.permute(2, 0, 1)[None], scale_factor=upsample, mode="bilinear",
                                align_corners=False)[0].permute(1, 2, 0)
            name = f"frame_{i:03d}." + ("png" if fmt == "png" else "JPG")
            writes.append(pool.submit(write_image, os.path.join(image_dir, name),
                                      torch.clamp(big * 255.0 + 0.5, 0, 255).to(torch.uint8).cpu().numpy(), i, fmt))
            images[i + 1] = colmap.ColmapImage(i + 1, rotmat_to_quat(torch.as_tensor(R)).numpy(), t, 1, name)
        for job in writes:
            job.result()
    s = float(upsample)
    colmap.write_cameras_bin(os.path.join(model_dir, "cameras.bin"), {1: colmap.ColmapCamera(
        1, "OPENCV", w * upsample, h * upsample, np.array([fx * s, fy * s, cx * s, cy * s, K1, 0.0, 0.0, 0.0]))})
    colmap.write_images_bin(os.path.join(model_dir, "images.bin"), images)
    xyz = params.xyz.detach().cpu().numpy().astype(np.float64)
    rgb = np.clip((params.feat_dc.detach().cpu().numpy()[:, 0] * C0 + 0.5) * 255.0, 0, 255).astype(np.uint8)
    colmap.write_points3d_bin(os.path.join(model_dir, "points3D.bin"),
                              xyz + rng.randn(*xyz.shape) * POINT_JITTER, rgb)
    return {"exposure": exposure, "pose_delta": pose_delta}


def make_cameras(n: int, width: int, height: int, focal: float, device: torch.device | str = "cuda") -> list[Camera]:
    return [make_camera(R, t, focal, focal, width / 2, height / 2, width, height, image_index=i, device=device)
            for i, (R, t) in enumerate(scene_cameras(n))]


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--format", choices=FORMATS, default="png")
    args = ap.parse_args(argv)
    focal = 1000.0 * CLI_WIDTH / 1152  # bench.py's field of view
    cams = make_cameras(CLI_IMAGES, CLI_WIDTH, CLI_HEIGHT, focal, args.device)
    write_scene(os.path.join(args.out_dir, "scene"), bench_scene(CLI_GAUSSIANS, seed=0, device=args.device), cams,
                fmt=args.format)
    print(f"wrote {CLI_IMAGES} images of {CLI_WIDTH * UPSAMPLE}x{CLI_HEIGHT * UPSAMPLE} ({args.format}) to "
          f"{os.path.join(args.out_dir, 'scene')}")


if __name__ == "__main__":
    main()
