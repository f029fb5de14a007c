#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dogs_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving path -- GaussianSplatEvaluator.render / eval ->
render_tiled -> projection, tile binning, the hand-written blend kernel,
background compositing, PSNR/SSIM -- on bench.py's model (500k Gaussians,
SH degree 3, 1152x864, 8 cameras, random weights from a seed), in phases:

  1. device   require CUDA; print the card's name and power limit
  2. build    compile the blend kernel from dogs_tpu_torch/csrc with nvcc
  3. parity   kernel against its plain PyTorch version on the card: small
              scenes at atol 3e-4; the 8 bench frames at 99.9% of pixels
              within 3e-3 (alpha 5e-3) of the frame's max, none past 0.05
  4. serve    evaluator renders the 8 cameras for a few rounds and writes
              metrics.json against GT rendered by the plain path (PSNR >= 50)
  5. report   per-kernel JSON line, then the device JSON line (last line)

Any failed phase raises, so the exit code is non-zero. Imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SMALL_ATOL = 3e-4
ROUNDS = 3  # serving rounds over the 8 bench cameras
PSNR_MIN = 50.0


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def mostly_close(b: torch.Tensor, a: torch.Tensor, atol: float, frac=0.999, max_out=0.05) -> float:
    """Hardware-parity bar of tests/tpu/test_tpu_raster.py: differences are
    scaled by the reference's max |value|; rounding in exp/log can flip an
    entry across the 1/255 or T < 1e-4 cutoffs at a few pixels, a bug moves
    many. Returns the max absolute difference."""
    d_abs = (b - a).abs()
    d = d_abs / (a.abs().max() + 1e-8)
    ok = float((d <= atol).float().mean())
    check(ok >= frac, f"only {ok:.5f} of pixels within {atol} (need {frac})")
    check(float(d.max()) <= max_out, f"worst outlier {float(d.max()):.4f} > {max_out}")
    return float(d_abs.max())


def cuda_ms(fn, iters: int) -> float:
    """Mean device ms per call from CUDA events around `iters` calls."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing was run", file=sys.stderr)
        return 1

    from dogs_tpu_torch.core import look_at_camera, params_from_numpy
    from dogs_tpu_torch.data import synthetic
    from dogs_tpu_torch.eval.evaluator import EvalConfig, GaussianSplatEvaluator
    from dogs_tpu_torch.fields.model import GaussianModelState
    from dogs_tpu_torch.raster import blend
    from dogs_tpu_torch.raster.binning import build_tile_bins
    from dogs_tpu_torch.raster.projection import project_gaussians
    from dogs_tpu_torch.raster.tiled import RasterConfig, render_tiled, sorted_entries

    dev = torch.device("cuda", 0)
    # Full-f32 references: matmuls and convolutions without TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. device ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[device] {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
          f"| CUDA {torch.version.cuda} | python {sys.version.split()[0]}")

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _, build_log = blend.build_kernel()
    print(f"[build] blend_forward built/loaded in {time.perf_counter() - t0:.2f} s")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] ptxas: {line.strip()}")

    cfg = RasterConfig()
    plain_cfg = RasterConfig(use_kernel=False)

    def frame_inputs(params, cam, sh_degree, mt=cfg.max_tiles_per_gaussian):
        proj = project_gaussians(params, cam, active_sh_degree=sh_degree)
        bins = build_tile_bins(proj, cam.height, cam.width, max_tiles_per_gaussian=mt)
        ent = sorted_entries(proj, bins)
        nty, ntx = -(-cam.height // blend.TILE), -(-cam.width // blend.TILE)
        return (ent, bins.tile_starts, nty, ntx, cam.width, cam.height)

    # ---- 3. kernel against plain on the card -------------------------------
    small = {
        "random_seed0": (synthetic.random_scene_arrays(seed=0), synthetic.RANDOM_SCENE_VIEW, 2),
        "random_seed3": (synthetic.random_scene_arrays(seed=3), synthetic.RANDOM_SCENE_VIEW, 2),
        "saturation": (synthetic.saturation_scene_arrays(), synthetic.SATURATION_SCENE_VIEW, 1),
        "empty_tiles": (
            synthetic.random_scene_arrays(n=16, seed=2, spread=0.3), synthetic.RANDOM_SCENE_VIEW, 2
        ),
        "non_aligned_200x130": (
            synthetic.random_scene_arrays(n=400, seed=5),
            dict(synthetic.RANDOM_SCENE_VIEW, width=200, height=130, fx=120.0, fy=120.0), 2,
        ),
    }
    max_err = 0.0
    with torch.no_grad():
        for name, (arrays, view, deg) in small.items():
            params = params_from_numpy(arrays, dev)
            args = frame_inputs(params, look_at_camera(**view, device=dev), deg, mt=36)
            got = blend.blend_forward(*args)
            want = blend.blend_forward_reference(*args)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), f"{name}: non-finite kernel output")
            err = float((got - want).abs().max())
            empty = int((args[1][1:] == args[1][:-1]).sum())
            print(f"[parity] {name}: K={args[0].shape[0]} empty_tiles={empty} max|d|={err:.3e}")
            check(err <= SMALL_ATOL, f"{name}: kernel vs plain max|d| {err} > {SMALL_ATOL}")
            max_err = max(max_err, err)

        params = synthetic.bench_scene(device=dev)
        n = params.capacity
        cams = synthetic.bench_cameras(8, device=dev)
        gts = []
        for i, cam in enumerate(cams):
            ref = render_tiled(params, cam, plain_cfg)
            out = render_tiled(params, cam, cfg)
            torch.cuda.synchronize()
            errs = {
                "image": mostly_close(out.image, ref.image, 3e-3),
                "alpha": mostly_close(out.alpha, ref.alpha, 5e-3),
                "invdepth": mostly_close(out.invdepth, ref.invdepth, 3e-3),
            }
            check(tuple(out.image.shape) == (cam.height, cam.width, 3), "bad image shape")
            check(bool(torch.isfinite(out.image).all()), f"bench cam {i}: non-finite image")
            max_err = max(max_err, *errs.values())
            print(f"[parity] bench cam {i}: K={out.bin_valid} truncated={out.bin_rect_truncated} "
                  + " ".join(f"max|d| {k}={v:.3e}" for k, v in errs.items()))
            gts.append(torch.clamp(ref.image, 0.0, 1.0))

    # ---- 4. serve ----------------------------------------------------------
    model = GaussianModelState(
        params=params,
        alive=torch.ones(n, dtype=torch.bool, device=dev),
        grad_accum=torch.zeros(n, device=dev),
        denom=torch.zeros(n, device=dev),
        max_radii2d=torch.zeros(n, device=dev),
    )
    torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory() as tmp:
        evaluator = GaussianSplatEvaluator(
            model, cfg, EvalConfig(output_dir=tmp, save_images=False)
        )
        blend.blend_forward.launches = 0
        frame_ms = []
        for _ in range(ROUNDS):
            for cam in cams:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                img = evaluator.render(cam)
                torch.cuda.synchronize()
                frame_ms.append((time.perf_counter() - t0) * 1e3)
        metrics = evaluator.eval(cams, gts, split="val")
        launches = blend.blend_forward.launches
        with open(f"{tmp}/val/metrics.json") as f:
            written = json.load(f)
    check(launches == (ROUNDS + 1) * len(cams),
          f"blend kernel launched {launches} times, expected {(ROUNDS + 1) * len(cams)}")
    check(tuple(img.shape) == (864, 1152, 3) and bool(torch.isfinite(img).all()), "bad render")
    mean = metrics["mean"]
    check(written["mean"] == mean, "metrics.json differs from the returned metrics")
    check(mean["psnr"] >= PSNR_MIN, f"eval PSNR {mean['psnr']:.2f} dB < {PSNR_MIN}")
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20
    warm = frame_ms[len(cams):]  # first round includes lazy init
    print(f"[serve] {len(frame_ms)} frames: ms/frame median {np.median(warm):.2f} "
          f"min {min(warm):.2f} (first round median {np.median(frame_ms[:len(cams)]):.2f}); "
          f"eval psnr {mean['psnr']:.2f} dB ssim {mean['ssim']:.5f} "
          f"render_time {mean['render_time'] * 1e3:.2f} ms; peak memory {peak_mb:.0f} MiB")

    # Blend alone on bench camera 0 (after the counted run: not counted).
    with torch.no_grad():
        args = frame_inputs(params, cams[0], 3)
        kernel_ms = cuda_ms(lambda: blend.blend_forward(*args), iters=50)
        plain_ms = cuda_ms(lambda: blend.blend_forward_reference(*args), iters=3)
        kernel_ms_2 = cuda_ms(lambda: blend.blend_forward(*args), iters=50)
        plain_ms_2 = cuda_ms(lambda: blend.blend_forward_reference(*args), iters=3)
    print(f"[serve] blend on bench cam 0: K={args[0].shape[0]} entries, kernel "
          f"{kernel_ms:.3f}/{kernel_ms_2:.3f} ms, plain {plain_ms:.3f}/{plain_ms_2:.3f} ms")

    # ---- 5. report ---------------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "blend_forward",
        "route": "cuda",
        "source": "dogs_tpu_torch/csrc/blend_forward.cu",
        "replaces": "dogs_tpu/raster/pallas_stream.py:241",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": min(kernel_ms, kernel_ms_2),
        "plain_ms": min(plain_ms, plain_ms_2),
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
