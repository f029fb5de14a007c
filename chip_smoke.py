#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dogs_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths on bench.py's model (500k Gaussians, SH degree
3, 1152x864, 8 cameras, random weights from a seed): serving
(GaussianSplatEvaluator.render / eval -> render_tiled -> projection, tile
binning, the blend forward kernel, PSNR/SSIM/LPIPS), training
(make_train_step and GaussianSplatTrainer -> render_tiled forward, L1 +
D-SSIM loss, the blend backward kernel, the K->N index prep and the
segment-sum kernel, the projection VJP, sparse Adam, and the host loop's
densify events, opacity reset, capacity growth and checkpoints), the
LightGaussian importance prune (one VJP through all three kernels per
camera), export, the train and eval CLIs, and real-scene training (a COLMAP
scene through the data slice and the per-image loss terms), in phases:

  1. device   require CUDA; print the card's name and power limit
  2. build    compile the three kernels from dogs_tpu_torch/csrc with nvcc,
              in parallel; print build seconds and ptxas registers/spills/smem
  3. parity   each kernel against its plain PyTorch version on the card, on
              small scenes: blend forward at atol 3e-4; blend backward at
              max-normalized 2e-3 per column (depth_threshold 0 and 4.5);
              segment sum bit for bit ("f32" and "bf16"), and on one scene
              reduce_entries bit for bit against a CPU stable id sort + row
              gather + index_add_; two launches of the backward kernels
              give bit-identical outputs. Then the 8 bench frames forward at
              99.9% of pixels within 3e-3 (alpha 5e-3) of the frame's max,
              none past 0.05
  4. serve    evaluator renders the 8 cameras for a few rounds and writes
              metrics.json against GT rendered by the plain path (PSNR >= 50)
  5. grads    one step's parameter gradients at full width, kernels against
              plain: per leaf 99.9% of elements within 2e-3 of the leaf's max
              |g|, none past 0.05
  6. train    30 full-width make_train_step steps from a perturbed bench
              model toward plain-path renders of the unperturbed one (loss
              must fall); ms per step, peak memory and a per-stage breakdown;
              each kernel timed alone against its plain version (and the
              PyTorch gather ent_n[sorted_idx] the fused blends replace, and
              the K->N index prep), the segment sum bit for bit against its
              plain version at these shapes, and the blend's pairs counted by
              the plain path for the bounds;
  6b. host loop  GaussianSplatTrainer from points on a small scene, 30
              steps with densify at 10/20/30 and the opacity reset at 20 (val
              PSNR must rise before the reset, n_alive must change, train
              PSNR must recover after it); a checkpoint after step 20 resumed
              in a fresh trainer for steps 21-30 must match the uninterrupted
              run (n_alive equal, parameters within 1e-5 of each leaf's max)
  6c. densify bench.py --densify's run at full width: 500k points, GT from a
              second bench scene at SH 0, 150 steps with a densify event
              every 25 (K1, K2, K3 once a step; loss falls; n_alive changes;
              every overflow logged; no NaN in alive slots); at the inputs of
              the first step after the first event (its camera, the model with
              pruned slots, SH 0) and after the run, outside the counted
              launches: each kernel against its plain version at phases 3 and
              5's tolerances (segment sum bit for bit) and the step's
              gradients kernels vs plain; densify_and_prune
              + zero_moments_at under torch.cuda.set_sync_debug_mode("error");
              ms/step, ms per event and per grow_capacity from CUDA events,
              n_alive and capacity at each log, peak memory; then, past the
              counted run, grow_capacity, an event and a step at the next
              capacity bucket, and one event under torch.profiler; trainer
              init (the windowed Morton KNN) timed
  6d. lightgaussian  prune_list over the 8 bench cameras (K1, K2, K3 once
              a camera), calculate_v_imp_score and prune_gaussians at
              urban3d's prune_percent 0.25 on the bench model: n_alive
              falls by at least k; camera 0's importance, kernels against
              plain (99.9% within 2e-3 of the max, none past 0.05) outside
              the counts; ms per camera and per prune, peak memory; then the
              pruned model evaluated on the 8 cameras against the unpruned
              model's renders (PSNR, LPIPS; K1 once a camera) and exported
              (timed; .splat 32 bytes a Gaussian, the .ply read back)
  6e. CLIs    python -m dogs_tpu_torch.train on synthetic_smoke.yaml for 20
              steps with checkpoints, again with trainer.resume=true
              ("nothing to do"), then python -m dogs_tpu_torch.eval: its
              metrics.json (psnr, ssim, lpips_uncalibrated; val PSNR within
              0.01 dB of the train CLI's final validate()), PNG renders of
              the camera's size, .splat of 32 x n_alive bytes, the .ply read
              back, n_test_poses trajectory frames
  6f. real scene  the bench model rendered by the port at 17 cameras
              (1152x864), every image but image 0 under a known exposure,
              shading and pose noise, distorted by an OPENCV k1, upsampled x2
              and written as 2304x1728 PNGs with cameras/images/points3D.bin
              (500k jittered bench means), as scene "rubble" whose
              Mega-NeRF val list holds image 16, so that image 0 (the pose
              gauge) trains; urban3d_admm.yaml on one device
              through dogs_tpu_torch.factory.create_trainer at factor 2 (the
              COLMAP read, minify and undistort caches timed), the lazy
              reader, the appearance mask at lambda_mask 0.5, the trained
              exposure and pose refinement from step 10: 40 steps (K1, K2,
              K3 once a step; loss falls; colour-corrected val PSNR rises; the
              mask, exposure and pose leaves finite and moved; image 0's
              pose row still zero, its moments moved), ms/step and
              peak memory, the mask CNN's device ms forward + backward (exact
              f32 as the step runs it, and cuDNN with TF32 off and on), its
              forward and gradients on the card against the CPU at 96x80 at
              1e-5 / 2e-3 of the max, and at 1152x864 the forward at 1e-5 and
              the gradients against a CPU f64 reference within twice the CPU
              f32's own error (f32 accumulation at that size), the exposure
              and pose errors against the truth at steps 0 and 40, the
              checkpoint reloaded bit for bit, python -m dogs_tpu_torch.eval
              on it in its own process (val PSNR within 1e-4 dB of the final
              validate()), then the same 40 steps with geometry.mask=false
              (its kernels held against plain at its step 41's inputs)
  7. report   per-kernel JSON line (time, plain time, bound, share, library
              call time), then the device JSON line (last line)

Each path runs with the kernels' launch counts set to 0 just before it and
read just after; a kernel of the path that was not launched fails the run.
Any failed phase raises, so the exit code is non-zero. Imports no JAX.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SMALL_ATOL = 3e-4
GRAD_ATOL = 2e-3  # max-normalized, tests/test_pallas_blend.py:58-61
# Bounds (the H100 SXM's published peaks at a 700 W limit):
# f32 outside the tensor cores, and HBM.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# Flops per (pixel, entry) pair of the blends: every visited pair (dx, dy,
# the quadratic form, min, exp, x opa, min, the 1/255 test) and on top per
# contributing pair (forward: log1p, the log T add and test, exp, w, four
# FMAs, A += w; backward: the direct term, the prefix, d_alpha with its
# division, d_power, the ten gradients and their ten sums).
FLOPS_VISITED = 16
FLOPS_CONTRIB = {"blend_forward": 15, "blend_backward": 55}
ROUNDS = 3  # serving rounds over the 8 bench cameras
PSNR_MIN = 50.0
TRAIN_STEPS = 30
BENCH_MT = 12  # max_tiles_per_gaussian as bench.py trains the bench model
DENSIFY_STEPS, DENSIFY_EVERY = 150, 25  # bench.py --densify's run: 6 densify events
RESUME_TOL = 1e-5  # resumed against uninterrupted parameters, of each leaf's max
PRUNE_PERCENT = 0.25  # urban3d.yaml's prune.prune_percent
CLI_CONFIG = "config/gaussian_splatting/synthetic_smoke.yaml"
CLI_STEPS, CLI_POSES = 20, 4
SCENE_CONFIG = "config/gaussian_splatting/urban3d_admm.yaml"
SCENE_IMAGES, SCENE_STEPS = 17, 40
# Scene "rubble" of urban3d_admm.yaml: Mega-NeRF's split rule takes the val
# images by name from val/rgbs/, here the last, so that image 0 (the pose
# gauge) trains.
SCENE_NAME = "rubble"
SCENE_EXPNAME = f"gs_novel_view_synthesis_urban3d_{SCENE_NAME}"  # the CLIs' name for it


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def mostly_close(b: torch.Tensor, a: torch.Tensor, atol: float, frac=0.999, max_out=0.05,
                 name: str = "") -> float:
    """Hardware-parity bar of tests/tpu/test_tpu_raster.py: differences are
    scaled by the reference's max |value|; rounding in exp/log can flip an
    entry across the 1/255 or T < 1e-4 cutoffs at a few pixels, a bug moves
    many. Returns the max absolute difference."""
    d_abs = (b - a).abs()
    d = d_abs / (a.abs().max() + 1e-12)
    ok = float((d <= atol).float().mean())
    if ok < frac or float(d.max()) > max_out:
        worst = torch.topk(d.flatten(), min(5, d.numel()))
        for v, i in zip(worst.values.tolist(), worst.indices.tolist()):
            print(f"[fail] {name} outlier at flat index {i}: scaled |d| {v:.4f} "
                  f"(got {float(b.flatten()[i]):.4e}, plain {float(a.flatten()[i]):.4e})")
    check(ok >= frac, f"{name}: only {ok:.5f} of elements within {atol} (need {frac})")
    check(float(d.max()) <= max_out, f"{name}: worst outlier {float(d.max()):.4f} > {max_out}")
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

    from dogs_tpu_torch import factory, kernels
    from dogs_tpu_torch.core import look_at_camera, params_from_numpy
    from dogs_tpu_torch.core.gaussians import PARAM_NAMES
    from dogs_tpu_torch.data import colmap, synthetic
    from dogs_tpu_torch.data import dataset as tdataset
    from dogs_tpu_torch.eval.evaluator import EvalConfig, GaussianSplatEvaluator
    from dogs_tpu_torch.fields import appearance, lightgaussian
    from dogs_tpu_torch.fields.io import load_gaussian_ply
    from dogs_tpu_torch.fields.model import GaussianModelState
    from dogs_tpu_torch.raster import blend, reduce
    from dogs_tpu_torch.raster.binning import build_tile_bins
    from dogs_tpu_torch.raster.projection import project_gaussians
    from dogs_tpu_torch.raster.ssim import ssim
    from dogs_tpu_torch.raster.tiled import RasterConfig, entry_matrix, render_tiled
    from dogs_tpu_torch.train import trainer as trainer_mod
    from dogs_tpu_torch.tools import colmap_scene
    from dogs_tpu_torch.train.checkpoint import CheckpointManager, load_train_state, train_state_arrays
    from dogs_tpu_torch.utils import png
    from dogs_tpu_torch.utils.config import load_config

    dev = torch.device("cuda", 0)
    # Full-f32 references: matmuls and convolutions without TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counted = {blend.blend_forward: 0, blend.blend_backward: 0, reduce.sorted_segment_sum: 0}

    def reset_counts():
        for fn in counted:
            fn.launches = 0

    def add_counts(path: str, required) -> dict:
        """Read the counts of a main-path run; fail if a kernel it needs
        was never launched."""
        got = {fn.__name__: fn.launches for fn in counted}
        print(f"[{path}] kernel launches: {got}")
        for fn in required:
            check(fn.launches > 0, f"{path}: {fn.__name__} was not launched")
        for fn in counted:
            counted[fn] += fn.launches
        return got

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
    built = kernels.build_all()
    print(f"[build] {len(built)} kernels built/loaded in {time.perf_counter() - t0:.2f} s")
    for name, b in built.items():
        print(f"[build] {name}: {b.seconds:.2f} s")
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name} ptxas: {line.strip()}")

    cfg = RasterConfig()
    plain_cfg = RasterConfig(use_kernel=False)

    def frame_inputs(params, cam, sh_degree, mt=cfg.max_tiles_per_gaussian, alive=None):
        proj = project_gaussians(params, cam, alive=alive, active_sh_degree=sh_degree)
        bins = build_tile_bins(proj, cam.height, cam.width, max_tiles_per_gaussian=mt)
        nty, ntx = -(-cam.height // blend.TILE), -(-cam.width // blend.TILE)
        return (entry_matrix(proj), bins.sorted_idx, bins.tile_starts, nty, ntx, cam.width, cam.height), bins

    def random_cot(args, seed):
        """Cotangent drawn from a seeded generator, Gtot from the plain
        forward totals, zero past the image edge (where untile crops)."""
        *_, nty, ntx, w, h = args
        g = torch.Generator(device=dev).manual_seed(seed)
        t = nty * ntx
        p = torch.arange(256, device=dev)
        tiles = torch.arange(t, device=dev)[:, None]
        inside = (((tiles % ntx) * 16 + p % 16) < w) & (((tiles // ntx) * 16 + p // 16) < h)
        return blend.backward_cotangent(
            blend.blend_forward_reference(*args),
            torch.randn((t, 256, 3), generator=g, device=dev) * inside[..., None],
            torch.randn((t, 256), generator=g, device=dev) * inside,
            torch.randn((t, 256), generator=g, device=dev) * inside,
            torch.zeros(3, device=dev),
        )

    def check_segment_sum(label, rows, src, runs, n_out, dt):
        """K3 against its plain version, bit for bit (the same f32 adds in
        the same order), and over two launches."""
        s1 = reduce.sorted_segment_sum(rows, src, runs, n_out, dt)
        s2 = reduce.sorted_segment_sum(rows, src, runs, n_out, dt)
        sref = reduce.sorted_segment_sum_reference(rows, src, runs, n_out, dt)
        torch.cuda.synchronize()
        err = float((s1 - sref).abs().max()) if n_out else 0.0
        print(f"[parity] {label} segment sum: K={src.shape[0]} N={n_out} max|d|={err:.3e} "
              f"equal={torch.equal(s1, sref)}")
        check(torch.equal(s1, s2), f"{label}: sorted_segment_sum is not deterministic")
        check(torch.equal(s1, sref), f"{label}: segment-sum kernel differs from its plain version")
        max_err["seg"] = max(max_err["seg"], err)

    # ---- 3. kernels against plain on the card ------------------------------
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
    max_err = dict.fromkeys(("fwd", "bwd", "seg"), 0.0)
    with torch.no_grad():
        for name, (arrays, view, deg) in small.items():
            params = params_from_numpy(arrays, dev)
            args, bins = frame_inputs(params, look_at_camera(**view, device=dev), deg, mt=36)
            ent_n, idx, starts, *grid = args
            want = blend.blend_forward_reference(*args)
            got = blend.blend_forward(*args)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), f"{name}: non-finite kernel output")
            err = float((got - want).abs().max())
            empty = int((starts[1:] == starts[:-1]).sum())
            print(f"[parity] {name} forward: K={idx.shape[0]} empty_tiles={empty} max|d|={err:.3e}")
            check(err <= SMALL_ATOL, f"{name}: forward kernel vs plain max|d| {err} > {SMALL_ATOL}")
            max_err["fwd"] = max(max_err["fwd"], err)

            cot = random_cot(args, seed=7)
            for thr in (0.0, 4.5):
                d1 = blend.blend_backward(ent_n, idx, starts, cot, *grid, depth_threshold=thr)
                d2 = blend.blend_backward(ent_n, idx, starts, cot, *grid, depth_threshold=thr)
                dref = blend.blend_backward_reference(ent_n, idx, starts, cot, *grid, depth_threshold=thr)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(d1).all()), f"{name}: non-finite backward output")
                check(torch.equal(d1, d2), f"{name}: blend_backward is not deterministic")
                check(not d1[:, 10:].any(), f"{name}: backward wrote columns 10-15")
                worst = 0.0
                for c in range(blend.N_GRADS):
                    scale = float(dref[:, c].abs().max()) + 1e-6
                    worst = max(worst, float((d1[:, c] - dref[:, c]).abs().max()) / scale)
                err = float((d1 - dref).abs().max())
                print(f"[parity] {name} backward thr={thr}: max|d|={err:.3e} "
                      f"max column-normalized |d|={worst:.3e}")
                check(worst <= GRAD_ATOL, f"{name}: backward kernel vs plain {worst} > {GRAD_ATOL}")
                max_err["bwd"] = max(max_err["bwd"], err)

            n_out = params.capacity
            src, runs = reduce.gaussian_runs(bins.order, idx, n_out)
            for dt in reduce.REDUCE_DTYPES:
                check_segment_sum(f"{name} {dt}", d1, src, runs, n_out, dt)
            if name == "random_seed0":
                # The id-sort form of the reduce on the CPU: a stable id sort,
                # a row gather and index_add_, which adds rows in order there.
                ids, perm = torch.sort(idx.cpu().long(), stable=True)
                for dt in reduce.REDUCE_DTYPES:
                    vals = d1.cpu()[perm, :blend.N_GRADS]
                    if dt == "bf16":
                        vals = vals.to(torch.bfloat16).to(torch.float32)
                    want = torch.zeros((n_out, blend.ENT_WIDTH))
                    want[:, :blend.N_GRADS].index_add_(0, ids, vals)
                    got = reduce.reduce_entries(d1, bins.order, idx, n_out, dt).cpu()
                    check(torch.equal(got, want), f"{name}: reduce_entries ({dt}) differs from the "
                          f"CPU id sort + gather + index_add_ by {float((got - want).abs().max()):.3e}")
                    print(f"[parity] {name} reduce_entries {dt}: equal to the CPU id sort + gather + index_add_")

        params = synthetic.bench_scene(device=dev)
        n = params.capacity
        cams = synthetic.bench_cameras(8, device=dev)
        gts = []
        for i, cam in enumerate(cams):
            ref = render_tiled(params, cam, plain_cfg)
            out = render_tiled(params, cam, cfg)
            torch.cuda.synchronize()
            errs = {
                "image": mostly_close(out.image, ref.image, 3e-3, name="image"),
                "alpha": mostly_close(out.alpha, ref.alpha, 5e-3, name="alpha"),
                "invdepth": mostly_close(out.invdepth, ref.invdepth, 3e-3, name="invdepth"),
            }
            check(tuple(out.image.shape) == (cam.height, cam.width, 3), "bad image shape")
            check(bool(torch.isfinite(out.image).all()), f"bench cam {i}: non-finite image")
            max_err["fwd"] = max(max_err["fwd"], *errs.values())
            print(f"[parity] bench cam {i}: K={out.bin_valid} truncated={out.bin_rect_truncated} "
                  + " ".join(f"max|d| {k}={v:.3e}" for k, v in errs.items()))
            gts.append(torch.clamp(ref.image, 0.0, 1.0))

    # ---- 4. serve (main path 1) --------------------------------------------
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
        reset_counts()
        frame_ms = []
        for _ in range(ROUNDS):
            for cam in cams:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                img = evaluator.render(cam)
                torch.cuda.synchronize()
                frame_ms.append((time.perf_counter() - t0) * 1e3)
        metrics = evaluator.eval(cams, gts, split="val")
        serve_counts = add_counts("serve", [blend.blend_forward])
        with open(f"{tmp}/val/metrics.json") as f:
            written = json.load(f)
    check(serve_counts["blend_forward"] == (ROUNDS + 1) * len(cams),
          f"blend kernel launched {serve_counts['blend_forward']} times, "
          f"expected {(ROUNDS + 1) * len(cams)}")
    frame = (synthetic.BENCH_HEIGHT, synthetic.BENCH_WIDTH, 3)
    check(tuple(img.shape) == frame and bool(torch.isfinite(img).all()), "bad render")
    check(not img.requires_grad, "the evaluator recorded an autograd graph")
    mean = metrics["mean"]
    check(written["mean"] == mean, "metrics.json differs from the returned metrics")
    check(mean["psnr"] >= PSNR_MIN, f"eval PSNR {mean['psnr']:.2f} dB < {PSNR_MIN}")
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20
    warm = frame_ms[len(cams):]  # first round includes lazy init
    print(f"[serve] {len(frame_ms)} frames: ms/frame median {np.median(warm):.2f} "
          f"min {min(warm):.2f} (first round median {np.median(frame_ms[:len(cams)]):.2f}); "
          f"eval psnr {mean['psnr']:.2f} dB ssim {mean['ssim']:.5f} "
          f"render_time {mean['render_time'] * 1e3:.2f} ms; peak memory {peak_mb:.0f} MiB")

    # ---- 5. full-width gradients, kernels against plain --------------------
    # The bench model with anisotropic scales (the bench scene's are
    # isotropic, which makes quaternion gradients pure rounding noise),
    # perturbed by a numpy draw; it also starts the training phase.
    rng = np.random.RandomState(2)
    arrays = synthetic.bench_scene_arrays(n, seed=0)
    arrays["log_scale"] = arrays["log_scale"] + rng.normal(0.0, 0.2, (n, 3)).astype(np.float32)
    with torch.no_grad():
        targets = [torch.clamp(render_tiled(params_from_numpy(arrays, dev), c, plain_cfg).image, 0, 1)
                   for c in cams]
    arrays["feat_dc"] = arrays["feat_dc"] + rng.normal(0.0, 0.3, (n, 1, 3)).astype(np.float32)
    arrays["logit_opacity"] = arrays["logit_opacity"] + rng.normal(0.0, 0.5, (n, 1)).astype(np.float32)
    arrays["xyz"] = arrays["xyz"] + rng.normal(0.0, 0.002, (n, 3)).astype(np.float32)
    bench_rng = np.random.RandomState(1)  # bench.py's GT draw
    bench_gts = [torch.as_tensor(bench_rng.rand(*frame).astype(np.float32), device=dev) for _ in cams]

    def step_grads(p, cam, gt, rcfg, alive=None, deg=3):
        offset = torch.zeros((p.capacity, 2), device=dev, requires_grad=True)
        out = render_tiled(p, cam, rcfg, alive=alive, active_sh_degree=deg, means2d_offset=offset)
        img = torch.clamp(out.image, 0.0, 1.0)
        loss = 0.8 * torch.mean(torch.abs(img - gt)) + 0.2 * (1.0 - ssim(img, gt))
        return torch.autograd.grad(loss, [getattr(p, k) for k in PARAM_NAMES] + [offset])

    kcfg = RasterConfig(max_tiles_per_gaussian=BENCH_MT)
    kplain = RasterConfig(max_tiles_per_gaussian=BENCH_MT, use_kernel=False)
    p_grad = params_from_numpy(arrays, dev)
    g_kernel = step_grads(p_grad, cams[0], bench_gts[0], kcfg)
    g_plain = step_grads(p_grad, cams[0], bench_gts[0], kplain)
    torch.cuda.synchronize()
    del p_grad
    for name, gk, gp in zip(PARAM_NAMES + ("means2d_offset",), g_kernel, g_plain):
        check(bool(torch.isfinite(gk).all()), f"{name}: non-finite kernel gradient")
        err = mostly_close(gk, gp, GRAD_ATOL, name=f"grad {name}")
        d = (gk - gp).abs() / (gp.abs().max() + 1e-12)
        worst = torch.topk(d.flatten(), 3)
        print(f"[grads] {name}: max|g| {float(gp.abs().max()):.3e} max|d| {err:.3e} "
              f"share within {GRAD_ATOL}: {float((d <= GRAD_ATOL).float().mean()):.6f}; worst scaled "
              + ", ".join(f"{v:.2e}@{i}" for v, i in zip(worst.values.tolist(), worst.indices.tolist())))
    del g_kernel, g_plain

    # ---- 6. train (main path 2): make_train_step at full width -------------
    tcfg = trainer_mod.TrainerConfig()
    train_model = GaussianModelState(
        params=params_from_numpy(arrays, dev),
        alive=torch.ones(n, dtype=torch.bool, device=dev),
        grad_accum=torch.zeros(n, device=dev),
        denom=torch.zeros(n, device=dev),
        max_radii2d=torch.zeros(n, device=dev),
    )
    ts = trainer_mod.train_state_from_model(train_model, len(cams), tcfg)
    step = trainer_mod.make_train_step(tcfg, kcfg, spatial_lr_scale=5.0, active_sh_degree=3,
                                       background=(0.0, 0.0, 0.0))
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    losses, step_ms = [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, m = step(ts, cams[i % len(cams)], targets[i % len(cams)])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        check(np.isfinite(losses[-1]), f"train step {i}: non-finite loss")
    add_counts("train", list(counted))
    for fn in counted:
        check(fn.launches == TRAIN_STEPS, f"train: {fn.__name__} launched {fn.launches} times, "
              f"expected one per step ({TRAIN_STEPS})")
    train_peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20
    first, last = np.mean(losses[:len(cams)]), np.mean(losses[-len(cams):])
    print(f"[train] {TRAIN_STEPS} steps at 500k/SH3/1152x864: loss {losses[0]:.5f} -> {losses[-1]:.5f}; "
          f"mean over first 8 {first:.5f}, last 8 {last:.5f}; n_visible {int(m['n_visible'])}, "
          f"bin_valid {int(m['bin_valid'])}")
    check(last < first, f"train loss did not fall: first 8 mean {first}, last 8 mean {last}")
    warm_ms = step_ms[len(cams):]
    print(f"[train] ms/step median {np.median(warm_ms):.2f} min {min(warm_ms):.2f} "
          f"(first round median {np.median(step_ms[:len(cams)]):.2f}); peak memory {train_peak_mb:.0f} MiB")

    # Per-stage breakdown: CUDA events at the stage boundaries of 8 more steps
    # (after the counted run). Device time between consecutive events.
    marks: list[tuple[str, torch.cuda.Event]] = []

    def mark(label):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append((label, e))

    def wrapped(fn, before, after):
        def run(*a, **kw):
            mark(before)
            out = fn(*a, **kw)
            mark(after)
            return out
        if hasattr(fn, "launches"):  # the kernel wrapper counts through its module name
            run.launches = fn.launches
        return run

    originals = (trainer_mod.render_tiled, blend.blend_backward, reduce.gaussian_runs,
                 reduce.sorted_segment_sum, trainer_mod.sparse_adam_step)
    trainer_mod.render_tiled = wrapped(originals[0], "start", "render")
    blend.blend_backward = wrapped(originals[1], "loss fwd+bwd", "K2")
    reduce.gaussian_runs = wrapped(originals[2], "-", "K->N prep")
    reduce.sorted_segment_sum = wrapped(originals[3], "-", "K3")
    trainer_mod.sparse_adam_step = wrapped(originals[4], "projection VJP", "sparse Adam")
    stages: dict[str, list[float]] = {}
    try:
        for i in range(len(cams)):
            marks.clear()
            ts, m = step(ts, cams[i], targets[i])
            mark("stats+metrics")
            torch.cuda.synchronize()
            for (_, e0), (label, e1) in zip(marks, marks[1:]):
                if label != "-":
                    stages.setdefault(label, []).append(e0.elapsed_time(e1))
    finally:
        (trainer_mod.render_tiled, blend.blend_backward, reduce.gaussian_runs,
         reduce.sorted_segment_sum, trainer_mod.sparse_adam_step) = originals
    names = {"render": "forward render (project, bin, K1)", "loss fwd+bwd": "loss fwd + SSIM/L1 bwd",
             "K2": "blend backward K2", "K->N prep": "K->N index prep",
             "K3": "segment sum K3", "projection VJP": "projection + SH VJP",
             "sparse Adam": "sparse Adam", "stats+metrics": "densify stats + metrics"}
    total = sum(np.median(v) for v in stages.values())
    for label, v in stages.items():
        print(f"[train] stage {names[label]:34s} median {np.median(v):8.3f} ms "
              f"({100 * np.median(v) / total:4.1f}%)")
    print(f"[train] stage sum {total:.3f} ms")

    # Each kernel alone against its plain version on bench camera 0: the
    # forward at the serving shapes (as PR 1 timed it), then all three at
    # the training shapes (max_tiles_per_gaussian 12), beside the PyTorch
    # gather ent_n[sorted_idx] that the fused blends replace, the K->N index
    # prep, the library call that computes K3's function, and the pairs the
    # plain path counts for the bounds.
    with torch.no_grad():
        args, _ = frame_inputs(params, cams[0], 3)
        ent_n, idx = args[0], args[1]
        serve_ms = [cuda_ms(lambda: blend.blend_forward(*args), 50) for _ in range(2)]
        serve_gather = [cuda_ms(lambda: ent_n[idx].contiguous(), 50) for _ in range(2)]
        print(f"[kernels] blend_forward on bench cam 0 at serving shapes (K={idx.shape[0]}): "
              f"kernel {serve_ms[0]:.3f}/{serve_ms[1]:.3f} ms; the gather it fuses, alone: "
              f"{serve_gather[0]:.3f}/{serve_gather[1]:.3f} ms")
        args, bins = frame_inputs(params, cams[0], 3, mt=BENCH_MT)
        ent_n, idx, starts, *grid = args
        k = idx.shape[0]
        cot = random_cot(args, seed=11)
        d_ent = blend.blend_backward(ent_n, idx, starts, cot, *grid)
        src, runs = reduce.gaussian_runs(bins.order, idx, n)
        for dt in reduce.REDUCE_DTYPES:
            check_segment_sum(f"bench cam 0 training shapes {dt}", d_ent, src, runs, n, dt)
        idx64, zero10 = idx.long(), torch.zeros((n, blend.N_GRADS), device=dev)
        prep_ms = min(cuda_ms(lambda: reduce.gaussian_runs(bins.order, idx, n), 50) for _ in range(2))
        bf16_ms = min(cuda_ms(lambda: reduce.sorted_segment_sum(d_ent, src, runs, n, "bf16"), 50)
                      for _ in range(2))
        timing = {
            "blend_forward": (lambda: blend.blend_forward(*args),
                              lambda: blend.blend_forward_reference(*args)),
            "blend_backward": (lambda: blend.blend_backward(ent_n, idx, starts, cot, *grid),
                               lambda: blend.blend_backward_reference(ent_n, idx, starts, cot, *grid)),
            "sorted_segment_sum": (lambda: reduce.sorted_segment_sum(d_ent, src, runs, n),
                                   lambda: reduce.sorted_segment_sum_reference(d_ent, src, runs, n)),
        }
        kernel_ms, plain_ms = {}, {}
        for name, (kfn, pfn) in timing.items():
            many = 3 if name != "sorted_segment_sum" else 20
            ms = [cuda_ms(kfn, 50), cuda_ms(pfn, many), cuda_ms(kfn, 50), cuda_ms(pfn, many)]
            kernel_ms[name], plain_ms[name] = min(ms[0], ms[2]), min(ms[1], ms[3])
            print(f"[kernels] {name} on bench cam 0 (K={k}): kernel "
                  f"{ms[0]:.3f}/{ms[2]:.3f} ms, plain {ms[1]:.3f}/{ms[3]:.3f} ms")
        gather_ms = min(cuda_ms(lambda: ent_n[idx].contiguous(), 50) for _ in range(2))
        library_ms = {
            "blend_forward": None,  # no one PyTorch call computes the blends
            "blend_backward": None,
            "sorted_segment_sum": min(
                cuda_ms(lambda: torch.index_add(zero10, 0, idx64, d_ent[:, :blend.N_GRADS]), 50)
                for _ in range(2)
            ),
        }
        print(f"[kernels] the gather ent_n[sorted_idx] the fused blends replace, alone: {gather_ms:.3f} ms; "
              f"index_add_ from tile order (K3's function): {library_ms['sorted_segment_sum']:.3f} ms; "
              f"K->N index prep (gaussian_runs): {prep_ms:.4f} ms; K3 with reduce_dtype bf16: {bf16_ms:.4f} ms")

        # Bounds from this run's inputs: the pairs the plain path visits and
        # the bytes each function must move (inputs read once, outputs
        # written once).
        work = blend.blend_work(*args)
        n_tiles = grid[0] * grid[1]
        moved = {
            "blend_forward": 4 * (ent_n.numel() + k + starts.numel() + n_tiles * blend.OUT_ROWS * 256),
            "blend_backward": 4 * (ent_n.numel() + k + starts.numel() + cot.numel() + k * blend.ENT_WIDTH),
            "sorted_segment_sum": 4 * (k + (n + 1) + k * blend.N_GRADS + n * blend.ENT_WIDTH),
        }
        flops = {name: FLOPS_VISITED * work.visited + FLOPS_CONTRIB[name] * work.contributing
                 for name in FLOPS_CONTRIB}
        flops["sorted_segment_sum"] = k * blend.N_GRADS  # one add per value
        bounds = {}
        for name in timing:
            byte_ms = moved[name] / PEAK_BYTES_PER_S * 1e3
            op_ms = flops[name] / PEAK_F32_FLOPS * 1e3
            bounds[name] = (max(byte_ms, op_ms), "operations" if op_ms >= byte_ms else "bytes")
            print(f"[bounds] {name}: {flops[name]:,} flops -> {op_ms:.4f} ms; {moved[name]:,} bytes -> "
                  f"{byte_ms:.4f} ms; bound {bounds[name][0]:.4f} ms by {bounds[name][1]}, "
                  f"share {bounds[name][0] / kernel_ms[name]:.3f}")
        print(f"[bounds] pairs at the training shapes (K={k}): visited {work.visited:,} "
              f"(at most K x 256 = {k * 256:,}), contributing {work.contributing:,}")
    del ts, train_model, step

    # ---- 6b. train (main path 3): the host loop from points ----------------
    # The configuration of tests/test_torch_train.py's trainer run against
    # the JAX trainer: densify at steps 10, 20 and 30, the opacity reset at
    # step 20; a checkpoint after step 20 resumed in a fresh trainer.
    scene = synthetic.make_scene(n_gaussians=80, n_cams=10, width=64, height=64, seed=3, device=dev)
    hcfg = trainer_mod.TrainerConfig(
        max_iterations=400, position_lr_max_steps=400, densify_start_iter=5, densification_interval=10,
        densify_end_iter=2000, opacity_reset_interval=20, densify_grad_threshold=8e-3, percent_dense=0.1,
        sh_increase_interval=10, max_sh_degree=2, min_capacity=128,
    )

    def host_loop():
        return trainer_mod.GaussianSplatTrainer(
            scene.cameras[:8], scene.images[:8], scene.points, scene.colors, hcfg, RasterConfig(),
            val_cameras=scene.cameras[8:], val_images=scene.images[8:], seed=42, device=dev,
        )

    loop = host_loop()
    val0 = loop.validate()["val_psnr"]
    reset_counts()
    loop.train(num_iterations=19, log_every=1)
    val19 = loop.validate()["val_psnr"]  # before the opacity reset
    loop.train(num_iterations=1, log_every=1)
    with tempfile.TemporaryDirectory() as tmp:
        manager = CheckpointManager(tmp)
        loop.save_checkpoint(manager)
        resumed = host_loop()
        check(resumed.load_checkpoint(manager) == 20, "host loop: the checkpoint did not resume at step 20")
    loop.train(num_iterations=10, log_every=1)
    resumed.train(num_iterations=10, log_every=1)
    add_counts("host loop", list(counted))
    val30 = loop.validate()["val_psnr"]
    alive = [int(m["n_alive"]) for m in loop.metrics_history]
    psnr = [m["psnr"] for m in loop.metrics_history]
    print(f"[host loop] 30 steps, 80 Gaussians at 64x64, densify at 10/20/30, opacity reset at 20: val PSNR "
          f"{val0:.3f} -> {val19:.3f} (step 19) -> {val30:.3f} dB (step 30); n_alive "
          f"{alive[0]} -> {alive[10]} -> {alive[20]} -> {int(loop.state.model.num_alive)}; train psnr "
          + ", ".join(f"{v:.2f}@{i + 1}" for i, v in enumerate(psnr) if (i + 1) % 5 == 0))
    check(val19 > val0 + 1.0, f"host loop: val PSNR {val0:.3f} -> {val19:.3f} did not rise by 1 dB")
    check(alive[10] != alive[9] and alive[20] != alive[19], f"host loop: densify changed nothing: {alive}")
    check(np.mean(psnr[25:]) > np.mean(psnr[20:25]), "host loop: train PSNR did not recover after the reset")
    same_alive = int(resumed.state.model.num_alive) == int(loop.state.model.num_alive)
    worst = 0.0
    for k in PARAM_NAMES:
        a, b = getattr(loop.state.model.params, k).detach(), getattr(resumed.state.model.params, k).detach()
        worst = max(worst, float((a - b).abs().max()) / (float(a.abs().max()) + 1e-12))
    print(f"[host loop] checkpoint at step 20, resumed for steps 21-30: n_alive "
          f"{int(resumed.state.model.num_alive)} vs {int(loop.state.model.num_alive)} uninterrupted; "
          f"largest parameter difference {worst:.3e} of the leaf max")
    check(same_alive, "host loop: the resumed run has another n_alive")
    check(worst <= RESUME_TOL, f"host loop: resumed parameters differ by {worst:.3e} > {RESUME_TOL} of the leaf max")
    del loop, resumed

    # ---- 6c. densify (main path 4): the host loop at full width ------------
    # bench.py --densify's run: 500k points of the bench scene (colours 0.5)
    # fitting renders of a second bench scene (seed 7) at SH 0, densify every
    # 25 steps from step 1, capacity grown as the trainer's protocol says.
    with torch.no_grad():
        teacher = synthetic.bench_scene(n, seed=7, device=dev)
        dense_gts = [render_tiled(teacher, c, kcfg, active_sh_degree=0).image for c in cams]
        del teacher
    dcfg = trainer_mod.TrainerConfig(densify_start_iter=1, densify_end_iter=10**6,
                                     densification_interval=DENSIFY_EVERY, opacity_reset_interval=10**6,
                                     spatial_lr_scale=5.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    dloop = trainer_mod.GaussianSplatTrainer(
        cams, dense_gts, synthetic.bench_scene_arrays(n, seed=0)["xyz"], np.full((n, 3), 0.5, np.float32),
        dcfg, kcfg, device=dev,
    )
    torch.cuda.synchronize()
    init_s, init_peak_mb = time.perf_counter() - t0, torch.cuda.max_memory_allocated(dev) / 2**20
    print(f"[densify] ({smi}) trainer from {n:,} points (windowed Morton KNN scales): {init_s:.2f} s, "
          f"peak memory {init_peak_mb:.0f} MiB; capacity {dloop.state.model.capacity:,}")

    events: list[dict] = []
    events_grow: list[tuple] = []
    step_log: list[tuple[int, float, torch.Tensor]] = []
    peaks_before_parity: list[int] = []
    surgery = (trainer_mod.densify_and_prune, trainer_mod.zero_moments_at, trainer_mod.grow_capacity)

    def path_parity(label, model, cam, gt, deg, rcfg=None, tag="densify"):
        """One train step's inputs on this path (its model, with the dead
        slots of pruning, at SH `deg`): each kernel against its plain version
        at the tolerances of phases 3 and 5, and the step's gradients,
        kernels against plain. The launches made here do not count: the
        counts are restored. Neither does its memory: returns the peak
        before it, and resets the peak after it. `rcfg`: the path's raster
        config (default: bench.py's, max_tiles_per_gaussian 12)."""
        rcfg = rcfg or kcfg
        saved = {fn: fn.launches for fn in counted}
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        p, alive = model.params, model.alive
        with torch.no_grad():
            args, bins = frame_inputs(p, cam, deg, mt=rcfg.max_tiles_per_gaussian, alive=alive)
            ent_n, idx, starts, *grid = args
            got, want = blend.blend_forward(*args), blend.blend_forward_reference(*args)
            errs = [mostly_close(got[:, rows], want[:, rows], tol, name=f"{label} forward {what}")
                    for rows, tol, what in ((slice(0, 3), 3e-3, "rgb"), (3, 5e-3, "alpha"), (4, 3e-3, "invdepth"))]
            max_err["fwd"] = max(max_err["fwd"], *errs)
            cot = random_cot(args, seed=13)
            d1 = blend.blend_backward(ent_n, idx, starts, cot, *grid, depth_threshold=rcfg.depth_threshold)
            dref = blend.blend_backward_reference(ent_n, idx, starts, cot, *grid,
                                                  depth_threshold=rcfg.depth_threshold)
            check(bool(torch.isfinite(d1).all()) and not d1[:, 10:].any(),
                  f"{label}: backward output non-finite or columns 10-15 written")
            err = max(mostly_close(d1[:, c], dref[:, c], GRAD_ATOL, name=f"{label} backward column {c}")
                      for c in range(blend.N_GRADS))
            max_err["bwd"] = max(max_err["bwd"], err)
            src, runs = reduce.gaussian_runs(bins.order, idx, p.capacity)
            for dt in reduce.REDUCE_DTYPES:
                check_segment_sum(f"{label} {dt}", d1, src, runs, p.capacity, dt)
        g_kernel = step_grads(p, cam, gt, rcfg, alive, deg)
        g_plain = step_grads(p, cam, gt, dataclasses.replace(rcfg, use_kernel=False), alive, deg)
        worst = {}
        for name, gk, gp in zip(PARAM_NAMES + ("means2d_offset",), g_kernel, g_plain):
            check(bool(torch.isfinite(gk).all()), f"{label}: non-finite kernel gradient {name}")
            mostly_close(gk, gp, GRAD_ATOL, name=f"{label} grad {name}")
            worst[name] = float(((gk - gp).abs() / (gp.abs().max() + 1e-12)).max())
        print(f"[{tag}] {label}: capacity {p.capacity:,}, n_alive {int(model.num_alive):,}, SH {deg}, "
              f"K={idx.shape[0]:,}: forward max|d| {max(errs):.3e}, backward max|d| {err:.3e}, segment sum "
              f"bit for bit; step gradients kernels vs plain, worst scaled |d| per leaf "
              + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))
        for fn, c in saved.items():
            fn.launches = c
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        return peak

    def event_mark():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def timed_densify(state, *a, **kw):
        """densify_and_prune and the moment zeroing after it, with no host
        sync allowed in between (timed_zero or the finally around the run
        turns the check off)."""
        ev = dict(start=event_mark(), alive_before=state.num_alive, capacity=state.capacity)
        torch.cuda.set_sync_debug_mode("error")
        out = surgery[0](state, *a, **kw)
        ev.update(alive_after=out[0].num_alive, overflow=out[2])
        events.append(ev)
        return out

    def timed_zero(opt, mask):
        try:
            return surgery[1](opt, mask)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            events[-1]["stop"] = event_mark()

    def timed_grow(ts, new_capacity):
        e0 = event_mark()
        out = surgery[2](ts, new_capacity)
        events_grow.append((ts.model.capacity, new_capacity, e0, event_mark()))
        return out

    step_iteration = dloop.train_iteration

    def timed_iteration(step):
        if step == DENSIFY_EVERY + 1:  # the first step after the first event
            i = dloop._order[-1] if dloop._order else 0  # the camera this step takes
            peaks_before_parity.append(path_parity(f"step {step} inputs", dloop.state.model, cams[i],
                                                   dense_gts[i], dloop.active_sh_degree(step)))
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = step_iteration(step)
        torch.cuda.synchronize()
        step_log.append((step, (time.perf_counter() - t) * 1e3, m["loss"]))
        return m

    dloop.train_iteration = timed_iteration
    records: list[logging.LogRecord] = []
    catcher = logging.Handler(logging.WARNING)
    catcher.emit = records.append
    trainer_log = logging.getLogger(trainer_mod.__name__)
    trainer_log.addHandler(catcher)
    trainer_mod.densify_and_prune, trainer_mod.zero_moments_at, trainer_mod.grow_capacity = (
        timed_densify, timed_zero, timed_grow)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    try:
        dloop.train(num_iterations=DENSIFY_STEPS, log_every=DENSIFY_EVERY)
        torch.cuda.synchronize()
        dense_counts = add_counts("densify loop", list(counted))
        dense_peak_mb = max([torch.cuda.max_memory_allocated(dev)] + peaks_before_parity) / 2**20
        n_events = len(events)
        path_parity("after the run", dloop.state.model, cams[0], dense_gts[0],
                    dloop.active_sh_degree(dloop.state.step + 1))
        # After the counted run, at the next capacity bucket whether or not
        # the run grew: grow_capacity, one densify event and one step.
        torch.cuda.reset_peak_memory_stats(dev)
        dloop.state = trainer_mod.grow_capacity(dloop.state, 2 * dloop.state.model.capacity)
        dloop._maybe_densify(DENSIFY_STEPS)  # an event step
        dloop.train_iteration(dloop.state.step + 1)
        torch.cuda.synchronize()
        grown_peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20
    finally:
        trainer_mod.densify_and_prune, trainer_mod.zero_moments_at, trainer_mod.grow_capacity = surgery
        trainer_log.removeHandler(catcher)
        torch.cuda.set_sync_debug_mode(0)
    # One more event under torch.profiler (outside the sync check): the
    # device operations it runs and their summed time against its span.
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        e0 = event_mark()
        dloop._maybe_densify(DENSIFY_STEPS)  # an event step
        e1 = event_mark()
        torch.cuda.synchronize()
    device_ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in device_ops) / 1e3
    profiled = (len(device_ops), busy_ms, e0.elapsed_time(e1))
    by_name: dict[str, float] = {}
    for e in device_ops:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    for name, launches in dense_counts.items():
        check(launches == DENSIFY_STEPS, f"densify loop: {name} launched {launches} times, "
              f"expected one per step ({DENSIFY_STEPS})")
    step_log = step_log[:DENSIFY_STEPS]  # the counted run
    losses = torch.stack([loss for _, _, loss in step_log]).tolist()  # one transfer
    check(all(np.isfinite(losses)), "densify loop: non-finite loss")
    first, last = np.mean(losses[:DENSIFY_EVERY]), np.mean(losses[-DENSIFY_EVERY:])
    check(last < first, f"densify loop: loss did not fall: first 25 mean {first}, last 25 mean {last}")
    check(n_events == DENSIFY_STEPS // DENSIFY_EVERY, f"densify loop: {n_events} events")
    check(len(events) == n_events + 1 and events[-1]["capacity"] == dloop.state.model.capacity,
          "densify loop: no event at the grown capacity")
    for ev in events:
        for key in ("alive_before", "alive_after", "overflow"):
            ev[key] = int(ev[key])
        ev["ms"] = ev["start"].elapsed_time(ev["stop"])
    counts = [events[0]["alive_before"]] + [ev["alive_after"] for ev in events[:n_events]]
    check(len(set(counts)) > 1, f"densify loop: n_alive never changed: {counts}")
    logged = sum("densify overflow" in r.getMessage() for r in records)
    dropped = sum(ev["overflow"] > 0 for ev in events[:n_events])
    check(logged == dropped, f"densify loop: {dropped} events dropped candidates, {logged} were logged")
    model = dloop.state.model
    for k in PARAM_NAMES:
        check(bool(torch.isfinite(getattr(model.params, k)[model.alive]).all()),
              f"densify loop: non-finite {k} among the alive slots")
    quiet_ms = [ms for step, ms, _ in step_log if step % DENSIFY_EVERY]
    print(f"[densify] ({smi}) {DENSIFY_STEPS} steps, an event every {DENSIFY_EVERY}: loss {losses[0]:.5f} -> "
          f"{losses[-1]:.5f} (mean of the first 25 {first:.5f}, last 25 {last:.5f}); ms/step median over the "
          f"{len(quiet_ms)} steps without an event {np.median(quiet_ms):.2f}, with one "
          f"{np.median([ms for step, ms, _ in step_log if not step % DENSIFY_EVERY]):.2f}; peak memory "
          f"{dense_peak_mb:.0f} MiB")
    for m in dloop.metrics_history:
        print(f"[densify] ({smi}) log at step {m['step']}: n_alive {int(m['n_alive']):,} (before the event), "
              f"capacity {m['capacity']:,}, entries K {int(m['bin_valid']):,}")
    for i, ev in enumerate(events):
        label = f"event {i + 1}" if i < n_events else "after the run, one event"
        print(f"[densify] ({smi}) {label} at capacity {ev['capacity']:,}: n_alive {ev['alive_before']:,} "
              f"-> {ev['alive_after']:,}, overflow {ev['overflow']}; densify_and_prune + zero_moments_at "
              f"{ev['ms']:.3f} ms (no host sync)")
    for i, (cap0, cap1, e0, e1) in enumerate(events_grow):
        label = "after the run" if i == len(events_grow) - 1 else "in the run"
        print(f"[densify] ({smi}) grow_capacity {cap0:,} -> {cap1:,} ({label}): {e0.elapsed_time(e1):.3f} ms")
    print(f"[densify] ({smi}) peak memory at capacity {dloop.state.model.capacity:,} (grow_capacity, one "
          f"event, one step): {grown_peak_mb:.0f} MiB")
    print(f"[densify] ({smi}) one more event at capacity {dloop.state.model.capacity:,} under torch.profiler "
          f"(required_slots read, densify_and_prune, zero_moments_at): {profiled[0]} device operations, "
          f"{profiled[1]:.3f} ms busy in a {profiled[2]:.3f} ms span; largest: "
          + "; ".join(f"{name[:60]} {ms:.3f} ms" for name, ms in top_ops))
    del dloop, dense_gts, model

    # ---- 6d. lightgaussian (main path 5): the importance prune at full width
    # The bench model with every slot alive; urban3d's prune_percent. Camera
    # 0's importance is held against the plain path first, outside the
    # counts and the peak.
    def bench_model():
        return GaussianModelState(params, torch.ones(n, dtype=torch.bool, device=dev),
                                  *(torch.zeros(n, device=dev) for _ in range(3)))

    saved = {fn: fn.launches for fn in counted}
    imp_kernel = lightgaussian.importance_render(bench_model(), cams[0], cfg)
    imp_plain = lightgaussian.importance_render(bench_model(), cams[0], plain_cfg)
    torch.cuda.synchronize()
    for fn, c in saved.items():
        fn.launches = c
    check(bool(torch.isfinite(imp_kernel).all()), "lightgaussian: non-finite kernel importance")
    mostly_close(imp_kernel, imp_plain, GRAD_ATOL, name="importance cam 0")
    print(f"[lightgaussian] ({smi}) camera 0 importance, kernels vs plain: max {float(imp_plain.max()):.4e}, "
          f"max|d| {float((imp_kernel - imp_plain).abs().max()):.3e}, share within {GRAD_ATOL} of the max "
          f"{float(((imp_kernel - imp_plain).abs() <= GRAD_ATOL * imp_plain.abs().max()).float().mean()):.6f}, "
          f"{int((imp_plain > 0).sum()):,} Gaussians with importance")
    del imp_kernel, imp_plain

    lg_model = bench_model()
    render_importance = lightgaussian.importance_render
    per_cam: list[tuple] = []

    def timed_importance(*a, **kw):
        e0 = event_mark()
        out = render_importance(*a, **kw)
        per_cam.append((e0, event_mark()))
        return out

    lightgaussian.importance_render = timed_importance
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    try:
        t0 = time.perf_counter()
        imp = lightgaussian.prune_list(lg_model, cams, cfg)
        scores = lightgaussian.calculate_v_imp_score(lg_model, imp, 0.1)
        lightgaussian.prune_gaussians(lg_model, PRUNE_PERCENT, scores)
        torch.cuda.synchronize()
        prune_s = time.perf_counter() - t0
    finally:
        lightgaussian.importance_render = render_importance
    lg_counts = add_counts("lightgaussian", list(counted))
    for name, launches in lg_counts.items():
        check(launches == len(cams), f"lightgaussian: {name} launched {launches} times, expected one per camera")
    lg_peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20
    n_pruned_alive, n_seen = int(lg_model.num_alive), int((imp > 0).sum())
    k_prune = int(np.float32(PRUNE_PERCENT) * (np.float32(n) - np.float32(1.0)))
    check(bool(torch.isfinite(imp).all()) and bool(torch.isfinite(scores).all()), "lightgaussian: non-finite scores")
    check(n - n_pruned_alive >= k_prune,
          f"lightgaussian: n_alive {n:,} -> {n_pruned_alive:,}, fewer than k = {k_prune:,} pruned")
    cam_ms = [e0.elapsed_time(e1) for e0, e1 in per_cam]
    print(f"[lightgaussian] ({smi}) prune_list over {len(cams)} cameras + calculate_v_imp_score + "
          f"prune_gaussians at {PRUNE_PERCENT}: n_alive {n:,} -> {n_pruned_alive:,} (k = {k_prune:,}; "
          f"{n_seen:,} Gaussians with importance > 0 in some camera); "
          f"importance_render ms per camera median {np.median(cam_ms):.3f} (min {min(cam_ms):.3f}, max "
          f"{max(cam_ms):.3f}); whole prune {prune_s * 1e3:.1f} ms; peak memory {lg_peak_mb:.0f} MiB")
    del imp, scores

    with tempfile.TemporaryDirectory() as tmp:
        pruned_eval = GaussianSplatEvaluator(lg_model, cfg, EvalConfig(output_dir=tmp, save_images=False))
        reset_counts()
        pruned_metrics = pruned_eval.eval(cams, gts, split="val")
        pe_counts = add_counts("pruned eval", [blend.blend_forward])
        check(pe_counts["blend_forward"] == len(cams), f"pruned eval: {pe_counts['blend_forward']} K1 launches")
        t0 = time.perf_counter()
        pruned_eval.export(os.path.join(tmp, "export"))
        export_s = time.perf_counter() - t0
        splat_bytes = os.path.getsize(os.path.join(tmp, "export", "model.splat"))
        ply_rows = load_gaussian_ply(os.path.join(tmp, "export", "model.ply"), dev).capacity
        ply_mb = os.path.getsize(os.path.join(tmp, "export", "model.ply")) / 2**20
    pm = pruned_metrics["mean"]
    check(np.isfinite(pm["psnr"]) and np.isfinite(pm["lpips_uncalibrated"]), f"pruned eval: non-finite {pm}")
    check(splat_bytes == 32 * n_pruned_alive, f"export: .splat {splat_bytes} bytes for {n_pruned_alive} Gaussians")
    check(ply_rows == n_pruned_alive, f"export: the .ply reads back {ply_rows} rows, not {n_pruned_alive}")
    print(f"[lightgaussian] ({smi}) pruned model against the unpruned model's renders on the {len(cams)} cameras: "
          f"psnr {pm['psnr']:.3f} dB, ssim {pm['ssim']:.5f}, lpips_uncalibrated {pm['lpips_uncalibrated']:.5f}; "
          f"export of {n_pruned_alive:,} Gaussians (.splat {splat_bytes:,} B, .ply {ply_mb:.1f} MiB, points .ply) "
          f"{export_s:.2f} s")
    del lg_model, pruned_eval

    # ---- 6e. the train and eval CLIs, each in its own process ---------------
    root = os.path.dirname(os.path.abspath(__file__))

    def run_cli(module: str, *args: str, config: str = CLI_CONFIG) -> tuple[str, float]:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", module, "--config", config, *args], cwd=root,
                              capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            print(proc.stdout[-4000:] + proc.stderr[-4000:], file=sys.stderr)
        check(proc.returncode == 0, f"python -m {module} {' '.join(args)} exited {proc.returncode}")
        return proc.stdout + proc.stderr, seconds

    with tempfile.TemporaryDirectory() as tmp:
        common = [f"root_dir={tmp}", f"trainer.max_iterations={CLI_STEPS}", "trainer.n_tensorboard=10",
                  "trainer.n_validation=10", "trainer.n_checkpoint=10"]
        log, train_s = run_cli("dogs_tpu_torch.train", *common)
        final = re.search(r"final val: \{'val_psnr': ([-+0-9.eE]+)\}", log)
        check(final is not None, "train CLI: no final validation logged")
        train_val = float(final.group(1))
        log, resume_s = run_cli("dogs_tpu_torch.train", *common, "trainer.resume=true")
        check(f"resumed from step {CLI_STEPS}" in log and "nothing to do" in log,
              "train CLI resume: did not resume to 'nothing to do'")
        log, eval_s = run_cli("dogs_tpu_torch.eval", *common, f"eval.n_test_poses={CLI_POSES}")
        run = os.path.join(tmp, "gs_novel_view_synthesis_synthetic_toy")
        with open(os.path.join(run, "eval", "val", "metrics.json")) as f:
            cli_mean = json.load(f)["mean"]
        check({"psnr", "ssim", "lpips_uncalibrated"} <= set(cli_mean), f"eval CLI metrics.json: {sorted(cli_mean)}")
        check(abs(cli_mean["psnr"] - train_val) <= 0.01,
              f"eval CLI val PSNR {cli_mean['psnr']} vs the train CLI's final validate() {train_val}")
        frames = sorted(f for f in os.listdir(os.path.join(run, "eval", "test")) if f.endswith(".png"))
        check(len(frames) == CLI_POSES, f"eval CLI: {len(frames)} trajectory frames, expected {CLI_POSES}")
        pngs = [os.path.join(run, "eval", "val", f) for f in ("00000.png", "00000_gt.png")]
        pngs += [os.path.join(run, "eval", "test", f) for f in frames]
        for path in pngs:
            check(png.png_size(path) == (96, 80), f"{path}: not a 96x80 PNG")  # synthetic_smoke's camera
        n_alive_cli = cli_mean["num_points"]
        splat_cli = os.path.getsize(os.path.join(run, "export", "model.splat"))
        check(splat_cli == 32 * n_alive_cli, f"eval CLI: .splat {splat_cli} bytes for {n_alive_cli} Gaussians")
        check(load_gaussian_ply(os.path.join(run, "export", "model.ply"), dev).capacity == n_alive_cli,
              "eval CLI: the .ply does not read back n_alive rows")
        gif = os.path.exists(os.path.join(run, "eval", "test", "trajectory.gif"))
    print(f"[cli] ({smi}) train CLI {CLI_STEPS} steps {train_s:.1f} s (final val psnr {train_val:.4f}), resume "
          f"{resume_s:.1f} s (nothing to do), eval CLI {eval_s:.1f} s: val psnr {cli_mean['psnr']:.4f} ssim "
          f"{cli_mean['ssim']:.5f} lpips_uncalibrated {cli_mean['lpips_uncalibrated']:.5f}, {n_alive_cli} "
          f"Gaussians exported, {len(frames)} trajectory frames, GIF {'written' if gif else 'skipped (no imageio)'}")

    # ---- 6f. real-scene training (main paths 7 and 8): a COLMAP scene ----------
    # The bench model rendered at 17 cameras and written as a COLMAP scene
    # with known per-image perturbations (tools/colmap_scene.py), then
    # urban3d_admm.yaml on one device through the factory, with and without
    # the appearance mask.
    with tempfile.TemporaryDirectory() as tmp:
        scene_root = os.path.join(tmp, "data", SCENE_NAME)
        scene_cams = colmap_scene.make_cameras(SCENE_IMAGES, synthetic.BENCH_WIDTH, synthetic.BENCH_HEIGHT,
                                               1000.0, dev)
        t0 = time.perf_counter()
        truth = colmap_scene.write_scene(scene_root, params, scene_cams)
        write_s = time.perf_counter() - t0
        os.makedirs(os.path.join(scene_root, "val", "rgbs"))
        open(os.path.join(scene_root, "val", "rgbs", f"frame_{SCENE_IMAGES - 1:03d}.png"), "w").close()
        del scene_cams
        t0 = time.perf_counter()
        colmap_model = colmap.load_model(os.path.join(scene_root, "sparse", "0"))
        colmap_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tdataset.minify_images(scene_root, 2)
        minify_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tdataset.load_scene(scene_root, factor=2, val_interval=100, normalize=False, use_manhattan_world=True,
                            scene_name=SCENE_NAME, dataset_name="urban3d")  # makes the undistortion cache
        undistort_s = time.perf_counter() - t0
        check(len(colmap_model.images) == SCENE_IMAGES and colmap_model.points_xyz.shape == (n, 3),
              f"real scene: COLMAP model of {len(colmap_model.images)} images, {colmap_model.points_xyz.shape} points")
        del colmap_model
        scene_args = [f"dataset.root_dir={os.path.join(tmp, 'data')}", "dataset.multi_blocks=false",
                      "dataset.factor=2", "appearance.use_trained_exposure=true", "optimizer.lr.pose=1e-4",
                      "geometry.opt_pose_start_iter=10", f"root_dir={os.path.join(tmp, 'out')}",
                      "trainer.enable_tensorboard=false"]

        def scene_trainer(*extra: str):
            config = load_config(os.path.join(root, SCENE_CONFIG), cli_overrides=scene_args + list(extra))
            config.dataset.scene, config.expname = SCENE_NAME, SCENE_EXPNAME
            t0 = time.perf_counter()
            trainer, manager, _ = factory.create_trainer(config)
            torch.cuda.synchronize()
            return trainer, manager, time.perf_counter() - t0

        def scene_run(trainer, label: str) -> tuple[list[float], list[float], float]:
            """SCENE_STEPS steps, each between synchronizes; the kernel
            counts and the peak memory of just these steps."""
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            reset_counts()
            losses, ms = [], []
            for step in range(1, SCENE_STEPS + 1):
                t0 = time.perf_counter()
                m = trainer.train_iteration(step)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(m["loss"])
            for name, launches in add_counts(label, list(counted)).items():
                check(launches == SCENE_STEPS, f"{label}: {name} launched {launches} times, expected one per step")
            losses = torch.stack(losses).tolist()
            check(all(np.isfinite(losses)), f"{label}: non-finite loss")
            first, last = np.mean(losses[:8]), np.mean(losses[-8:])
            check(last < first, f"{label}: loss did not fall: first 8 mean {first}, last 8 mean {last}")
            return losses, ms, torch.cuda.max_memory_allocated(dev) / 2**20

        strainer, smanager, build_s = scene_trainer()
        ts = strainer.state
        tc = strainer.cfg
        check(tc.use_appearance_mask and tc.lambda_mask == 0.5 and tc.use_trained_exposure and tc.optimize_camera_poses
              and tc.opt_pose_start_iter == 10, f"real scene: the config's terms are not all on: {tc}")
        check(hasattr(strainer.images, "hint") and len(strainer.cameras) == SCENE_IMAGES - 1
              and len(strainer.val_cameras) == 1 and strainer.cameras[0].image_index == 0
              and ts.exposure.shape[0] == SCENE_IMAGES - 1,
              "real scene: expected images 0-15 lazily read for training, each owning its row, and 1 val image")
        rows = ts.exposure.shape[0]

        def per_image_errors(state) -> tuple[float, float]:
            e = np.abs(state.exposure[1:rows].cpu().numpy() - truth["exposure"][1:rows]).mean()
            p = np.abs(state.pose_deltas[1:rows].cpu().numpy() - truth["pose_delta"][1:rows]).mean()
            return float(e), float(p)

        before = {k: v.detach().clone() for k, v in appearance.flatten(ts.mask_params).items()}
        before.update(exposure=ts.exposure.clone(), pose_deltas=ts.pose_deltas.clone())
        errors0 = per_image_errors(ts)
        val0 = strainer.validate()["val_psnr"]
        losses, mask_ms, mask_peak_mb = scene_run(strainer, "real scene")
        cam_i = strainer._order[-1] if strainer._order else 0  # the camera of step 41
        path_parity(f"step {SCENE_STEPS + 1}'s inputs (depth_threshold {strainer.raster_cfg.depth_threshold}, "
                    f"max_tiles {strainer.raster_cfg.max_tiles_per_gaussian})", ts.model, strainer.cameras[cam_i],
                    strainer._gt_on_device(cam_i), 0, rcfg=strainer.raster_cfg, tag="real scene")
        val40 = strainer.validate()["val_psnr"]
        errors40 = per_image_errors(ts)
        check(val40 > val0, f"real scene: colour-corrected val PSNR did not rise: {val0:.3f} -> {val40:.3f} dB")
        after = dict(appearance.flatten(ts.mask_params), exposure=ts.exposure, pose_deltas=ts.pose_deltas)
        for key, leaf in after.items():
            check(bool(torch.isfinite(leaf).all()), f"real scene: non-finite {key}")
            check(not torch.equal(leaf.detach(), before[key]), f"real scene: {key} did not move")
        check(bool((ts.pose_deltas[0] == 0).all()) and bool((ts.pose_mu[0] != 0).any()),
              "real scene: image 0's pose row moved, or its moments did not")
        del before, after

        # The mask CNN: device ms of forward + backward at the step's shapes
        # from CUDA events, in exact f32 as the step runs it (cuDNN off) and
        # through cuDNN with TF32 off and on, for their cost and error; its
        # forward and gradients on the card against the CPU at the test
        # size (96x80) at the test bars, and at the step's shapes against a
        # CPU f64 reference, where f32 itself is off by the accumulation
        # error that the CPU f32 run measures.
        with torch.no_grad():
            mask_in = torch.clamp(render_tiled(ts.model.params, strainer.cameras[0], strainer.raster_cfg,
                                               alive=ts.model.alive, active_sh_degree=0).image, 0.0, 1.0)
        cudnn = torch.backends.cudnn
        convs = {
            "exact": appearance.exact_f32,
            "cudnn": lambda: cudnn.flags(enabled=True, benchmark=False, deterministic=False, allow_tf32=False),
            "cudnn_tf32": lambda: cudnn.flags(enabled=True, benchmark=False, deterministic=False, allow_tf32=True),
        }

        def mask_fwd_bwd(mask_params, x, cot, conv="exact"):
            leaves = list(appearance.flatten(mask_params).values()) + [x]
            with convs[conv]():
                mask = appearance.apply_appearance(mask_params, x, 1)
                return [mask.detach()] + list(torch.autograd.grad((mask * cot).sum(), leaves))

        def mask_on(device, dtype, x, cot, mask_params=None):
            """(the mask's parameters (the trained ones by default), x, cot)
            as `dtype` leaves on `device`."""
            p = {k: {kk: torch.as_tensor(vv).detach().to(device, dtype).requires_grad_(True) for kk, vv in v.items()}
                 if isinstance(v, dict) else torch.as_tensor(v).detach().to(device, dtype).requires_grad_(True)
                 for k, v in (mask_params or ts.mask_params).items()}
            return p, x.detach().to(device, dtype).requires_grad_(True), cot.to(device, dtype)

        def scaled_err(got, want):
            """Worst per-leaf max |d| over the leaf's max, forward apart."""
            errs = [float((a.cpu().double() - b.double()).abs().max() / (b.double().abs().max() + 1e-30))
                    for a, b in zip(got, want)]
            return errs[0], max(errs[1:])

        g_cot = torch.Generator().manual_seed(5)
        cot = torch.randn(mask_in.shape, generator=g_cot)
        card_args = mask_on(dev, torch.float32, mask_in, cot)
        cnn_ms = {c: cuda_ms(lambda c=c: mask_fwd_bwd(*card_args, conv=c), 10) for c in convs}
        t0 = time.perf_counter()
        want64 = mask_fwd_bwd(*mask_on("cpu", torch.float64, mask_in, cot))
        cpu32 = mask_fwd_bwd(*mask_on("cpu", torch.float32, mask_in, cot))
        cnn_cpu_s = time.perf_counter() - t0
        card = {c: mask_fwd_bwd(*card_args, conv=c) for c in convs}
        fwd_err, _ = scaled_err(card["exact"], cpu32)
        f32_err = scaled_err(cpu32, want64)[1]
        grad_errs = {c: scaled_err(out, want64)[1] for c, out in card.items()}
        check(fwd_err <= 1e-5, f"real scene: mask CNN forward, card vs CPU, {fwd_err:.3e} of the max > 1e-5")
        check(grad_errs["exact"] <= max(GRAD_ATOL, 2 * f32_err),
              f"real scene: mask CNN gradients on the card {grad_errs['exact']:.3e} of the leaf max from the CPU "
              f"f64 ones, the CPU's f32 {f32_err:.3e}")
        # The CUDA lane's case: the initial weights, inputs from seed 0.
        init = appearance.init_appearance_arrays(4)
        g0 = torch.Generator().manual_seed(0)
        small, small_cot = torch.rand((80, 96, 3), generator=g0), torch.randn((80, 96, 3), generator=g0)
        small_cpu = mask_fwd_bwd(*mask_on("cpu", torch.float32, small, small_cot, init))
        small_fwd, small_grad = scaled_err(mask_fwd_bwd(*mask_on(dev, torch.float32, small, small_cot, init)),
                                           small_cpu)
        check(small_fwd <= 1e-5 and small_grad <= GRAD_ATOL,
              f"real scene: mask CNN at 96x80, card vs CPU: forward {small_fwd:.3e}, gradients {small_grad:.3e}")
        small_cudnn = scaled_err(mask_fwd_bwd(*mask_on(dev, torch.float32, small, small_cot, init), conv="cudnn"),
                                 small_cpu)[1]
        del card, card_args, want64, cpu32, mask_in, cot

        path = strainer.save_checkpoint(smanager)
        reloaded, _ = load_train_state(path, ts)
        a, b = train_state_arrays(ts), train_state_arrays(reloaded)
        check(list(a) == list(b) and all(np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype for k in a),
              "real scene: the checkpoint does not reload bit for bit")
        n_mask_leaves = sum(k.startswith(".mask_params/") for k in a)
        del reloaded, a, b
        log, scene_eval_s = run_cli("dogs_tpu_torch.eval", "--scene", SCENE_NAME, *scene_args, "eval.n_test_poses=2",
                                    config=SCENE_CONFIG)
        with open(os.path.join(tmp, "out", SCENE_EXPNAME, "eval", "val", "metrics.json")) as f:
            scene_eval = json.load(f)["mean"]
        check(abs(scene_eval["psnr"] - val40) <= 1e-4,
              f"real scene: eval CLI val PSNR {scene_eval['psnr']} vs the final validate() {val40}")
        strainer.images.close()
        del strainer, ts

        nomask_trainer, _, nomask_build_s = scene_trainer("geometry.mask=false")
        check(not nomask_trainer.cfg.use_appearance_mask and nomask_trainer.state.mask_params == {},
              "real scene: geometry.mask=false still builds the mask")
        nomask_losses, nomask_ms, nomask_peak_mb = scene_run(nomask_trainer, "real scene, no mask")
        cam_i = nomask_trainer._order[-1] if nomask_trainer._order else 0
        path_parity(f"the no-mask run's step {SCENE_STEPS + 1} inputs", nomask_trainer.state.model,
                    nomask_trainer.cameras[cam_i], nomask_trainer._gt_on_device(cam_i), 0,
                    rcfg=nomask_trainer.raster_cfg, tag="real scene, no mask")
        nomask_trainer.images.close()
        del nomask_trainer
    print(f"[real scene] ({smi}) wrote {SCENE_IMAGES} images of 2304x1728 (PNG) and a COLMAP model of {n:,} points "
          f"in {write_s:.2f} s; scene load: COLMAP read {colmap_s:.3f} s, minify x2 {minify_s:.2f} s, undistort "
          f"cache {undistort_s:.2f} s; create_trainer from the caches {build_s:.2f} s (no mask {nomask_build_s:.2f} s)")
    print(f"[real scene] ({smi}) {SCENE_STEPS} steps at 1152x864 with the mask, exposure and pose refinement: loss "
          f"{losses[0]:.5f} -> {losses[-1]:.5f}; colour-corrected val PSNR {val0:.3f} -> {val40:.3f} dB; ms/step "
          f"median {np.median(mask_ms[8:]):.2f} (first 8 median {np.median(mask_ms[:8]):.2f}); peak memory "
          f"{mask_peak_mb:.0f} MiB")
    print(f"[real scene] ({smi}) the same steps with geometry.mask=false: loss {nomask_losses[0]:.5f} -> "
          f"{nomask_losses[-1]:.5f}; ms/step median {np.median(nomask_ms[8:]):.2f} (first 8 median "
          f"{np.median(nomask_ms[:8]):.2f}); peak memory {nomask_peak_mb:.0f} MiB")
    print(f"[real scene] ({smi}) mask CNN at 1152x864, forward + backward, device ms (CUDA events, 10 runs): "
          f"{cnn_ms['exact']:.3f} in exact f32 (cuDNN off, the step's), {cnn_ms['cudnn']:.3f} through cuDNN with "
          f"TF32 off, {cnn_ms['cudnn_tf32']:.3f} with TF32 on; gradients against the CPU's f64, worst leaf: exact "
          f"{grad_errs['exact']:.2e}, cuDNN {grad_errs['cudnn']:.2e}, cuDNN TF32 {grad_errs['cudnn_tf32']:.2e} "
          f"(CPU f32 {f32_err:.2e}); forward card vs CPU {fwd_err:.2e}; at 96x80 card vs CPU forward "
          f"{small_fwd:.2e}, gradients {small_grad:.2e} (through cuDNN with TF32 off {small_cudnn:.2e}; the "
          f"initial weights) (CPU "
          f"references {cnn_cpu_s:.2f} s)")
    print(f"[real scene] ({smi}) per-image errors against the truth over rows 1-{rows - 1} (mean |d|): exposure "
          f"{errors0[0]:.5f} -> {errors40[0]:.5f}, pose delta {errors0[1]:.3e} -> {errors40[1]:.3e} (step 0 -> "
          f"{SCENE_STEPS}); checkpoint with {n_mask_leaves} mask leaves reloaded bit for bit; eval CLI "
          f"{scene_eval_s:.1f} s: val psnr {scene_eval['psnr']:.6f} (final validate() {val40:.6f})")

    # ---- 7. report ---------------------------------------------------------
    sources = {
        "blend_forward": ("dogs_tpu_torch/csrc/blend_forward.cu", "dogs_tpu/raster/pallas_stream.py:241",
                          "fwd"),
        "blend_backward": ("dogs_tpu_torch/csrc/blend_backward.cu", "dogs_tpu/raster/pallas_stream.py:525",
                           "bwd"),
        "sorted_segment_sum": ("dogs_tpu_torch/csrc/segment_sum.cu", "dogs_tpu/raster/pallas_reduce.py:136",
                               "seg"),
    }
    totals = {fn.__name__: c for fn, c in counted.items()}
    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": src,
            "replaces": tpu,
            "launches": totals[name],
            "max_abs_err": max_err[key],
            "ms": kernel_ms[name],
            "plain_ms": plain_ms[name],
            "bound_ms": bounds[name][0],
            "bound_by": bounds[name][1],
            "share": bounds[name][0] / kernel_ms[name],
            "library_ms": library_ms[name],
        }
        for name, (src, tpu, key) in sources.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
