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
camera), export, the train and eval CLIs, real-scene training (a COLMAP
scene through the data slice and the per-image loss terms), block-parallel
ADMM, Scaffold-GS (anchors decoded per view by MLPs, rendered through
the same three kernels), and coarse-to-fine training with the profiler,
in phases:

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
  6c. densify bench.py --densify's run at full width, built by
              dogs_tpu_torch.bench: 500k points, GT from a second bench scene
              at SH 0, 150 steps with a densify event
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
              back, n_test_poses trajectory frames; python -m
              dogs_tpu_torch.tools.create_ksplat on the exported .ply, the
              .ksplat read back by load_ksplat (centres within 2.5 / 32767)
  6f. real scene  the bench model rendered by the port at 17 cameras
              (1152x864), every image but image 0 under a known exposure,
              shading and pose noise, distorted by an OPENCV k1, upsampled x2
              and written as 2304x1728 PNGs with cameras/images/points3D.bin
              (500k jittered bench means), as scene "rubble" whose
              Mega-NeRF val list holds image 16, so that image 0 (the pose
              gauge) trains; urban3d_admm.yaml on one device
              through dogs_tpu_torch.factory.create_trainer at factor 2 (the
              COLMAP read, by the native C parser (required), minify and
              undistort caches timed; the native parser and the numpy reader
              timed on a written points3D.bin of 2M points with tracks of
              2-8 observations, equal results required), the lazy
              reader, the appearance mask at lambda_mask 0.5, the trained
              exposure and pose refinement from step 10: 40 steps (K1, K2,
              K3 once a step; loss falls; colour-corrected val PSNR rises; the
              mask, exposure and pose leaves finite and moved; image 0's
              pose row still zero, its moments moved), ms/step and
              peak memory, the mask CNN's device ms forward + backward (exact
              f32 as the step runs it, and cuDNN with TF32 off and on), its
              forward and gradients on the card against the CPU at 96x80 at
              1e-5 / 2e-3 of the max, and at 1152x864 on fixed inputs (the
              trained weights, a seeded input, the cotangent of seed 5) the
              forward at 1e-5 and the gradients at 2e-3 of each leaf's max
              against a CPU f64 reference on the card's own ReLU branch
              (the plain f64 differs from every f32 run by the ReLU inputs
              within rounding of 0, printed), the exposure
              and pose errors against the truth at steps 0 and 40, the
              checkpoint reloaded bit for bit, python -m dogs_tpu_torch.eval
              on it in its own process (val PSNR within 1e-4 dB of the final
              validate()), then the same 40 steps with geometry.mask=false
              (its kernels held against plain at its step 41's inputs)
  6g. ADMM    urban3d_admm.yaml's 2x2 blocks on the same scene: python -m
              dogs_tpu_torch.preprocess (four cameras and ~245k points a
              block), then train_admm.train_scene in this process for 60
              master steps (four block steps each): densify at 10 and 20,
              the in-phase prune at 20, the fusion with the post-merge prune
              over the 16 train cameras at 30, consensus rounds at 40, 50
              and 60. K1, K2, K3 once a block step and once a camera of each
              prune, K1 once for the val camera; in every block the loss
              falls in the block phase and the L1 term in the ADMM phase
              (its loss carries the penalty, which jumps at each round);
              every overflow logged; the fused count is the crops' sum less
              the pruned; the residuals finite and rho as adapt_rho gives
              it; at the first ADMM step's inputs, outside the counts, block
              0's kernels and step gradients against plain; ms per master
              step in each phase, per consensus round and per fusion, peak
              memory; the checkpoint resumed in a fresh trainer bit for bit
              and fused by load_fused_from_checkpoint equal to the global
              model; python -m dogs_tpu_torch.eval on it in its own process
              (val PSNR within 1e-4 dB of the final validate()); 4 master
              steps from the post-fusion state at rho x 50 end closer to
              consensus (primal xyz) than 4 at rho = 0
  6i. coarse-to-fine  in 6f's directory after 6g: urban3d_admm.yaml as
              6f runs it with geometry.coarse-to-fine and densify_end_iter 60
              (c2f_interval 20: steps 1-19 at 288x216, a partial tile row,
              20-39 at 576x432, 40-60 at 1152x864), 60 steps through
              GaussianSplatTrainer.train (K1, K2, K3 once a step; the loss
              falls at each factor; ms/step per factor, peak memory; the GT
              cache holds all three factors) with trainer.profile over steps
              18-21 (one Chrome trace naming each kernel 4 times, spans
              train_step_18..21); at the inputs of steps 1, 20 and 40,
              outside the counts and the trace, each kernel and the step's
              gradients against plain; a checkpoint after step 30 resumed in
              a fresh trainer to step 45 bit for bit; then 6g's blocks
              through train_admm.train_scene with coarse-to-fine for 24
              master steps (c2f_interval 8), the fusion after them: 4
              launches of each kernel per master step, block 0's kernels
              against plain at master step 1's inputs, the GT at factors 4
              and 2 streamed, factor 1 from the resident pools
  6h. Scaffold-GS  bench.py --scaffold's run: anchors voxelized at 0.2
              from the 500k bench means (K = 10 offsets), GT from bench scene
              seed 7 at SH 0, the 8 bench cameras, max_tiles 12, 300
              ScaffoldGSTrainer steps with anchor events at 200 and 300 (K1,
              K2, K3 once a step; loss falls; every alive leaf finite; each
              event's growth inputs printed: on this workload nothing grows,
              so one more event after the run, at threshold 1e-9, grows
              anchors, then 10 steps train the grown state; a capacity growth
              must be logged); at step 1's inputs (the untrained decode) and
              step 201's, outside the counts: K1-K3 against plain (segment sum
              bit for bit), the image and every scaffold leaf's and the
              means2d offset's gradient, kernels against plain; ms/step over
              steps 151-270 without an event and bench's iters/sec there, ms
              per event on the host, K at steps 1 and 300, peak memory, a
              stage breakdown of 8 steps, the decode's device ms forward and
              backward, the growth dedup per level; a checkpoint after the
              event at 200 resumed in a fresh trainer for 10 steps, bit for
              bit; then scaffold_gs/synthetic_smoke.yaml through the train CLI
              (20 steps), its resume ("nothing to do") and the eval CLI
              (uncorrected: val PSNR within 1e-4 dB of the final validate(),
              PNGs, .splat, the .ply read back, trajectory frames)
  6j. bench   every mode of python -m dogs_tpu_torch.bench called in this
              process at bench.py's widths (dogs_tpu_torch/bench.py): the
              headline (500k, 16 + 48 steps), --scaling (0.5M-4M) and
              --consensus at bench.py's counts; --quality and --quality-admm
              (1x1) cut to BENCH_QUALITY_STEPS with densify from 200 (events
              at 300-500; the master's fusion at 600 and consensus rounds at
              800-1200), --scaffold-quality cut to BENCH_SCAFFOLD_QUALITY_STEPS,
              on bench.py's GT (its teacher under dogs_tpu's bin budget);
              --densify at cadence 100, --admm and --scaffold shortened
              (BENCH_*_WINDOWS / INTERVALS: 6c and 6h run those workloads in
              full through the same builders); each line's keys (bench.py's
              plus device and peak_mib), a finite value, vs_baseline null, the
              card's nvidia-smi line as its device; the loss falls in every
              training mode and the final val PSNR beats the step-0
              validation in the quality modes; each mode's launches counted
              from 0 and equal to one of each kernel a step (block step,
              importance render) plus one K1 a GT and a val frame
              (`bench_launches`), added to the kernels line; then, outside
              the counts, K1-K3 and one step's gradients against plain (6c's
              bars) at the inputs of --scaling's 4M step 25 (its 24 steps
              taken again) and of the --quality run's next step
  7. report   per-kernel JSON line (time, plain time, bound, share, library
              call time), then the device JSON line (last line)

Each path runs with the kernels' launch counts set to 0 just before it and
read just after; a kernel of the path that was not launched fails the run.
Any failed phase raises, so the exit code is non-zero. Imports no JAX.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

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
MASK_INPUT_SEED = 4  # the mask CNN's fixed input image at the step's shapes
NATIVE_POINTS = 2_000_000  # points3D.bin size of the native parser's timing
# Scene "rubble" of urban3d_admm.yaml: Mega-NeRF's split rule takes the val
# images by name from val/rgbs/, here the last, so that image 0 (the pose
# gauge) trains.
SCENE_NAME = "rubble"
SCENE_EXPNAME = f"gs_novel_view_synthesis_urban3d_{SCENE_NAME}"  # the CLIs' name for it
# urban3d_admm.yaml's 80k steps cut to 60 master steps with its events kept:
# densify at 10 and 20, the in-phase prune at 20, the fusion at 30, three
# consensus rounds.
ADMM_STEPS = 60
ADMM_CUTS = [f"trainer.max_iterations={ADMM_STEPS}", "geometry.densify_start_iter=5",
             "geometry.densification_interval=10", "geometry.densify_end_iter=30",
             "trainer.admm.consensus_interval=10", "prune.iterations=[20]", "trainer.n_validation=0",
             "trainer.n_checkpoint=30"]
RHO_SCALE, RHO_STEPS = 50.0, 4
# bench.py --scaffold's run (densify_start_iter 100, every 100) for 300
# steps, so that anchor events run at 200 and 300 (the first at start < step),
# with bench's timed window of 120 steps after 150; a checkpoint after the
# event at 200 resumed for 10 steps.
# Coarse-to-fine (6i): densify_end_iter 60 gives c2f_interval 20, so steps
# 1-19 train at factor 4, 20-39 at 2, 40-60 at 1; the profiler traces steps
# 18-21 across the 4 -> 2 switch; a checkpoint at 30 resumes to 45 across the
# 2 -> 1 switch. The master: 24 steps at c2f_interval 8, the fusion after them.
C2F_STEPS, C2F_INTERVAL = 60, 20
C2F_PROFILE = (18, 21)
C2F_PARITY_STEPS = (1, 20, 40)
C2F_CKPT, C2F_RESUME_TO = 30, 45
C2F_ADMM_STEPS = 24
SCAFFOLD_CONFIG = "config/scaffold_gs/synthetic_smoke.yaml"
SCAFFOLD_EVERY, SCAFFOLD_RESUME = 100, 10
SCAFFOLD_STEPS, SCAFFOLD_EVENTS = 3 * SCAFFOLD_EVERY, (2 * SCAFFOLD_EVERY, 3 * SCAFFOLD_EVERY)
SCAFFOLD_WINDOW = (SCAFFOLD_EVERY * 3 // 2 + 1, SCAFFOLD_EVERY * 27 // 10)
# Phase 6j: bench.py's quality runs cut from 6000 / 3000 steps, densify from
# 200 so that three events (300-500) and, for the master, the fusion at 600
# and three consensus rounds fall inside.
BENCH_QUALITY_STEPS, BENCH_DENSIFY_START, BENCH_SCAFFOLD_QUALITY_STEPS = 1200, 200, 600
# --densify (cadence 100), --admm and --scaffold shortened: 6c and 6h run the
# first and the last in full through the same builders. Warm-up and timed
# steps (--admm: consensus intervals of 200 steps); --densify keeps an event
# in each window, --scaffold its first anchor event.
BENCH_DENSIFY_WINDOWS, BENCH_ADMM_INTERVALS, BENCH_SCAFFOLD_WINDOWS = (100, 100), (1, 1), (100, 20)


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


def native_parser_times(path: str) -> tuple[float, float, int]:
    """Write a points3D.bin of NATIVE_POINTS points with tracks of 2-8
    observations, read it with the native parser and the numpy reader
    (equal results required); returns (native s, numpy s, points)."""
    from dogs_tpu_torch.data import colmap, native

    rng = np.random.RandomState(0)
    n = NATIVE_POINTS
    tracks = rng.randint(2, 9, n).astype(np.int64)
    sizes = 51 + 8 * tracks
    offsets = 8 + np.cumsum(sizes) - sizes
    head = np.zeros(n, np.dtype([("id", "<u8"), ("xyz", "<f8", (3,)), ("rgb", "u1", (3,)), ("err", "<f8"),
                                 ("track_len", "<u8")]))
    head["id"] = np.arange(1, n + 1)
    head["xyz"] = rng.randn(n, 3)
    head["rgb"] = rng.randint(0, 256, (n, 3))
    head["err"] = rng.rand(n)
    head["track_len"] = tracks
    buf = rng.randint(0, 256, 8 + int(sizes.sum())).astype(np.uint8)  # the tracks' bytes stay random
    buf[:8] = np.frombuffer(np.uint64(n).tobytes(), np.uint8)
    buf[offsets[:, None] + np.arange(51)] = head.view(np.uint8).reshape(n, 51)
    buf.tofile(path)
    lib = native.load()
    t0 = time.perf_counter()
    fast = native.read_points3d_bin(lib, path)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    slow = colmap.read_points3d_bin_numpy(path)
    numpy_s = time.perf_counter() - t0
    check(all(np.array_equal(a, b) for a, b in zip(fast, slow)) and np.array_equal(fast[0], head["xyz"]),
          "native parser: differs from the numpy reader")
    os.unlink(path)
    return native_s, numpy_s, n


def bench_launches(mode: str, views: int = 40, val_views: int = 2) -> tuple[int, int]:
    """The (K1, K2 = K3) launches that each of 6j's runs must make: one of
    each kernel a training step (block step, importance render), one K1 a GT
    render (the quality scene's `views`, bench.py's 8 teacher frames) and a
    val frame (`val_views` at step 0, at each VAL_EVERY boundary before the
    end, and at the end)."""
    from dogs_tpu_torch.bench import VAL_EVERY

    def vals(steps):
        return val_views * (2 + len(range(VAL_EVERY, steps, VAL_EVERY)))

    steps, k1_only = {
        "headline": (16 + 48, 0),
        "--scaling": (4 * (8 + 16), 0),
        "--densify --cadence 100": (sum(BENCH_DENSIFY_WINDOWS), 8),
        "--quality": (BENCH_QUALITY_STEPS, views + vals(BENCH_QUALITY_STEPS)),
        "--admm": (sum(BENCH_ADMM_INTERVALS) * 200, 0),
        "--consensus": (0, 0),
        # the fusion's post-merge prune: one importance render a train view
        "--quality-admm": (BENCH_QUALITY_STEPS + views - val_views, views + vals(BENCH_QUALITY_STEPS)),
        "--scaffold": (sum(BENCH_SCAFFOLD_WINDOWS), 8),
        "--scaffold-quality": (BENCH_SCAFFOLD_QUALITY_STEPS, views + vals(BENCH_SCAFFOLD_QUALITY_STEPS)),
    }[mode]
    return steps + k1_only, steps


def bench_phase(h) -> None:
    """Phase 6j: each mode function of dogs_tpu_torch.bench in this process
    at bench.py's widths, with the quality runs cut and --densify, --admm
    and --scaffold shortened (module docstring). Each mode's launches are
    counted from 0 and must be `bench_launches`'. After the counted runs,
    K1-K3 and one step's gradients are held against plain at the inputs of
    --scaling's largest N (its step 25, the run's 24 steps taken again) and
    of the --quality run's next step. `h` carries main's helpers: dev, smi, counted, reset_counts,
    add_counts, path_parity. The modes' JSON lines are printed here prefixed
    "[bench]", so that the report's two lines stay the only bare JSON lines."""
    import contextlib
    import io

    from dogs_tpu_torch import bench

    dev, smi = h.dev, h.smi
    runs = {
        "headline": lambda: bench.bench_headline(device=dev),
        "--scaling": lambda: bench.scaling_curve(device=dev),
        "--densify --cadence 100": lambda: bench.bench_densify(cadence=100, warm=BENCH_DENSIFY_WINDOWS[0],
                                                               timed=BENCH_DENSIFY_WINDOWS[1], device=dev),
        "--quality": lambda: bench.bench_quality(steps=BENCH_QUALITY_STEPS, densify_start=BENCH_DENSIFY_START,
                                                 device=dev),
        "--admm": lambda: bench.bench_admm(warm_intervals=BENCH_ADMM_INTERVALS[0],
                                           timed_intervals=BENCH_ADMM_INTERVALS[1], device=dev),
        "--consensus": lambda: bench.bench_consensus(device=dev),
        "--quality-admm": lambda: bench.bench_quality_admm(steps=BENCH_QUALITY_STEPS,
                                                           densify_start=BENCH_DENSIFY_START, device=dev),
        "--scaffold": lambda: bench.bench_scaffold(warm=BENCH_SCAFFOLD_WINDOWS[0], timed=BENCH_SCAFFOLD_WINDOWS[1],
                                                   device=dev),
        "--scaffold-quality": lambda: bench.bench_scaffold_quality(steps=BENCH_SCAFFOLD_QUALITY_STEPS, device=dev),
    }
    quality = {"--quality", "--quality-admm", "--scaffold-quality"}
    bench_log = logging.getLogger(bench.__name__)
    records: list[logging.LogRecord] = []
    catcher = logging.Handler(logging.INFO)
    catcher.emit = records.append
    level = bench_log.level
    bench_log.addHandler(catcher)
    bench_log.setLevel(logging.INFO)
    quality_trainer = bench.quality_trainer
    captured = []  # the --quality run's trainer, for the parity after the runs

    def capturing_trainer(*a, **kw):
        captured.append(quality_trainer(*a, **kw))
        return captured[-1]

    bench.quality_trainer = capturing_trainer
    seconds, launches = {}, {}
    try:
        for mode, run in runs.items():
            records.clear()
            out = io.StringIO()
            h.reset_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                lines = run()
            seconds[mode] = time.perf_counter() - t0
            for text in out.getvalue().splitlines():
                print(f"[bench] {text}")
            launches[mode] = h.add_counts(f"bench {mode}", list(h.counted) if mode != "--consensus" else [])
            k1, k23 = bench_launches(mode)
            check(launches[mode] == {"blend_forward": k1, "blend_backward": k23, "sorted_segment_sum": k23},
                  f"bench {mode}: launches {launches[mode]}, expected K1 {k1}, K2 and K3 {k23}")
            messages = [r.getMessage() for r in records]
            check(len(lines) == {"--scaling": 4, "--consensus": 3}.get(mode, 1),
                  f"bench {mode}: {len(lines)} lines")
            for line in lines:
                check("error" not in line, f"bench {mode}: {line}")
                check({"metric", "value", "unit", "vs_baseline", "device", "peak_mib"} <= set(line),
                      f"bench {mode}: keys {sorted(line)}")
                check(np.isfinite(line["value"]) and line["value"] > 0 and line["vs_baseline"] is None,
                      f"bench {mode}: {line}")
                check(line["device"] == smi and line["peak_mib"] > 0, f"bench {mode}: device or peak {line}")
            if mode != "--consensus":
                falls = [re.match(r"\S+: loss ([-+0-9.eE]+) -> ([-+0-9.eE]+)", m) for m in messages]
                falls = [(float(f.group(1)), float(f.group(2))) for f in falls if f]
                check(len(falls) == len(lines) and all(b < a for a, b in falls),
                      f"bench {mode}: the loss did not fall: {falls}")
            if mode in quality:
                vals = [re.match(r"\S+: val psnr ([-+0-9.eE]+) at step (\d+)", m) for m in messages]
                vals = [(int(v.group(2)), float(v.group(1))) for v in vals if v]
                check(vals[0][0] == 0 and vals[-1][1] > vals[0][1] and round(vals[-1][1], 2) == lines[0]["value"],
                      f"bench {mode}: val PSNR did not rise above the step-0 validation: {vals}")
                print(f"[bench] {mode} val psnr by step: {vals}")
    finally:
        bench.quality_trainer = quality_trainer
        bench_log.removeHandler(catcher)
        bench_log.setLevel(level)
    print(f"[bench] ({smi}) 9 modes in {sum(seconds.values()):.1f} s ("
          + ", ".join(f"{m} {t:.1f}" for m, t in seconds.items()) + "); kernel launches "
          + ", ".join(f"{m} {c['blend_forward']}/{c['blend_backward']}/{c['sorted_segment_sum']}"
                      for m, c in launches.items()))

    # Outside the counts: the kernels at the inputs these runs gave them. The
    # --scaling run's 24 steps at its largest N are taken again, so that the
    # parity holds at its step 25 (at step 1 the bench model's isotropic
    # scales make the quat gradient zero but for rounding, and a bar scaled
    # by the leaf's max would compare rounding noise with rounding noise).
    t0 = time.perf_counter()
    n_max, n_steps = 4_000_000, 8 + 16
    ts, step_fn, cams, gts = bench.headline_workload(n_max, device=dev)
    for i in range(n_steps):
        ts, _ = step_fn(ts, cams[i % 8], gts[i % 8])
    h.path_parity(f"--scaling {n_max // 1000}k step {n_steps + 1} inputs", ts.model, cams[n_steps % 8],
                  gts[n_steps % 8], 3, tag="bench")
    del ts, step_fn, cams, gts
    torch.cuda.empty_cache()
    tr = captured[0]
    step = tr.state.step + 1
    i = tr._order[-1] if tr._order else 0
    h.path_parity(f"--quality step {step} inputs", tr.state.model, tr.cameras[i], tr._gt_on_device(i),
                  tr.active_sh_degree(step), tag="bench")
    del captured[:], tr
    print(f"[bench] parity at the bench's inputs: {time.perf_counter() - t0:.1f} s")


def scaffold_phase(h) -> None:
    """Phase 6h: Scaffold-GS, bench.py --scaffold's run at full width, then
    the scaffold CLIs. `h` carries main's helpers: dev, smi, counted,
    reset_counts, add_counts, check_segment_sum, random_cot, run_cli,
    max_err."""
    from dogs_tpu_torch import bench
    from dogs_tpu_torch.data import synthetic
    from dogs_tpu_torch.fields import scaffold as sc
    from dogs_tpu_torch.fields.appearance import exact_f32
    from dogs_tpu_torch.fields.io import load_gaussian_ply
    from dogs_tpu_torch.raster import blend, reduce
    from dogs_tpu_torch.raster.binning import build_tile_bins
    from dogs_tpu_torch.raster.projection import project_gaussians
    from dogs_tpu_torch.raster.tiled import RasterConfig, entry_matrix
    from dogs_tpu_torch.train.checkpoint import CheckpointManager
    from dogs_tpu_torch.utils import png

    dev, smi, counted = h.dev, h.smi, h.counted
    n = synthetic.BENCH_GAUSSIANS
    cams = synthetic.bench_cameras(8, device=dev)
    kcfg = RasterConfig(max_tiles_per_gaussian=BENCH_MT)
    kplain = dataclasses.replace(kcfg, use_kernel=False)
    # bench.py --scaffold's workload as dogs_tpu_torch.bench builds it.
    gts = bench.teacher_gts(n, cams, dev)
    scfg = bench.scaffold_config(SCAFFOLD_EVERY)

    def new_trainer():
        return bench.scaffold_trainer(cams, gts, scfg, n, dev)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer = new_trainer()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    anchors0, cap0 = int(trainer.state.num_alive), trainer.state.capacity
    print(f"[scaffold] ({smi}) trainer from {n:,} points at voxel 0.2: {anchors0:,} anchors x {scfg.k_offsets} "
          f"offsets, capacity {cap0:,}, init {init_s:.2f} s")

    def next_camera(tr) -> int:
        """The camera the trainer's next step takes, without drawing."""
        if tr._order:
            return tr._order[-1]
        peek = copy.deepcopy(tr.rng)
        return int(peek.permutation(len(tr.cameras))[-1])

    def parity(label, state, i):
        """Each kernel against its plain version at this path's inputs (the
        decode of camera i with the prefilter, colours overridden), the
        image and every leaf's and the means2d offset's gradient kernels
        against plain; outside the counts. Returns the peak memory before
        it and resets the peak after it."""
        saved = {fn: fn.launches for fn in counted}
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        sp, alive, cam, gt = state.params, state.alive, cams[i], gts[i]
        with torch.no_grad():
            visible = sc.anchor_frustum_mask(sp, cam)
            gauss, colors, neural_alive = sc.generate_neural_gaussians(sp, cam, alive=alive, visible_mask=visible)
            proj = project_gaussians(gauss, cam, alive=neural_alive, active_sh_degree=0, color_override=colors)
            bins = build_tile_bins(proj, cam.height, cam.width, max_tiles_per_gaussian=BENCH_MT)
            nty, ntx = -(-cam.height // blend.TILE), -(-cam.width // blend.TILE)
            args = (entry_matrix(proj), bins.sorted_idx, bins.tile_starts, nty, ntx, cam.width, cam.height)
            ent_n, idx, starts, *grid = args
            got, want = blend.blend_forward(*args), blend.blend_forward_reference(*args)
            errs = [mostly_close(got[:, rows], want[:, rows], tol, name=f"{label} forward {what}")
                    for rows, tol, what in ((slice(0, 3), 3e-3, "rgb"), (3, 5e-3, "alpha"), (4, 3e-3, "invdepth"))]
            h.max_err["fwd"] = max(h.max_err["fwd"], *errs)
            cot = h.random_cot(args, seed=19)
            d1 = blend.blend_backward(ent_n, idx, starts, cot, *grid)
            dref = blend.blend_backward_reference(ent_n, idx, starts, cot, *grid)
            check(bool(torch.isfinite(d1).all()) and not d1[:, 10:].any(),
                  f"{label}: backward output non-finite or columns 10-15 written")
            err = max(mostly_close(d1[:, c], dref[:, c], GRAD_ATOL, name=f"{label} backward column {c}")
                      for c in range(blend.N_GRADS))
            h.max_err["bwd"] = max(h.max_err["bwd"], err)
            src, runs = reduce.gaussian_runs(bins.order, idx, gauss.capacity)
            for dt in reduce.REDUCE_DTYPES:
                h.check_segment_sum(f"{label} {dt}", d1, src, runs, gauss.capacity, dt)
            img_k = sc.render_scaffold(sp, cam, kcfg, alive=alive).image
            img_p = sc.render_scaffold(sp, cam, kplain, alive=alive).image
            img_err = mostly_close(img_k, img_p, 3e-3, name=f"{label} image")
        k_entries, n_neural = idx.shape[0], int(neural_alive.sum())
        del got, want, d1, dref, cot, args, ent_n, proj, bins
        _, gk, ok, _ = sc.scaffold_loss_and_grads(sp, cam, gt, alive, scfg, kcfg)
        _, gp, op, _ = sc.scaffold_loss_and_grads(sp, cam, gt, alive, scfg, kplain)
        worst = {}
        for name, a, b in zip(list(sp.leaves()) + ["means2d_offset"], gk + [ok], gp + [op]):
            if b.numel() == 0:
                continue
            check(bool(torch.isfinite(a).all()), f"{label}: non-finite kernel gradient {name}")
            mostly_close(a, b, GRAD_ATOL, name=f"{label} grad {name}")
            worst[name] = float(((a - b).abs() / (b.abs().max() + 1e-12)).max())
        print(f"[scaffold] ({smi}) {label}: camera {i}, {int(alive.sum()):,} anchors alive, {n_neural:,} neural "
              f"Gaussians alive, K={k_entries:,}: image max|d| {img_err:.3e}, K1 max|d| {max(errs):.3e}, K2 max|d| "
              f"{err:.3e}, K3 bit for bit; gradients kernels vs plain, worst scaled |d| per leaf "
              + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))
        for fn, c in saved.items():
            fn.launches = c
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        return peak

    grow = sc.grow_and_prune_anchors
    events: list[dict] = []

    def timed_grow(state, cfg, rng, do_prune):
        torch.cuda.synchronize()
        ev = dict(step=state.step, cap0=state.capacity, alive0=int(state.num_alive),
                  inputs=(state.offset_grad_accum.clone(), state.offset_denom.clone(), state.alive.clone()))
        t0 = time.perf_counter()
        new, stats = grow(state, cfg, rng, do_prune)
        torch.cuda.synchronize()
        ev.update(ms=(time.perf_counter() - t0) * 1e3, cap1=new.capacity, alive1=int(new.num_alive), **stats)
        events.append(ev)
        return new, stats

    tmp = tempfile.mkdtemp()
    manager = CheckpointManager(os.path.join(tmp, "model"))
    step_log: list[tuple[int, float, dict]] = []
    peaks: list[int] = []
    snapshot: dict = {}
    resume_path: list[str] = []
    step_iteration = trainer.train_iteration

    def timed_iteration(step):
        resume_at = SCAFFOLD_EVENTS[0]
        if step in (1, resume_at + 1):
            tag = "untrained decode" if step == 1 else f"after the event at {resume_at}"
            peaks.append(parity(f"step {step}'s inputs ({tag})", trainer.state, next_camera(trainer)))
        if step == resume_at + 1:
            resume_path.append(trainer.save_checkpoint(manager))
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = step_iteration(step)
        torch.cuda.synchronize()
        step_log.append((step, (time.perf_counter() - t) * 1e3, m))
        if step == resume_at + SCAFFOLD_RESUME:
            snapshot.update({k: v.copy() for k, v in sc.scaffold_state_arrays(trainer.state).items()})
        return m

    trainer.train_iteration = timed_iteration
    records: list[logging.LogRecord] = []
    catcher = logging.Handler(logging.INFO)
    catcher.emit = records.append
    sc_log = logging.getLogger(sc.__name__)
    level = sc_log.level
    sc_log.addHandler(catcher)
    sc_log.setLevel(logging.INFO)
    sc.grow_and_prune_anchors = timed_grow
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    h.reset_counts()
    try:
        trainer.train(num_iterations=SCAFFOLD_STEPS, log_every=50)
        torch.cuda.synchronize()
        counts = h.add_counts("scaffold", list(counted))
        peak_mb = max([torch.cuda.max_memory_allocated(dev)] + peaks) / 2**20
    finally:
        sc.grow_and_prune_anchors = grow
        sc_log.removeHandler(catcher)
        sc_log.setLevel(level)
    for name, launches in counts.items():
        check(launches == SCAFFOLD_STEPS, f"scaffold: {name} launched {launches} times, expected one per step")
    losses = torch.stack([m["loss"] for _, _, m in step_log]).tolist()
    check(all(np.isfinite(losses)), "scaffold: non-finite loss")
    first, last = np.mean(losses[:8]), np.mean(losses[-8:])
    check(last < first, f"scaffold: loss did not fall: first 8 mean {first}, last 8 mean {last}")
    check([ev["step"] for ev in events] == list(SCAFFOLD_EVENTS), f"scaffold: events at {[e['step'] for e in events]}")

    def growth_inputs(ev) -> str:
        """What decided an event's growth: the offsets past the window count
        (denom > check_interval * success_threshold / 2, alive), their mean
        screen gradients, and how many reach each level's threshold."""
        acc, den, alive_ev = (t.cpu().numpy() for t in ev.pop("inputs"))
        grads = np.where(den > 0, acc / np.maximum(den, 1.0), 0.0)
        ok = (den > scfg.check_interval * scfg.success_threshold * 0.5) & alive_ev[:, None]
        g = grads[ok]
        levels = [scfg.densify_grad_threshold * (scfg.update_hierarchy_factor // 2) ** i
                  for i in range(scfg.update_depth)]
        q = np.quantile(g, [0.5, 0.99, 0.999]) if g.size else [0.0] * 3
        return (f"{int(ok.sum()):,} offsets past the window; mean screen gradient median {q[0]:.2e}, 99% {q[1]:.2e}, "
                f"99.9% {q[2]:.2e}, max {g.max() if g.size else 0.0:.2e}; at or over each level's threshold: "
                + ", ".join(f"{t:.0e}: {int((g >= t).sum()):,}" for t in levels))

    diagnostics = [growth_inputs(ev) for ev in events]
    msgs = [r.getMessage() for r in records]

    def check_capacity_log(ev):
        grown_log = f"anchor capacity grown to {ev['cap1']}" in msgs
        check(grown_log == (ev["cap1"] != ev["cap0"]), f"scaffold: capacity {ev['cap0']} -> {ev['cap1']}, logged "
              f"{grown_log}")

    for ev in events:
        check_capacity_log(ev)
    state = trainer.state

    def check_finite(state, label):
        for key, leaf in state.params.leaves().items():
            rows = leaf[state.alive] if key[1:] in sc.ANCHOR_LEAVES else leaf
            check(bool(torch.isfinite(rows).all()), f"scaffold: non-finite {key} among the alive anchors {label}")

    check_finite(state, "after the run")
    window = [(s, ms) for s, ms, _ in step_log if SCAFFOLD_WINDOW[0] <= s <= SCAFFOLD_WINDOW[1]]
    quiet = [ms for s, ms in window if s not in SCAFFOLD_EVENTS]
    its = len(window) / (sum(ms for _, ms in window) / 1e3)
    k_first, k_last = step_log[0][2]["bin_valid"], step_log[-1][2]["bin_valid"]

    # Where a step's time goes: CUDA events at the stage boundaries of 8 more
    # steps from the final state (outside the counts; the events add host
    # time, so read the shares). Stages: the prefilter, the decode forward,
    # the render, the loss forward, the whole backward (the loss's, K2, the
    # K->N reduce, K3, the projection's and the decode's VJPs), dense Adam
    # over every leaf, then the statistics and metrics.
    saved = {fn: fn.launches for fn in counted}
    marks: list[tuple[str, torch.cuda.Event]] = []

    def mark(label):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append((label, e))

    def marked(fn, before, after):
        def run(*a, **kw):
            mark(before(marks[-1][0] if marks else None) if callable(before) else before)
            out = fn(*a, **kw)
            mark(after)
            return out
        return run

    wrapped = {"anchor_frustum_mask": ("start", "prefilter"), "generate_neural_gaussians": ("-", "decode fwd"),
               "render_tiled": ("-", "render fwd (project, bin, K1)"), "ssim": ("-", "loss fwd"),
               "adam_step": (lambda last: "backward" if last == "loss fwd" else "Adam", "Adam")}
    originals_6h = {name: getattr(sc, name) for name in wrapped}
    for name, (before, after) in wrapped.items():
        setattr(sc, name, marked(originals_6h[name], before, after))
    stage_ms: dict[str, list[float]] = {}
    try:
        for i in range(len(cams)):
            marks.clear()
            trainer._step_fn(trainer.state, cams[i], gts[i])
            mark("stats + metrics")
            torch.cuda.synchronize()
            per_step: dict[str, float] = {}
            for (_, e0), (label, e1) in zip(marks, marks[1:]):
                if label != "-":
                    per_step[label] = per_step.get(label, 0.0) + e0.elapsed_time(e1)
            for label, ms in per_step.items():
                stage_ms.setdefault(label, []).append(ms)
    finally:
        for name, fn in originals_6h.items():
            setattr(sc, name, fn)
    for fn, c in saved.items():
        fn.launches = c
    stage_total = sum(np.median(v) for v in stage_ms.values())

    # The decode alone (prefilter, the three MLPs and the assembly) at the
    # final state on camera 0, device ms from CUDA events: forward, and
    # forward + backward to every leaf from fixed cotangents.
    sp, alive = state.params, state.alive
    leaves = list(sp.leaves().values())
    g = torch.Generator(device=dev).manual_seed(3)

    def decode(cots=None):
        with exact_f32():
            vis = sc.anchor_frustum_mask(sp, cams[0])
            gauss, colors, _, aux = sc.generate_neural_gaussians(sp, cams[0], alive=alive, visible_mask=vis,
                                                                 with_aux=True)
            outs = [gauss.xyz, gauss.log_scale, gauss.quat, gauss.logit_opacity, colors, aux["scale"]]
            if cots is None:
                return outs
            total = sum((o * c).sum() for o, c in zip(outs, cots))
            return torch.autograd.grad(total, leaves, allow_unused=True)

    with torch.no_grad():
        cots = [torch.randn(o.shape, generator=g, device=dev) for o in decode()]
        fwd_ms = cuda_ms(decode, 20)
    fwd_bwd_ms = cuda_ms(lambda: decode(cots), 20)
    n_decoded = int(alive.sum())

    # bench.py's run grows no anchor at its events (the cells of the two
    # coarse levels all hold an anchor; the fine level's threshold is 4x
    # densify_grad_threshold, past the offsets' mean screen gradients, see
    # the diagnostics printed below). So the growth path (np.unique, the set
    # dedup, np.maximum.at, the slot fill, the capacity growth with the
    # moments' zero extension) runs at full width in one more event after
    # the counted run, without pruning, at a threshold every offset past the
    # window reaches, on the final state compacted to its alive anchors: with
    # no free slot, every new anchor needs a capacity growth. SCAFFOLD_RESUME
    # steps train the grown state. The compacted state is checkpointed first,
    # and a fresh
    # trainer resumed from it (across the capacity change) takes the same
    # event and steps bit for bit. All outside the counts.
    saved = {fn: fn.launches for fn in counted}
    forced = dataclasses.replace(scfg, densify_grad_threshold=1e-9)
    keep = state.alive.cpu().numpy()
    cut = int(keep.sum())
    trainer.state = sc.scaffold_state_from_arrays(
        {k: v[keep] if v.ndim and v.shape[0] == state.capacity else v
         for k, v in sc.scaffold_state_arrays(state).items()}, dev)
    cut_step = trainer.state.step
    cut_path = trainer.save_checkpoint(manager)
    cut_moments = [getattr(m, n).clone() for m in (trainer.state.mu, trainer.state.nu) for n in sc.ANCHOR_LEAVES]
    del trainer.train_iteration  # the class's, untimed

    def forced_event(tr) -> dict:
        tr.state, _ = timed_grow(tr.state, forced, tr.rng, False)
        ev = events.pop()
        ev.pop("inputs")
        return ev

    def train_on(tr) -> list[float]:
        return [float(tr.train_iteration(tr.state.step + 1)["loss"]) for _ in range(SCAFFOLD_RESUME)]

    records.clear()
    sc_log.addHandler(catcher)
    sc_log.setLevel(logging.INFO)
    try:
        extra = forced_event(trainer)
    finally:
        sc_log.removeHandler(catcher)
        sc_log.setLevel(level)
    msgs = [r.getMessage() for r in records]
    check(extra["grown"] > 0 and extra["alive1"] == extra["alive0"] + extra["grown"] and extra["cap1"] > cut,
          f"scaffold: the extra event did not grow the anchors and the capacity: {extra}")
    check_capacity_log(extra)
    grown_moments = [getattr(m, n) for m in (trainer.state.mu, trainer.state.nu) for n in sc.ANCHOR_LEAVES]
    check(all(torch.equal(g[:cut], c) and not g[cut:].any() for g, c in zip(grown_moments, cut_moments)),
          "scaffold: the grown moments are not the old ones zero-extended")
    del cut_moments, grown_moments
    grown_losses = train_on(trainer)
    check(all(np.isfinite(grown_losses)), f"scaffold: non-finite loss after the growth: {grown_losses}")
    check_finite(trainer.state, "after the growth")
    grown = new_trainer()
    check(grown.load_checkpoint(manager, cut_path) == cut_step and grown.state.capacity == cut,
          f"scaffold: the compacted checkpoint resumed at capacity {grown.state.capacity}, not {cut}")
    forced_event(grown)
    train_on(grown)
    want, got = sc.scaffold_state_arrays(trainer.state), sc.scaffold_state_arrays(grown.state)
    check(list(got) == list(want) and all(np.array_equal(got[k], want[k]) and got[k].dtype == want[k].dtype
                                          for k in got),
          "scaffold: the run resumed before the capacity growth differs from the uninterrupted one")
    n_grown_leaves = len(got)
    del grown, want, got
    for fn, c in saved.items():
        fn.launches = c

    # The checkpoint after the first event, resumed in a fresh trainer for
    # SCAFFOLD_RESUME steps, against the uninterrupted run (outside the counts).
    resumed = new_trainer()
    check(resumed.load_checkpoint(manager, resume_path[0]) == SCAFFOLD_EVENTS[0],
          "scaffold: the checkpoint did not resume after the first event")
    resumed.train(num_iterations=SCAFFOLD_RESUME, log_every=0)
    got = sc.scaffold_state_arrays(resumed.state)
    same = list(got) == list(snapshot) and all(
        np.array_equal(got[k], snapshot[k]) and got[k].dtype == snapshot[k].dtype for k in got)
    diffs = {k: float(np.abs(got[k].astype(np.float64) - snapshot[k]).max()) for k in got
             if got[k].shape == snapshot[k].shape and got[k].size}
    for fn, c in saved.items():
        fn.launches = c
    check(same, "scaffold: the resumed run differs from the uninterrupted one; largest differences "
          + ", ".join(f"{k} {v:.3e}" for k, v in sorted(diffs.items(), key=lambda kv: -kv[1])[:5]))
    del resumed, trainer, state, sp, leaves
    shutil.rmtree(tmp)

    print(f"[scaffold] ({smi}) {SCAFFOLD_STEPS} steps, bench.py --scaffold's run (1152x864, 8 cameras, "
          f"max_tiles 12): loss {losses[0]:.5f} -> {losses[-1]:.5f} (mean of the first 8 {first:.5f}, last 8 "
          f"{last:.5f}); ms/step median over steps {SCAFFOLD_WINDOW[0]}-{SCAFFOLD_WINDOW[1]} without an event "
          f"{np.median(quiet):.2f} (min {min(quiet):.2f}, max {max(quiet):.2f}); bench's iters/sec over that "
          f"window {its:.3f}; K at step 1 {k_first:,}, at step {SCAFFOLD_STEPS} {k_last:,}; peak memory "
          f"{peak_mb:.0f} MiB")
    for ev, why in zip(events, diagnostics):
        print(f"[scaffold] ({smi}) event at step {ev['step']}: anchors {ev['alive0']:,} -> {ev['alive1']:,} (+"
              f"{ev['grown']:,} -{ev['pruned']:,}), capacity {ev['cap0']:,} -> {ev['cap1']:,}; host "
              f"{ev['ms']:.1f} ms (grow_and_prune_anchors, with the dedup and the copies both ways); {why}")
    print(f"[scaffold] ({smi}) one more event after the run at threshold 1e-9, without pruning, on the state "
          f"compacted to its alive anchors: anchors {extra['alive0']:,} -> {extra['alive1']:,} (+{extra['grown']:,}), "
          f"capacity {extra['cap0']:,} -> {extra['cap1']:,} (logged; the anchor moments zero-extended); host "
          f"{extra['ms']:.1f} ms; {SCAFFOLD_RESUME} steps on the grown state: loss {grown_losses[0]:.5f} -> "
          f"{grown_losses[-1]:.5f}, every alive leaf finite; the compacted state's checkpoint resumed in a fresh trainer "
          f"of capacity {cap0:,} and taken through the same event and steps: equal bit for bit "
          f"({n_grown_leaves} leaves)")
    print(f"[scaffold] ({smi}) stages of a step from the final state (CUDA events, median of 8 steps): "
          + ", ".join(f"{label} {np.median(v):.3f} ms ({100 * np.median(v) / stage_total:.1f}%)"
                      for label, v in stage_ms.items()) + f"; sum {stage_total:.3f} ms")
    print(f"[scaffold] ({smi}) decode (prefilter, three MLPs, assembly) at {n_decoded:,} anchors on camera 0: "
          f"forward {fwd_ms:.3f} ms, forward + backward {fwd_bwd_ms:.3f} ms (CUDA events, 20 runs)")
    print(f"[scaffold] ({smi}) checkpoint after the event at {SCAFFOLD_EVENTS[0]} resumed in a fresh trainer for "
          f"{SCAFFOLD_RESUME} steps: equal to the uninterrupted run bit for bit ({len(got)} leaves)")

    # The scaffold CLIs on the card, each in its own process. The eval is
    # uncorrected, as the scaffold trainer's validate() scores.
    with tempfile.TemporaryDirectory() as out:
        common = [f"root_dir={out}", f"trainer.max_iterations={CLI_STEPS}", "trainer.n_tensorboard=10"]
        log, train_s = h.run_cli("dogs_tpu_torch.train", *common, config=SCAFFOLD_CONFIG)
        final = re.search(r"final val: \{'val_psnr': ([-+0-9.eE]+)\}", log)
        check(final is not None, "scaffold train CLI: no final validation logged")
        train_val = float(final.group(1))
        log, resume_s = h.run_cli("dogs_tpu_torch.train", *common, "trainer.resume=true", config=SCAFFOLD_CONFIG)
        check(f"resumed from step {CLI_STEPS}" in log and "nothing to do" in log,
              "scaffold train CLI resume: did not resume to 'nothing to do'")
        log, eval_s = h.run_cli("dogs_tpu_torch.eval", *common, f"eval.n_test_poses={CLI_POSES}",
                                "eval.color_correct=false", config=SCAFFOLD_CONFIG)
        run = os.path.join(out, "scaffold_gs_novel_view_synthesis_synthetic_toy")
        with open(os.path.join(run, "eval", "val", "metrics.json")) as f:
            cli_mean = json.load(f)["mean"]
        check(abs(cli_mean["psnr"] - train_val) <= 1e-4,
              f"scaffold eval CLI val PSNR {cli_mean['psnr']} vs the train CLI's final validate() {train_val}")
        frames = sorted(f for f in os.listdir(os.path.join(run, "eval", "test")) if f.endswith(".png"))
        check(len(frames) == CLI_POSES, f"scaffold eval CLI: {len(frames)} trajectory frames")
        pngs = [os.path.join(run, "eval", "val", f) for f in ("00000.png", "00000_gt.png")]
        for path in pngs + [os.path.join(run, "eval", "test", f) for f in frames]:
            check(png.png_size(path) == (96, 80), f"{path}: not a 96x80 PNG")
        n_points = cli_mean["num_points"]
        splat = os.path.getsize(os.path.join(run, "export", "model.splat"))
        check(n_points > 0 and splat == 32 * n_points, f"scaffold eval CLI: .splat {splat} bytes for {n_points}")
        check(load_gaussian_ply(os.path.join(run, "export", "model.ply"), dev).capacity == n_points,
              "scaffold eval CLI: the .ply does not read back the exported rows")
    print(f"[scaffold] ({smi}) CLIs on {SCAFFOLD_CONFIG}: train {CLI_STEPS} steps {train_s:.1f} s (final val psnr "
          f"{train_val:.6f}), resume {resume_s:.1f} s (nothing to do), eval {eval_s:.1f} s: val psnr "
          f"{cli_mean['psnr']:.6f} ssim {cli_mean['ssim']:.5f}, {n_points} decoded Gaussians exported (.splat "
          f"{splat} B, the .ply read back), {len(frames)} trajectory frames")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing was run", file=sys.stderr)
        return 1

    from dogs_tpu_torch import bench, factory, kernels, train_admm
    from dogs_tpu_torch.core import look_at_camera, params_from_numpy
    from dogs_tpu_torch.core.gaussians import PARAM_NAMES, GaussianParams
    from dogs_tpu_torch.data import colmap, native, synthetic
    from dogs_tpu_torch.data import dataset as tdataset
    from dogs_tpu_torch.eval.evaluator import EvalConfig, GaussianSplatEvaluator
    from dogs_tpu_torch.fields import appearance, lightgaussian
    from dogs_tpu_torch.fields.io import load_gaussian_ply, load_ksplat
    from dogs_tpu_torch.fields.model import GaussianModelState
    from dogs_tpu_torch.parallel import admm as admm_mod
    from dogs_tpu_torch.parallel import master as master_mod
    from dogs_tpu_torch.raster import blend, reduce
    from dogs_tpu_torch.raster.binning import build_tile_bins
    from dogs_tpu_torch.raster.projection import project_gaussians
    from dogs_tpu_torch.raster.ssim import ssim
    from dogs_tpu_torch.raster.tiled import RasterConfig, entry_matrix, render_tiled
    from dogs_tpu_torch.train import schedule
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
    # bench.py --densify's run as dogs_tpu_torch.bench builds it: 500k points
    # of the bench scene (colours 0.5) fitting renders of a second bench scene
    # (seed 7) at SH 0, densify every 25 steps from step 1, capacity grown as
    # the trainer's protocol says.
    dense_gts = bench.teacher_gts(n, cams, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    dloop = bench.densify_trainer(cams, dense_gts, bench.densify_config(DENSIFY_EVERY), n, dev)
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
        # The .ply export to .ksplat through the converter's CLI, read back.
        ply_path = os.path.join(run, "export", "model.ply")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "dogs_tpu_torch.tools.create_ksplat", ply_path], cwd=root,
                              capture_output=True, text=True, timeout=600)
        ksplat_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"create_ksplat exited {proc.returncode}: {proc.stderr[-2000:]}")
        ksplat_bytes = os.path.getsize(ply_path[:-4] + ".ksplat")
        ks = load_ksplat(ply_path[:-4] + ".ksplat")
        ply_xyz = load_gaussian_ply(ply_path, "cpu").xyz.detach().numpy()
        # Centres are stored as uint16 offsets of 2.5 / 32767 units within their bucket.
        ks_err = max(float(np.abs(np.sort(ks["xyz"][:, k]) - np.sort(ply_xyz[:, k])).max()) for k in range(3))
        check(ks["xyz"].shape == (n_alive_cli, 3) and ks_err <= 2.5 / 32767 and np.isfinite(ks["quat"]).all(),
              f"create_ksplat: {ks['xyz'].shape[0]} splats for {n_alive_cli} Gaussians, centre error {ks_err:.3e}")
    print(f"[cli] ({smi}) train CLI {CLI_STEPS} steps {train_s:.1f} s (final val psnr {train_val:.4f}), resume "
          f"{resume_s:.1f} s (nothing to do), eval CLI {eval_s:.1f} s: val psnr {cli_mean['psnr']:.4f} ssim "
          f"{cli_mean['ssim']:.5f} lpips_uncalibrated {cli_mean['lpips_uncalibrated']:.5f}, {n_alive_cli} "
          f"Gaussians exported, {len(frames)} trajectory frames, GIF {'written' if gif else 'skipped (no imageio)'}; "
          f"python -m dogs_tpu_torch.tools.create_ksplat on model.ply {ksplat_s:.1f} s: {ksplat_bytes:,} bytes, "
          f"read back by load_ksplat, centres within {ks_err:.2e}")

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
        colmap_records: list[logging.LogRecord] = []
        colmap_catcher = logging.Handler(logging.INFO)
        colmap_catcher.emit = colmap_records.append
        colmap_log = logging.getLogger(colmap.__name__)
        colmap_level = colmap_log.level
        colmap_log.addHandler(colmap_catcher)
        colmap_log.setLevel(logging.INFO)
        try:
            t0 = time.perf_counter()
            colmap_model = colmap.load_model(os.path.join(scene_root, "sparse", "0"))
            colmap_s = time.perf_counter() - t0
        finally:
            colmap_log.removeHandler(colmap_catcher)
            colmap_log.setLevel(colmap_level)
        parsers = [r.getMessage() for r in colmap_records]
        check(native.load() is not None and len(parsers) == 2 and all("native parser" in m for m in parsers),
              f"real scene: the COLMAP model was not read by the native parser: {parsers}")
        native_s, numpy_s, n_native = native_parser_times(os.path.join(tmp, "points3D_tracks.bin"))
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
        scene_args = [f"dataset.root_dir={os.path.join(tmp, 'data')}", "dataset.factor=2",
                      "appearance.use_trained_exposure=true", "optimizer.lr.pose=1e-4",
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
        # size (96x80) at the test bars, and at the step's shapes, on fixed
        # inputs (the trained weights, a seeded input image, the cotangent
        # of seed 5), against a CPU f64 reference taken on the card's own
        # ReLU branch: a pre-activation within f32 rounding of 0 takes the
        # other branch in f64 and moves a gradient by ~1e-2 of its leaf's
        # max in any f32 run, card or CPU alike (on the same branch f32 is
        # within ~1e-5), so a bar against the plain f64 gradients compares
        # how many such ties two runs hit.
        h_mask, w_mask = strainer.cameras[0].height, strainer.cameras[0].width
        mask_in = torch.rand((h_mask, w_mask, 3), generator=torch.Generator().manual_seed(MASK_INPUT_SEED))
        cudnn = torch.backends.cudnn
        convs = {
            "exact": appearance.exact_f32,
            "cudnn": lambda: cudnn.flags(enabled=True, benchmark=False, deterministic=False, allow_tf32=False),
            "cudnn_tf32": lambda: cudnn.flags(enabled=True, benchmark=False, deterministic=False, allow_tf32=True),
        }

        def mask_fwd_bwd(mask_params, x, cot, conv="exact", branch=None, replay=False):
            """The mask and the gradients of sum(mask * cot). `branch`: a
            list that records the sign pattern of every ReLU input, or with
            `replay` supplies the patterns in order in place of the ReLUs."""
            leaves = list(appearance.flatten(mask_params).values()) + [x]
            relu = torch.relu
            if branch is not None and replay:
                patterns = iter(branch)
                torch.relu = lambda z: z * next(patterns).to(z.device, z.dtype)
            elif branch is not None:
                torch.relu = lambda z: branch.append((z > 0).cpu()) or relu(z)
            try:
                with convs[conv]():
                    mask = appearance.apply_appearance(mask_params, x, 1)
                    return [mask.detach()] + list(torch.autograd.grad((mask * cot).sum(), leaves))
            finally:
                torch.relu = relu

        def mask_on(device, dtype, x, cot, mask_params=None):
            """(the mask's parameters (the trained ones by default), x, cot)
            as `dtype` leaves on `device`."""
            p = {k: {kk: torch.as_tensor(vv).detach().to(device, dtype).requires_grad_(True) for kk, vv in v.items()}
                 if isinstance(v, dict) else torch.as_tensor(v).detach().to(device, dtype).requires_grad_(True)
                 for k, v in (mask_params or ts.mask_params).items()}
            return p, x.detach().to(device, dtype).requires_grad_(True), cot.to(device, dtype)

        leaf_names = list(appearance.flatten(ts.mask_params)) + ["input"]

        def scaled_err(got, want):
            """Worst per-leaf max |d| over the leaf's max, forward apart, and
            that leaf's name."""
            errs = [float((a.cpu().double() - b.double()).abs().max() / (b.double().abs().max() + 1e-30))
                    for a, b in zip(got, want)]
            worst = int(np.argmax(errs[1:]))
            return errs[0], errs[1 + worst], leaf_names[worst]

        g_cot = torch.Generator().manual_seed(5)
        cot = torch.randn(mask_in.shape, generator=g_cot)
        card_args = mask_on(dev, torch.float32, mask_in, cot)
        cnn_ms = {c: cuda_ms(lambda c=c: mask_fwd_bwd(*card_args, conv=c), 10) for c in convs}
        card_branch: list = []
        card = {c: mask_fwd_bwd(*card_args, conv=c, branch=card_branch if c == "exact" else None) for c in convs}
        t0 = time.perf_counter()
        want64 = mask_fwd_bwd(*mask_on("cpu", torch.float64, mask_in, cot))
        on_branch64 = mask_fwd_bwd(*mask_on("cpu", torch.float64, mask_in, cot), branch=card_branch, replay=True)
        cpu32 = mask_fwd_bwd(*mask_on("cpu", torch.float32, mask_in, cot))
        cnn_cpu_s = time.perf_counter() - t0
        n_relu = sum(b.numel() for b in card_branch)
        fwd_err = scaled_err(card["exact"], cpu32)[0]
        f32_err = scaled_err(cpu32, want64)[1:]
        grad_errs = {c: scaled_err(out, want64)[1:] for c, out in card.items()}
        branch_err = scaled_err(card["exact"], on_branch64)[1:]
        check(fwd_err <= 1e-5, f"real scene: mask CNN forward, card vs CPU, {fwd_err:.3e} of the max > 1e-5")
        check(branch_err[0] <= GRAD_ATOL,
              f"real scene: mask CNN gradients on the card {branch_err[0]:.3e} of the leaf max ({branch_err[1]}) from "
              f"the CPU f64 ones on the card's ReLU branch > {GRAD_ATOL}")
        # The CUDA lane's case: the initial weights, inputs from seed 0.
        init = appearance.init_appearance_arrays(4)
        g0 = torch.Generator().manual_seed(0)
        small, small_cot = torch.rand((80, 96, 3), generator=g0), torch.randn((80, 96, 3), generator=g0)
        small_cpu = mask_fwd_bwd(*mask_on("cpu", torch.float32, small, small_cot, init))
        small_fwd, small_grad, _ = scaled_err(mask_fwd_bwd(*mask_on(dev, torch.float32, small, small_cot, init)),
                                              small_cpu)
        check(small_fwd <= 1e-5 and small_grad <= GRAD_ATOL,
              f"real scene: mask CNN at 96x80, card vs CPU: forward {small_fwd:.3e}, gradients {small_grad:.3e}")
        small_cudnn = scaled_err(mask_fwd_bwd(*mask_on(dev, torch.float32, small, small_cot, init), conv="cudnn"),
                                 small_cpu)[1]
        del card, card_args, want64, on_branch64, card_branch, cpu32, mask_in, cot

        path = strainer.save_checkpoint(smanager)
        reloaded, _ = load_train_state(path, ts)
        a, b = train_state_arrays(ts), train_state_arrays(reloaded)
        check(list(a) == list(b) and all(np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype for k in a),
              "real scene: the checkpoint does not reload bit for bit")
        n_mask_leaves = sum(k.startswith(".mask_params/") for k in a)
        del reloaded, a, b
        # The eval CLI routes the block-parallel config to a fused block
        # checkpoint unless told this one is a single device's (as eval.py).
        log, scene_eval_s = run_cli("dogs_tpu_torch.eval", "--scene", SCENE_NAME, *scene_args,
                                    "dataset.multi_blocks=false", "eval.n_test_poses=2", config=SCENE_CONFIG)
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

        # ---- 6g. block-parallel ADMM (main path 9): four blocks of the scene --
        # urban3d_admm.yaml's 2x2 blocks on the same written scene (its
        # minify and undistort caches): the preprocess CLI, then
        # train_admm.train_scene in this process, each master step timed,
        # the consensus rounds and the fusion between CUDA events; at the
        # fusion, block 0's kernels and step gradients against plain at the
        # first ADMM step's inputs and a host copy of the post-fusion state
        # for the rho check after the run (both outside the counts).
        admm_args = [f"dataset.root_dir={os.path.join(tmp, 'data')}", "dataset.factor=2",
                     f"root_dir={os.path.join(tmp, 'out')}", "trainer.enable_tensorboard=false", *ADMM_CUTS]
        log, preprocess_s = run_cli("dogs_tpu_torch.preprocess", "--scene", SCENE_NAME, *admm_args,
                                    config=SCENE_CONFIG)
        block_sizes = [tuple(int(v) for v in m) for m in re.findall(r"block (\d+): (\d+) cameras, (\d+) points", log)]
        check(len(block_sizes) == 4 and all(c > 0 for _, c, _ in block_sizes)
              and sum(c for _, c, _ in block_sizes) == SCENE_IMAGES - 1,
              f"admm: the preprocess CLI wrote blocks {block_sizes}, expected 4 with all 16 train cameras")
        aconfig = load_config(os.path.join(root, SCENE_CONFIG), cli_overrides=admm_args)
        aconfig.dataset.scene = SCENE_NAME
        aconfig.expname = train_admm.experiment_name(aconfig, SCENE_NAME)

        def tree_to(obj, device):
            """A copy of a block state's tensors on `device` (leaves keep
            requires_grad)."""
            if torch.is_tensor(obj):
                return obj.detach().to(device, copy=True).requires_grad_(obj.requires_grad)
            if isinstance(obj, dict):
                return {k: tree_to(v, device) for k, v in obj.items()}
            if isinstance(obj, list):
                return [tree_to(v, device) for v in obj]
            if isinstance(obj, GaussianParams):
                return GaussianParams(**{k: tree_to(getattr(obj, k), device).detach() for k in PARAM_NAMES})
            if dataclasses.is_dataclass(obj):
                return dataclasses.replace(obj, **{f.name: tree_to(getattr(obj, f.name), device)
                                                   for f in dataclasses.fields(obj)})
            return obj

        MT = master_mod.MasterTrainer
        originals_6g = (MT.train_step, MT.consensus, MT.fuse_and_enable_admm, MT._densify_blocks)
        alog: dict = dict(steps=[], rounds=[], events=[])
        records_6g: list[logging.LogRecord] = []
        catcher_6g = logging.Handler(logging.INFO)
        catcher_6g.emit = records_6g.append
        master_log = logging.getLogger(master_mod.__name__)
        level_6g = master_log.level

        def admm_step(self):
            alog["master"] = self
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = originals_6g[0](self)
            torch.cuda.synchronize()
            alog["steps"].append((self.step, self.admm_enabled, (time.perf_counter() - t0) * 1e3,
                                  [torch.stack([m["loss"], m["l1"]]) for m in out]))
            return out

        def admm_consensus(self):
            rho_before, e0 = dict(self.rho), event_mark()
            primal, dual = originals_6g[1](self)
            alog["rounds"].append(dict(step=self.step, rho_before=rho_before, primal=primal, dual=dual,
                                       rho_after=dict(self.rho), events=(e0, event_mark())))
            return primal, dual

        def admm_fusion(self):
            first, block_capacity = len(records_6g), self.blocks[0].train.model.capacity
            torch.cuda.synchronize()
            t0, e0 = time.perf_counter(), event_mark()
            originals_6g[2](self)
            e1 = event_mark()
            torch.cuda.synchronize()
            fusion = dict(s=time.perf_counter() - t0, events=(e0, e1), step=self.step, n_global=self.n_global,
                          block_capacity=block_capacity,
                          msgs=[r.getMessage() for r in records_6g[first:]],
                          capacity=self.blocks[0].train.model.capacity,
                          sizes=[int(b.train.model.num_alive) for b in self.blocks])
            order = self._cam_order[0]
            if not order:  # the permutation block 0 draws next
                peek = np.random.RandomState()
                peek.set_state(self.rng.get_state())
                order = [int(i) for i in peek.permutation(len(self.block_cameras[0]))]
            blk = self.blocks[0]
            fusion["peak_before"] = path_parity(
                f"block 0 at the first ADMM step's inputs (step {self.step + 1})", blk.train.model,
                self.block_cameras[0][order[-1]], self._gt(0, order[-1]), self.active_sh_degree(self.step + 1),
                rcfg=self.raster_cfg, tag="admm")
            fusion["snapshot"] = (tree_to(self.blocks, "cpu"), copy.deepcopy(self.rng),
                                  [list(o) for o in self._cam_order], dict(self.rho))
            alog["fusion"] = fusion

        def admm_densify(self):
            originals_6g[3](self)
            alog["events"].append((self.step, list(self._last_overflow)))

        MT.train_step, MT.consensus, MT.fuse_and_enable_admm, MT._densify_blocks = (
            admm_step, admm_consensus, admm_fusion, admm_densify)
        master_log.addHandler(catcher_6g)
        master_log.setLevel(logging.INFO)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        try:
            t0 = time.perf_counter()
            admm_val = train_admm.train_scene(aconfig, SCENE_NAME)
            torch.cuda.synchronize()
            admm_s = time.perf_counter() - t0
            admm_counts = add_counts("admm", list(counted))
            admm_peak_mb = max(torch.cuda.max_memory_allocated(dev), alog["fusion"]["peak_before"]) / 2**20
        finally:
            MT.train_step, MT.consensus, MT.fuse_and_enable_admm, MT._densify_blocks = originals_6g
            master_log.removeHandler(catcher_6g)
            master_log.setLevel(level_6g)
        am, fusion, rounds = alog["master"], alog["fusion"], alog["rounds"]
        n_block_cams = sum(len(c) for c in am.block_cameras)
        steps_expected = 4 * ADMM_STEPS + 2 * n_block_cams  # block steps, the two prunes' importance renders
        check(admm_counts == {"blend_forward": steps_expected + 1, "blend_backward": steps_expected,
                              "sorted_segment_sum": steps_expected},
              f"admm: launches {admm_counts}, expected {steps_expected} (+1 K1 for the val camera)")
        check([s for s, *_ in alog["steps"]] == list(range(1, ADMM_STEPS + 1)), "admm: master steps out of order")
        check(fusion["step"] == 30 and [r["step"] for r in rounds] == [40, 50, 60] and am.admm_enabled,
              f"admm: fusion at {fusion['step']}, rounds at {[r['step'] for r in rounds]}")
        block_losses = torch.stack([torch.stack([v.to(dev) for v in ls]) for *_, ls in alog["steps"]]).cpu()
        check(bool(torch.isfinite(block_losses).all()), "admm: non-finite block loss")
        # Within each phase: the fusion restarts every block from the cropped,
        # pruned fused model with a fresh mask CNN. In the ADMM phase the loss
        # carries the penalty, which jumps after each round as u moves by
        # 1.5 (x - z), so there the photometric term (l1) is held to falling.
        half = fusion["step"]
        phase_losses = [(block_losses[:8, :, 0].mean(0).tolist(), block_losses[half - 8:half, :, 0].mean(0).tolist()),
                        (block_losses[half:half + 8, :, 1].mean(0).tolist(), block_losses[-8:, :, 1].mean(0).tolist())]
        admm_loss = (block_losses[half:half + 8, :, 0].mean(0).tolist(), block_losses[-8:, :, 0].mean(0).tolist())
        for name, (first, last) in zip(("block phase loss", "ADMM phase l1"), phase_losses):
            check(all(b < a for a, b in zip(first, last)),
                  f"admm: {name} did not fall in every block: first 8 means {first}, last 8 {last}")
        inphase = re.search(r"lightgaussian prune @20 \(blocks\): (\d+) -> (\d+)",
                            "\n".join(r.getMessage() for r in records_6g))
        check(inphase is not None, "admm: no in-phase prune at step 20")
        overflows = [int(v) for _, ovs in alog["events"] for v in ovs]
        logged = sum("densify overflow" in r.getMessage() for r in records_6g)
        check([s for s, _ in alog["events"]] == [10, 20] and logged == sum(v > 0 for v in overflows),
              f"admm: events {[s for s, _ in alog['events']]}, {sum(v > 0 for v in overflows)} overflows, "
              f"{logged} logged")
        crop_lines = re.findall(r"fusion crop block \d+: (\d+) alive -> (\d+) inside", "\n".join(fusion["msgs"]))
        alive_before, crops = [int(a) for a, _ in crop_lines], [int(b) for _, b in crop_lines]
        merged = re.search(r"post-merge prune: (\d+) -> (\d+) gaussians", "\n".join(fusion["msgs"]))
        check(len(crops) == 4 and merged is not None and int(merged.group(1)) == sum(crops)
              and int(merged.group(2)) == fusion["n_global"],
              f"admm: fused {fusion['n_global']} from crops {crops} and the prune {merged and merged.groups()}")
        for r in rounds:
            check(all(np.isfinite(float(r[w][k])) for w in ("primal", "dual") for k in PARAM_NAMES),
                  f"admm: non-finite residuals at step {r['step']}")
            want = admm_mod.adapt_rho(r["rho_before"], r["primal"], r["dual"], am.admm_cfg)
            check(all(np.float32(r["rho_after"][k]).view(np.uint32) == np.float32(want[k]).view(np.uint32)
                      for k in PARAM_NAMES), f"admm: rho at step {r['step']} is not adapt_rho's")
        check(np.isfinite(admm_val["val_psnr"]), f"admm: final validate {admm_val}")

        # The final checkpoint: resumed in a fresh trainer bit for bit, and
        # fused by load_fused_from_checkpoint equal to the global model.
        run_dir = os.path.join(tmp, "out", aconfig.expname)
        ckpt = CheckpointManager(os.path.join(run_dir, "model")).latest_path()
        ckpt_mb = os.path.getsize(ckpt) / 2**20
        saved_counts = {fn: fn.launches for fn in counted}
        t0 = time.perf_counter()
        resumed = master_mod.MasterTrainer.from_manifests(
            scene_root, 2, 2, trainer_cfg=factory._trainer_config(aconfig),
            raster_cfg=factory._raster_config(aconfig), admm_cfg=train_admm.admm_config(aconfig),
            seed=int(aconfig.get("seed", 42)), device="cuda")
        check(resumed.load_checkpoint(CheckpointManager(os.path.join(run_dir, "model"))) == ADMM_STEPS,
              "admm: the checkpoint did not resume at the last step")
        resume_s = time.perf_counter() - t0
        a, b = am.state_arrays(), resumed.state_arrays()
        check(sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype for k in a)
              and resumed.rho == am.rho and resumed._cam_order == am._cam_order and resumed.n_global == am.n_global,
              "admm: the resumed trainer differs from the run")
        n_ckpt_leaves = len(a)
        resumed.close()
        del resumed, a, b
        t0 = time.perf_counter()
        fused_ckpt = master_mod.load_fused_from_checkpoint(ckpt, am.partition, dev)
        fuse_ckpt_s = time.perf_counter() - t0
        gm = am.global_model()
        check(torch.equal(fused_ckpt.alive, gm.alive) and all(
            torch.equal(getattr(fused_ckpt.params, k), getattr(gm.params, k)) for k in PARAM_NAMES),
            "admm: load_fused_from_checkpoint differs from the global model")
        n_fused_final = int(gm.num_alive)
        del fused_ckpt, gm
        log, admm_eval_s = run_cli("dogs_tpu_torch.eval", "--scene", SCENE_NAME, *admm_args, config=SCENE_CONFIG)
        with open(os.path.join(run_dir, "eval", "val", "metrics.json")) as f:
            admm_eval = json.load(f)["mean"]
        check(abs(admm_eval["psnr"] - admm_val["val_psnr"]) <= 1e-4,
              f"admm: eval CLI val PSNR {admm_eval['psnr']} vs the final validate() {admm_val['val_psnr']}")

        # rho pulls the blocks together: from the post-fusion state, RHO_STEPS
        # master steps at rho x RHO_SCALE against rho = 0 (outside the counts).
        blocks0, rng0, order0, rho0 = fusion["snapshot"]

        def primal_after(scale: float) -> float:
            am.blocks, am.rng, am._cam_order = tree_to(blocks0, dev), copy.deepcopy(rng0), [list(o) for o in order0]
            am.step = fusion["step"]
            am.set_rho({k: np.float32(v * scale) for k, v in rho0.items()})
            for _ in range(RHO_STEPS):
                am.train_step()
            return float(admm_mod.consensus_round(am.blocks, am.n_global, am._rho_dev[0], am.admm_cfg)[4]["xyz"])

        rho_tied, rho_free = primal_after(RHO_SCALE), primal_after(0.0)
        for fn, c in saved_counts.items():
            fn.launches = c
        check(rho_tied < rho_free, f"admm: primal xyz at rho x {RHO_SCALE} {rho_tied:.4e} not below rho = 0's "
              f"{rho_free:.4e}")
        phase_ms = {on: [ms for _, admm_on, ms, _ in alog["steps"] if admm_on == on] for on in (False, True)}
        admm_frame = f"{am.block_cameras[0][0].width}x{am.block_cameras[0][0].height}"
        round_ms = [r["events"][0].elapsed_time(r["events"][1]) for r in rounds]
        fusion_ms = fusion["events"][0].elapsed_time(fusion["events"][1])
        del am, blocks0, alog, fusion["snapshot"]

        # ---- 6i. coarse-to-fine and the profiler (main paths 12 and 13) -----
        # urban3d_admm.yaml on one device as 6f runs it, with
        # geometry.coarse-to-fine on and densify_end_iter C2F_STEPS (so
        # c2f_interval C2F_INTERVAL: factors 4, 2, 1 of 1152x864) for
        # C2F_STEPS steps through GaussianSplatTrainer.train with the
        # profiler over the steps C2F_PROFILE, across the 4 -> 2 switch; each
        # step timed between synchronizes. At the inputs of the steps
        # C2F_PARITY_STEPS (kept on the card, held after the run, outside the
        # counts and the trace) each kernel and the step's gradients against
        # plain. A checkpoint after step C2F_CKPT resumed in a fresh trainer
        # to step C2F_RESUME_TO, across the 2 -> 1 switch, bit for bit. Then
        # 6g's blocks through train_admm.train_scene with coarse-to-fine:
        # C2F_ADMM_STEPS master steps of the block phase, the fusion after
        # them.
        c2f_args = ("geometry.coarse-to-fine=true", f"geometry.densify_end_iter={C2F_STEPS}",
                    f"trainer.profile.start_step={C2F_PROFILE[0]}",
                    f"trainer.profile.num_steps={C2F_PROFILE[1] - C2F_PROFILE[0] + 1}",
                    f"trainer.profile.dir={os.path.join(tmp, 'profile')}")
        ctrainer, cmanager, _ = scene_trainer(*c2f_args)
        ccfg = ctrainer.cfg
        factors = [ctrainer.training_resolution(s) for s in range(1, C2F_STEPS + 1)]
        check(ccfg.coarse_to_fine and ccfg.use_appearance_mask and ccfg.use_trained_exposure
              and ccfg.optimize_camera_poses and schedule.c2f_interval(ccfg) == C2F_INTERVAL
              and factors == [4] * (C2F_INTERVAL - 1) + [2] * C2F_INTERVAL + [1] * (C2F_INTERVAL + 1),
              f"c2f: the config does not train 4 -> 2 -> 1 with every term on: {factors}")

        def peek_camera(rng, order: list, n_cams: int) -> int:
            """The camera index the next draw returns, drawing nothing."""
            if order:
                return int(order[-1])
            peek = np.random.RandomState()
            peek.set_state(rng.get_state())
            return int(peek.permutation(n_cams)[-1])

        c2f_log: dict = dict(steps=[], inputs={})
        c2f_iteration = ctrainer.train_iteration

        def c2f_step(step):
            res = ctrainer.training_resolution(step)
            i = peek_camera(ctrainer.rng, ctrainer._order, len(ctrainer.cameras))
            first_use = (i, res) not in ctrainer._gt_cache  # its GT is resized on the host in this step
            if step in C2F_PARITY_STEPS:
                cam = ctrainer.cameras[i]
                c2f_log["inputs"][step] = (tree_to(ctrainer.state.model, dev), cam.downsample(res) if res > 1 else cam,
                                           ctrainer._gt_on_device(i, res), ctrainer.active_sh_degree(step))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = c2f_iteration(step)
            torch.cuda.synchronize()
            c2f_log["steps"].append((step, res, (time.perf_counter() - t0) * 1e3, m["loss"], first_use))
            if step == C2F_CKPT:
                c2f_log["ckpt"] = ctrainer.save_checkpoint(cmanager)
            if step == C2F_RESUME_TO:
                c2f_log["resume_to"] = train_state_arrays(ctrainer.state)
            return m

        ctrainer.train_iteration = c2f_step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        t0 = time.perf_counter()
        ctrainer.train(num_iterations=C2F_STEPS, log_every=0)
        c2f_s = time.perf_counter() - t0
        c2f_peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20
        for name, launches in add_counts("c2f", list(counted)).items():
            check(launches == C2F_STEPS, f"c2f: {name} launched {launches} times, expected one per step")
        check([s for s, *_ in c2f_log["steps"]] == list(range(1, C2F_STEPS + 1)), "c2f: steps out of order")
        c2f_losses = torch.stack([st[3] for st in c2f_log["steps"]]).tolist()
        check(all(np.isfinite(c2f_losses)), "c2f: non-finite loss")
        c2f_by_factor = {}
        for f in (4, 2, 1):
            ls = [loss for st, loss in zip(c2f_log["steps"], c2f_losses) if st[1] == f]
            untraced = [st for st in c2f_log["steps"] if st[1] == f and not C2F_PROFILE[0] <= st[0] <= C2F_PROFILE[1]]
            ms_first = [st[2] for st in untraced if st[4]]
            ms_cached = [st[2] for st in untraced if not st[4]]
            c2f_by_factor[f] = (float(np.mean(ls[:5])), float(np.mean(ls[-5:])), float(np.median(ms_first)),
                                len(ls), float(np.median(ms_cached)) if ms_cached else float("nan"), len(ms_first))
            check(c2f_by_factor[f][1] < c2f_by_factor[f][0],
                  f"c2f: loss did not fall at factor {f}: first 5 mean {c2f_by_factor[f][0]}, last 5 "
                  f"{c2f_by_factor[f][1]}")
        # The host resize of one image (1152x864 f32) to each coarse frame.
        img0 = np.asarray(ctrainer.images[0], np.float32)
        resize_ms = {}
        for f in (4, 2):
            cam = ctrainer.cameras[0].downsample(f)
            runs = []
            for _ in range(3):
                t0 = time.perf_counter()
                tdataset.resize_image(img0, cam.width, cam.height)
                runs.append((time.perf_counter() - t0) * 1e3)
            resize_ms[f] = float(np.median(runs))
        cache_res = sorted({res for _, res in ctrainer._gt_cache}, reverse=True)
        check(cache_res == [4, 2, 1], f"c2f: the GT cache holds factors {cache_res}")
        frame_of = {res: (ctrainer.cameras[0].downsample(res).width, ctrainer.cameras[0].downsample(res).height)
                    for res in (4, 2, 1)}
        check(frame_of[4][1] % 16 and frame_of == {4: (288, 216), 2: (576, 432), 1: (1152, 864)},
              f"c2f: frames {frame_of}, expected a partial tile row at factor 4")

        # The profiler's trace: one Chrome trace with the three kernels once a
        # traced step and a train_step_<s> span for each of them.
        traces = [f for f in os.listdir(os.path.join(tmp, "profile")) if f.endswith(".json")]
        check(len(traces) == 1, f"c2f: profiler traces {traces}")
        with open(os.path.join(tmp, "profile", traces[0])) as f:
            events = json.load(f)["traceEvents"]
        traced_steps = list(range(C2F_PROFILE[0], C2F_PROFILE[1] + 1))
        trace_kernels = {name: sum(1 for e in events if e.get("cat") == "kernel" and f"{name}_kernel" in e.get("name", ""))
                         for name in ("blend_forward", "blend_backward", "segment_sum")}
        spans = sorted({int(e["name"][len("train_step_"):]) for e in events
                        if e.get("cat") == "user_annotation" and e.get("name", "").startswith("train_step_")})
        trace_mb = os.path.getsize(os.path.join(tmp, "profile", traces[0])) / 2**20
        check(all(c == len(traced_steps) for c in trace_kernels.values()) and spans == traced_steps,
              f"c2f: trace kernels {trace_kernels}, spans {spans}, expected {len(traced_steps)} of each")

        saved_counts = {fn: fn.launches for fn in counted}
        for step, (model, cam, gt, deg) in sorted(c2f_log["inputs"].items()):
            c2f_peak_mb = max(c2f_peak_mb, path_parity(
                f"step {step}'s inputs at factor {ctrainer.training_resolution(step)} ({cam.width}x{cam.height}, "
                f"{-(-cam.height // 16)} tile rows)", model, cam, gt, deg, rcfg=ctrainer.raster_cfg, tag="c2f") / 2**20)
        del c2f_log["inputs"]

        # Resume across the 2 -> 1 switch in a fresh trainer.
        resumed_c2f, _, _ = scene_trainer(*c2f_args)
        check(resumed_c2f.load_checkpoint(cmanager, c2f_log["ckpt"]) == C2F_CKPT, "c2f: checkpoint not at its step")
        for step in range(C2F_CKPT + 1, C2F_RESUME_TO + 1):
            resumed_c2f.train_iteration(step)
        a, b = c2f_log["resume_to"], train_state_arrays(resumed_c2f.state)
        differ = [k for k in a if not (np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype)]
        check(list(a) == list(b) and not differ, f"c2f: resumed at {C2F_CKPT} to {C2F_RESUME_TO}, leaves differ: "
              + ", ".join(f"{k} {float(np.abs(a[k].astype(np.float64) - b[k]).max()):.3e}" for k in differ[:8]))
        n_resume_leaves = len(a)
        resumed_c2f.images.close()
        ctrainer.images.close()
        del resumed_c2f, ctrainer, a, b
        for fn, c in saved_counts.items():
            fn.launches = c

        # The ADMM master with coarse-to-fine on 6g's blocks.
        c2f_admm_args = [f"dataset.root_dir={os.path.join(tmp, 'data')}", "dataset.factor=2",
                         f"root_dir={os.path.join(tmp, 'out_c2f')}", "trainer.enable_tensorboard=false",
                         f"trainer.max_iterations={C2F_ADMM_STEPS}", f"geometry.densify_end_iter={C2F_ADMM_STEPS}",
                         f"trainer.admm.consensus_interval={C2F_ADMM_STEPS // 3}", "prune.iterations=[100000]",
                         "trainer.n_validation=0", "trainer.n_checkpoint=0", "geometry.coarse-to-fine=true"]
        cconfig = load_config(os.path.join(root, SCENE_CONFIG), cli_overrides=c2f_admm_args)
        cconfig.dataset.scene = SCENE_NAME
        cconfig.expname = train_admm.experiment_name(cconfig, SCENE_NAME)
        c2f_admm: dict = dict(steps=[])

        def c2f_master_step(self):
            c2f_admm["master"] = self
            res = self.training_resolution(self.step + 1)
            if self.step == 0:
                i = peek_camera(self.rng, self._cam_order[0], len(self.block_cameras[0]))
                c2f_admm["peak_before"] = path_parity(
                    f"block 0 at master step 1's inputs (factor {res})", self.blocks[0].train.model,
                    self.block_cameras[0][i].downsample(res), self._gt(0, i, res), self.active_sh_degree(1),
                    rcfg=self.raster_cfg, tag="c2f admm")
            before = {fn: fn.launches for fn in counted}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = originals_6g[0](self)
            torch.cuda.synchronize()
            c2f_admm["steps"].append((self.step, res, (time.perf_counter() - t0) * 1e3,
                                      {fn.__name__: fn.launches - before[fn] for fn in counted},
                                      torch.stack([m["loss"].to(dev) for m in out])))
            return out

        MT.train_step = c2f_master_step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        try:
            t0 = time.perf_counter()
            c2f_admm_val = train_admm.train_scene(cconfig, SCENE_NAME)
            torch.cuda.synchronize()
            c2f_admm_s = time.perf_counter() - t0
            add_counts("c2f admm", list(counted))
            c2f_admm_peak_mb = max(torch.cuda.max_memory_allocated(dev), c2f_admm["peak_before"]) / 2**20
        finally:
            MT.train_step = originals_6g[0]
        cm = c2f_admm.pop("master")
        want_res = [schedule.training_resolution(cm.cfg, s) for s in range(1, C2F_ADMM_STEPS + 1)]
        check([s for s, *_ in c2f_admm["steps"]] == list(range(1, C2F_ADMM_STEPS + 1))
              and [r for _, r, *_ in c2f_admm["steps"]] == want_res and sorted(set(want_res)) == [1, 2, 4],
              f"c2f admm: steps {[(s, r) for s, r, *_ in c2f_admm['steps']]}")
        per_step = [d for *_, d, _ in c2f_admm["steps"]]
        check(all(d == {fn.__name__: 4 for fn in counted} for d in per_step),
              f"c2f admm: launches per master step {per_step}, expected 4 of each kernel")
        c2f_block_losses = torch.stack([ls for *_, ls in c2f_admm["steps"]]).cpu()
        check(bool(torch.isfinite(c2f_block_losses).all()) and cm.admm_enabled and np.isfinite(c2f_admm_val["val_psnr"]),
              "c2f admm: non-finite block loss or validation, or no fusion after the run")
        streamed = sorted({res for _, _, res in cm._gt_cache}, reverse=True)
        check(all(p is not None for p in cm._gt_pool) and streamed == [4, 2],
              f"c2f admm: GT at factors {streamed} streamed (resident pools "
              f"{[p is not None for p in cm._gt_pool]}); expected 4 and 2 streamed, 1 from the pools")
        c2f_admm_ms = {f: float(np.median([ms for _, r, ms, *_ in c2f_admm["steps"] if r == f])) for f in (4, 2, 1)}
        del cm, c2f_admm
    print(f"[real scene] ({smi}) wrote {SCENE_IMAGES} images of 2304x1728 (PNG) and a COLMAP model of {n:,} points "
          f"in {write_s:.2f} s; scene load: COLMAP read {colmap_s:.3f} s (native parser), minify x2 {minify_s:.2f} s, undistort "
          f"cache {undistort_s:.2f} s; create_trainer from the caches {build_s:.2f} s (no mask {nomask_build_s:.2f} s)")
    print(f"[real scene] ({smi}) read_points3d_bin of {n_native:,} points with tracks of 2-8 observations "
          f"(host CPU times): native parser {native_s:.3f} s, numpy reader {numpy_s:.3f} s")
    print(f"[real scene] ({smi}) {SCENE_STEPS} steps at 1152x864 with the mask, exposure and pose refinement: loss "
          f"{losses[0]:.5f} -> {losses[-1]:.5f}; colour-corrected val PSNR {val0:.3f} -> {val40:.3f} dB; ms/step "
          f"median {np.median(mask_ms[8:]):.2f} (first 8 median {np.median(mask_ms[:8]):.2f}); peak memory "
          f"{mask_peak_mb:.0f} MiB")
    print(f"[real scene] ({smi}) the same steps with geometry.mask=false: loss {nomask_losses[0]:.5f} -> "
          f"{nomask_losses[-1]:.5f}; ms/step median {np.median(nomask_ms[8:]):.2f} (first 8 median "
          f"{np.median(nomask_ms[:8]):.2f}); peak memory {nomask_peak_mb:.0f} MiB")
    print(f"[real scene] ({smi}) mask CNN at 1152x864, forward + backward, device ms (CUDA events, 10 runs): "
          f"{cnn_ms['exact']:.3f} in exact f32 (cuDNN off, the step's), {cnn_ms['cudnn']:.3f} through cuDNN with "
          f"TF32 off, {cnn_ms['cudnn_tf32']:.3f} with TF32 on; on fixed inputs (input seed {MASK_INPUT_SEED}, "
          f"cotangent seed 5), gradients of the exact path against the CPU's f64 on the card's ReLU branch "
          f"({n_relu:,} ReLU inputs), worst leaf {branch_err[0]:.3e} ({branch_err[1]}; bar {GRAD_ATOL}, margin "
          f"{GRAD_ATOL / max(branch_err[0], 1e-30):.0f}x); against the plain f64, worst leaf: exact "
          f"{grad_errs['exact'][0]:.2e} ({grad_errs['exact'][1]}), cuDNN {grad_errs['cudnn'][0]:.2e}, cuDNN TF32 "
          f"{grad_errs['cudnn_tf32'][0]:.2e} (CPU f32 {f32_err[0]:.2e}, {f32_err[1]}); forward card vs CPU "
          f"{fwd_err:.2e}; at 96x80 card vs CPU forward "
          f"{small_fwd:.2e}, gradients {small_grad:.2e} (through cuDNN with TF32 off {small_cudnn:.2e}; the "
          f"initial weights) (CPU "
          f"references {cnn_cpu_s:.2f} s)")
    print(f"[real scene] ({smi}) per-image errors against the truth over rows 1-{rows - 1} (mean |d|): exposure "
          f"{errors0[0]:.5f} -> {errors40[0]:.5f}, pose delta {errors0[1]:.3e} -> {errors40[1]:.3e} (step 0 -> "
          f"{SCENE_STEPS}); checkpoint with {n_mask_leaves} mask leaves reloaded bit for bit; eval CLI "
          f"{scene_eval_s:.1f} s: val psnr {scene_eval['psnr']:.6f} (final validate() {val40:.6f})")

    print(f"[admm] ({smi}) preprocess CLI {preprocess_s:.1f} s, blocks (cameras, points): "
          + ", ".join(f"{k}: ({c}, {p:,})" for k, c, p in block_sizes))
    print(f"[admm] ({smi}) train_scene {admm_s:.1f} s for {ADMM_STEPS} master steps of 4 block steps at {admm_frame}: ms "
          f"per master step median {np.median(phase_ms[False]):.2f} in the block phase (steps 1-30), "
          f"{np.median(phase_ms[True]):.2f} in the ADMM phase (31-60); per block, mean of each phase's first 8 -> "
          f"last 8 steps: " + "; ".join(f"{name} " + ", ".join(f"{a:.5f} -> {b:.5f}" for a, b in zip(*pl))
                                        for name, pl in zip(("block phase loss", "ADMM phase l1",
                                                             "ADMM phase loss with the penalty"),
                                                            phase_losses + [admm_loss]))
          + f"; peak memory {admm_peak_mb:.0f} MiB")
    print(f"[admm] ({smi}) densify at steps 10 and 20, overflow per block {overflows} ({logged} logged); in-phase "
          f"prune at 20: {int(inphase.group(1)):,} -> {int(inphase.group(2)):,} alive in all blocks; fusion at "
          f"step 30: blocks of capacity {fusion['block_capacity']:,} with {alive_before} alive, crops {crops} = "
          f"{sum(crops):,} -> post-merge prune -> {fusion['n_global']:,} global Gaussians, "
          f"blocks of {fusion['sizes']} at capacity {fusion['capacity']:,}; fusion {fusion_ms:.1f} ms between CUDA "
          f"events ({fusion['s']:.2f} s host)")
    print(f"[admm] ({smi}) consensus rounds at steps 40/50/60: "
          + "; ".join(f"{ms:.2f} ms, primal xyz {float(r['primal']['xyz']):.4e} (opacity "
                      f"{float(r['primal']['logit_opacity']):.4e}), dual xyz {float(r['dual']['xyz']):.4e}, "
                      f"rho xyz {float(r['rho_before']['xyz']):.4e} -> {float(r['rho_after']['xyz']):.4e}"
                      for ms, r in zip(round_ms, rounds)))
    print(f"[admm] ({smi}) final val psnr {admm_val['val_psnr']:.6f} ({n_fused_final:,} fused Gaussians); "
          f"checkpoint {ckpt_mb:.0f} MiB, {n_ckpt_leaves} leaves, resumed in a fresh trainer bit for bit "
          f"({resume_s:.1f} s) and fused equal to the global model ({fuse_ckpt_s:.1f} s); eval CLI "
          f"{admm_eval_s:.1f} s: val psnr {admm_eval['psnr']:.6f}; primal xyz after {RHO_STEPS} steps from the "
          f"fusion at rho x {RHO_SCALE:g} {rho_tied:.4e}, at rho = 0 {rho_free:.4e}")

    print(f"[c2f] ({smi}) {C2F_STEPS} coarse-to-fine steps of urban3d_admm.yaml with the mask, exposure and pose "
          f"terms in {c2f_s:.1f} s; per factor (frame, steps, loss first 5 -> last 5 mean, ms/step median outside "
          f"the trace over the steps that read their GT at first use (the reader's decode, and at 4 and 2 the host "
          f"resize; how many) and over the steps that find it cached): "
          + "; ".join(f"{f} ({frame_of[f][0]}x{frame_of[f][1]}, {c2f_by_factor[f][3]}, "
                      f"{c2f_by_factor[f][0]:.5f} -> {c2f_by_factor[f][1]:.5f}, {c2f_by_factor[f][2]:.2f} "
                      f"({c2f_by_factor[f][5]}) / {c2f_by_factor[f][4]:.2f})" for f in (4, 2, 1))
          + f"; resize_image of one 1152x864 image on the host: {resize_ms[4]:.2f} ms to 288x216, "
          f"{resize_ms[2]:.2f} ms to 576x432; peak memory {c2f_peak_mb:.0f} MiB; GT cache factors {cache_res}")
    print(f"[c2f] ({smi}) profiler over steps {C2F_PROFILE[0]}-{C2F_PROFILE[1]}: {traces[0]} ({trace_mb:.1f} MiB), "
          f"kernels {trace_kernels}, spans train_step_{spans}; checkpoint at {C2F_CKPT} resumed in a fresh trainer "
          f"to {C2F_RESUME_TO} bit for bit ({n_resume_leaves} leaves)")
    print(f"[c2f admm] ({smi}) train_scene {c2f_admm_s:.1f} s for {C2F_ADMM_STEPS} master steps of 4 block steps "
          f"with coarse-to-fine (c2f_interval {C2F_ADMM_STEPS // 3}), the fusion after them: ms per master step median "
          + ", ".join(f"{c2f_admm_ms[f]:.2f} at factor {f}" for f in (4, 2, 1))
          + f"; 4 launches of each kernel per master step; GT at factors {streamed} streamed, factor 1 from the "
          f"resident pools; final val psnr {c2f_admm_val['val_psnr']:.4f}; peak memory {c2f_admm_peak_mb:.0f} MiB")

    # ---- 6h. Scaffold-GS (main paths 10 and 11): anchors at full width ------
    scaffold_phase(SimpleNamespace(dev=dev, smi=smi, counted=counted, reset_counts=reset_counts,
                                   add_counts=add_counts, check_segment_sum=check_segment_sum,
                                   random_cot=random_cot, run_cli=run_cli, max_err=max_err))

    # ---- 6j. the bench's modes (main path 14) --------------------------------
    bench_phase(SimpleNamespace(dev=dev, smi=smi, counted=counted, reset_counts=reset_counts, add_counts=add_counts,
                                path_parity=path_parity))

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
