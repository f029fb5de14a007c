"""Master orchestration: block training, fusion, ADMM consensus.

Port of dogs_tpu/parallel/master.py (the reference
MasterGaussianSplatTrainer, conerf/trainers/master_gaussian_trainer.py:
201-786). dogs_tpu drives one SPMD program over a mesh; the port drives B
blocks in one process (parallel/admm.py), each an `AdmmBlockState` on its
own device, through three phases:

  phase 1 (independent): every master step each block takes one train step
    on its own cameras, then the host events run: per-block densify (both
    capacity protocols, one shared capacity), the opacity reset and the
    LightGaussian prune at prune.iterations (the slaves' train_iteration,
    gaussian_trainer.py:429-476).
  fusion (once, at densify_end_iter; master:557-618): the blocks go to the
    host, each keeps only its Gaussians inside its ORIGIN box (the
    de-overlap crop, in float32 as dogs_tpu tests it), the crops are
    concatenated, importance-pruned over every block camera
    (prune_gaussians_after_merge), and each block re-selects its Gaussians
    from the EXPANDED boxes; the state restarts from the fused parameters
    (fresh moments and per-image state, z_local = x, u = 0, rho from the
    global count).
  phase 2 (consensus): the train steps carry the scaled-dual penalty; every
    consensus_interval steps one consensus round averages the shared
    Gaussians, updates the duals and returns the residuals, and the host
    adapts rho until stop_adapt_iter (master:336-377).

With coarse-to-fine on, every block takes master step s at the factor
`schedule.training_resolution(s)`, on its downsampled camera, against GT
resized in f32 and then encoded at admm.gt_dtype, streamed through the GT
cache (the resident images serve factor 1 only), as dogs_tpu stages it.

Not carried from dogs_tpu, by design: chained dispatch (`chain_steps` is
accepted and ignored: each master step is B step calls and the host events
after it, the same event steps as dogs_tpu's event-aligned chunks), the
sharded GT pool and its staging (each block's GT images live on its own
device instead, or in an LRU cache of `TrainerConfig.gt_cache_bytes`), and
the compile buckets. The split noise of densify events comes from one
`torch.Generator` per block. Every densify event's overflow is read and
logged at the end of its `train_iteration`, so the last events of the block
phase and the one before fusion are logged too (dogs_tpu drops them,
master.py:354 and :701).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
from collections import OrderedDict
from typing import Sequence

import numpy as np
import torch

from dogs_tpu_torch.core.camera import Camera
from dogs_tpu_torch.core.gaussians import PARAM_NAMES, GaussianParams, round_up_capacity
from dogs_tpu_torch.data.blocks import BlockPartition, block_dir, load_block, points_in_bounds2d_f32
from dogs_tpu_torch.data.dataset import resize_image
from dogs_tpu_torch.data.reader import LazyImageList
from dogs_tpu_torch.eval.metrics import color_correct
from dogs_tpu_torch.fields.lightgaussian import calculate_v_imp_score, prune_gaussians, prune_list
from dogs_tpu_torch.fields.model import GaussianModelState, densify_and_prune, fresh_stats, required_slots, reset_opacity
from dogs_tpu_torch.parallel.admm import (
    SUMMED_METRICS,
    AdmmBlockState,
    AdmmConfig,
    adapt_rho,
    admm_state_from_params,
    block_metrics,
    build_admm_state,
    consensus_round,
)
from dogs_tpu_torch.raster.tiled import RasterConfig, render_tiled
from dogs_tpu_torch.train import schedule
from dogs_tpu_torch.train.checkpoint import read_checkpoint, train_state_arrays, train_state_from_arrays
from dogs_tpu_torch.train.trainer import (
    TrainerConfig,
    compute_nerf_plus_plus_norm,
    grow_capacity,
    make_train_step,
    zero_moments_at,
    zero_opacity_moments,
)

logger = logging.getLogger(__name__)


def block_devices(num_blocks: int, device: str = "cuda") -> list[torch.device]:
    """Block k's device: round robin over the CUDA devices for "cuda" (all
    blocks on one card when there is one), else `device` for every block."""
    if device == "cuda":
        n = max(torch.cuda.device_count(), 1)
        return [torch.device("cuda", k % n) for k in range(num_blocks)]
    return [torch.device(device)] * num_blocks


def _camera_to(cam: Camera, device: torch.device) -> Camera:
    """`cam` with its tensors on `device`."""
    return dataclasses.replace(cam, **{f.name: getattr(cam, f.name).to(device) for f in dataclasses.fields(cam)
                                       if torch.is_tensor(getattr(cam, f.name))})


def encode_gt(im: np.ndarray, dtype) -> np.ndarray:
    """f32 [0, 1] -> the GT storage dtype (dogs_tpu's _encode_gt: uint8
    round-trips 8-bit source images exactly)."""
    if dtype == np.uint8:
        return np.clip(np.rint(im * 255.0), 0.0, 255.0).astype(np.uint8)
    return im.astype(dtype)


def gather_block_models(blocks: Sequence[AdmmBlockState]) -> list[dict[str, np.ndarray]]:
    """Device -> host: each block's parameters and alive mask as numpy (the
    master's collect step)."""
    out = []
    for b in blocks:
        model = b.train.model
        arrays = {k: getattr(model.params, k).detach().cpu().numpy() for k in PARAM_NAMES}
        arrays["alive"] = model.alive.cpu().numpy()
        out.append(arrays)
    return out


def fused_model_state(fused: dict[str, np.ndarray], device: str = "cuda") -> GaussianModelState:
    """Fused host arrays as a GaussianModelState on `device`, padded with
    zeros to round_up_capacity(n, 1024) slots (dogs_tpu's _fused_model_state)."""
    n = fused["xyz"].shape[0]
    cap = round_up_capacity(n, 1024)
    params = {}
    for k in PARAM_NAMES:
        a = np.zeros((cap,) + fused[k].shape[1:], np.float32)
        a[:n] = fused[k]
        params[k] = torch.as_tensor(a, device=device)
    return GaussianModelState(GaussianParams(**params), torch.arange(cap, device=device) < n,
                              *fresh_stats(cap, device))


def post_merge_keep(scores: np.ndarray, prune_percent: float) -> np.ndarray | None:
    """The keep mask of the post-merge prune (master:117-123): the lowest
    int(0.4 prune_percent (n - 1)) scores go, chosen by numpy's default
    argsort as dogs_tpu chooses them (ties, such as the zero scores of
    unseen Gaussians, fall where that sort puts them). None: nothing goes."""
    n = scores.shape[0]
    k = int(0.4 * prune_percent * max(n - 1, 0))
    if k <= 0:
        return None
    keep = np.ones((n,), bool)
    keep[np.argsort(scores)[:k]] = False
    return keep


def prune_fused_gaussians(
    fused: dict[str, np.ndarray],
    cameras: Sequence[Camera],
    raster_cfg: RasterConfig,
    prune_percent: float,
    v_pow: float = 0.1,
    active_sh_degree: int = 3,
    device: str = "cuda",
) -> dict[str, np.ndarray]:
    """The post-merge importance prune (master:103-121
    prune_gaussians_after_merge): every Gaussian's blend weight over ALL
    `cameras` (one importance render each, K1-K3 on the card), scored by
    importance x volume^v_pow; `post_merge_keep` drops the lowest. Returns
    the pruned fused dict (host arrays)."""
    model = fused_model_state(fused, device)
    imp = prune_list(model, [_camera_to(c, model.alive.device) for c in cameras], raster_cfg, active_sh_degree)
    n = fused["xyz"].shape[0]
    scores = calculate_v_imp_score(model, imp, v_pow).cpu().numpy().astype(np.float32)[:n]
    keep = post_merge_keep(scores, prune_percent)
    if keep is None:
        return fused
    logger.info("post-merge prune: %d -> %d gaussians", n, int(keep.sum()))
    return {f: v[keep] for f, v in fused.items()}


def fuse_local_gaussians(
    models: Sequence[dict[str, np.ndarray]],
    partition: BlockPartition,
    prune_cameras: Sequence[Camera] | None = None,
    raster_cfg: RasterConfig | None = None,
    prune_percent: float = 0.0,
    prune_v_pow: float = 0.1,
    active_sh_degree: int = 3,
    device: str = "cuda",
) -> tuple[dict[str, np.ndarray], list[np.ndarray]]:
    """De-overlap crop + concat + global prune + re-select (master:557-618,
    helpers :37-172), on host arrays (`gather_block_models`).

    Block k keeps its alive Gaussians inside its origin box (the POINT-grid
    box when the partition has one: the reference crops by point_bboxes,
    master_gaussian_trainer.py:54-71); with `prune_cameras` the merged model
    is importance-pruned on `device` before each block re-selects from its
    expanded box, always keeping the Gaussians it owns. Both box tests run in
    float32 (`points_in_bounds2d_f32`), as dogs_tpu's do.

    Returns (global model arrays, per-block global-index lists)."""
    fused = {f: [] for f in PARAM_NAMES}
    owners = []
    for k, m in enumerate(models):
        inside = points_in_bounds2d_f32(m["xyz"], partition.crop_bounds(k), partition.transform)
        keep = m["alive"] & inside
        logger.info("fusion crop block %d: %d alive -> %d inside origin bbox",
                    k, int(m["alive"].sum()), int(keep.sum()))
        for f in PARAM_NAMES:
            fused[f].append(m[f][keep])
        owners.append(np.full(int(keep.sum()), k, np.int32))
    out = {f: np.concatenate(v, axis=0) for f, v in fused.items()}
    owner_ids = np.concatenate(owners) if owners else np.zeros((0,), np.int32)

    if prune_cameras is not None and prune_percent > 0.0:
        out["__owner__"] = owner_ids  # rides the same keep mask
        out = prune_fused_gaussians(out, prune_cameras, raster_cfg or RasterConfig(), prune_percent,
                                    prune_v_pow, active_sh_degree, device)
        owner_ids = out.pop("__owner__")

    # Re-select every block's Gaussians from the EXPANDED (overlapping) boxes:
    # the shared boundary Gaussians are what ADMM reconciles. A Gaussian stays
    # in its owner block even if the expansion rounds it out.
    block_ids = []
    for k in range(partition.num_blocks):
        in_exp = points_in_bounds2d_f32(out["xyz"], partition.select_bounds(k), partition.transform)
        in_exp |= owner_ids == k
        block_ids.append(np.nonzero(in_exp)[0].astype(np.int32))
    logger.info("fused %d gaussians; block sub-sizes %s", out["xyz"].shape[0], [len(i) for i in block_ids])
    return out, block_ids


def _noise_seed(seed: int, block: int, step: int = 0) -> int:
    """Block `block`'s split-noise seed (at `step` when a resume reseeds it)."""
    return int(np.random.SeedSequence([seed, block, step]).generate_state(1, np.uint64)[0])


class MasterTrainer:
    """Host-side phase driver for block-parallel training in one process.

    Block k trains `block_cameras[k]` against `block_images[k]` ((H, W, 3)
    arrays in [0, 1], or a `LazyImageList`) from the points
    `block_points[k]`. `device`: "cuda" places the blocks round robin on
    the CUDA devices; "cpu" runs every block on the CPU."""

    def __init__(
        self,
        partition: BlockPartition,
        block_points: list[np.ndarray],
        block_colors: list[np.ndarray],
        block_cameras: list[list[Camera]],
        block_images: list,
        trainer_cfg: TrainerConfig,
        raster_cfg: RasterConfig,
        admm_cfg: AdmmConfig = AdmmConfig(),
        spatial_lr_scale: float = 1.0,
        seed: int = 42,
        device: str = "cuda",
    ):
        empty = [k for k, cams in enumerate(block_cameras) if not cams]
        if empty:
            raise ValueError(
                f"blocks {empty} have no cameras: every block trains one camera per step; "
                "re-partition with fewer blocks or a different method"
            )
        if admm_cfg.gt_dtype not in ("uint8", "float32"):
            raise ValueError(f"admm.gt_dtype {admm_cfg.gt_dtype!r}: expected 'uint8' or 'float32'")
        self.partition = partition
        self.cfg = trainer_cfg
        self.raster_cfg = raster_cfg
        self.admm_cfg = admm_cfg
        self.spatial_lr_scale = spatial_lr_scale
        self.seed = seed
        b = partition.num_blocks
        self.devices = block_devices(b, device)
        # Cameras re-indexed to their in-block position (each slave's
        # MiniDataset indexes locally, master:839-873): image_index keys the
        # block's exposure, pose and mask rows and its GT images.
        self.block_cameras = [
            [dataclasses.replace(_camera_to(c, dev), image_index=i) for i, c in enumerate(cams)]
            for cams, dev in zip(block_cameras, self.devices)
        ]
        self.block_images = block_images
        self.rng = np.random.RandomState(seed)
        self.noise_gens = [torch.Generator(device=dev).manual_seed(_noise_seed(seed, k))
                           for k, dev in enumerate(self.devices)]
        self.admm_enabled = False
        self.step = 0

        # Before fusion every block trains its own cloud; the global ids are
        # disjoint (no consensus yet, they only reserve slots).
        sizes = [len(p) for p in block_points]
        offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
        ids = [np.arange(offsets[k], offsets[k + 1], dtype=np.int32) for k in range(b)]
        self.blocks = build_admm_state(
            np.concatenate(block_points, axis=0), np.concatenate(block_colors, axis=0), ids,
            max(len(c) for c in block_cameras), trainer_cfg, self.devices,
        )
        self.n_global = int(offsets[-1])
        self.set_rho(admm_cfg.initial_rho(self.n_global))
        self._step_fns: dict[tuple, object] = {}
        self._cam_order: list[list[int]] = [[] for _ in range(b)]
        # Densify overflow: (step, block, 0-d count) of the events since the
        # last drain, and the last event's per-block counts (the reactive
        # growth signal).
        self._pending_overflow: list[tuple[int, int, torch.Tensor]] = []
        self._last_overflow: list[torch.Tensor] | None = None
        self._gt_cache: OrderedDict[tuple[int, int, int], torch.Tensor] = OrderedDict()
        self._gt_cache_bytes = 0
        self._gt_pool = [self._resident_gt(k) for k in range(b)]

    # ---- GT images -------------------------------------------------------------
    @property
    def _gt_np_dtype(self):
        return np.uint8 if self.admm_cfg.gt_dtype == "uint8" else np.float32

    def _resident_gt(self, kb: int) -> torch.Tensor | None:
        """Block kb's GT images as one (I, H, W, 3) tensor of gt_dtype on its
        device, when admm.gt_resident is on, they share one shape and fit
        admm.gt_resident_max_bytes; else None (they stream through the GT
        cache). A LazyImageList read in full here is closed, unless
        coarse-to-fine is on: its factors above 1 stream from it."""
        images = self.block_images[kb]
        if not self.admm_cfg.gt_resident or not len(images):
            return None
        first = np.asarray(images[0], np.float32)
        nbytes = len(images) * first.size * np.dtype(self._gt_np_dtype).itemsize
        if first.ndim != 3 or first.shape[-1] != 3 or nbytes > self.admm_cfg.gt_resident_max_bytes:
            logger.info("block %d: GT images stream (%.0f MB over the resident budget or not RGB)",
                        kb, nbytes / 1e6)
            return None
        stack = np.zeros((len(images),) + first.shape, self._gt_np_dtype)
        for i in range(len(images)):
            im = first if i == 0 else np.asarray(images[i], np.float32)
            if im.shape != first.shape:
                logger.info("block %d: non-uniform image shapes; GT images stream", kb)
                return None
            stack[i] = encode_gt(im, self._gt_np_dtype)
        if isinstance(images, LazyImageList) and not self.cfg.coarse_to_fine:  # c2f reads them again
            images.close()
        logger.info("block %d: %d GT images resident at %dx%d %s (%.0f MB)", kb, len(images), first.shape[1],
                    first.shape[0], self.admm_cfg.gt_dtype, nbytes / 1e6)
        return torch.as_tensor(stack, device=self.devices[kb])

    def _gt(self, kb: int, i: int, res: int = 1) -> torch.Tensor:
        """Block kb's GT image i at coarse-to-fine factor `res` as float32 on
        its device: stored at gt_dtype and decoded x 1/255 as dogs_tpu's
        step decodes it. The resident pool serves res == 1 only; otherwise
        the image streams through the LRU cache keyed (kb, i, res), resized
        in f32 to the downsampled camera's size first and encoded second
        (dogs_tpu's _gt_stream_cached)."""
        pool = self._gt_pool[kb]
        key = (kb, i, res)
        if pool is not None and res == 1:
            enc = pool[i]
        elif key in self._gt_cache:
            enc = self._gt_cache[key]
            self._gt_cache.move_to_end(key)
        else:
            arr = np.asarray(self.block_images[kb][i], np.float32)
            if res > 1:
                cam = self.block_cameras[kb][i].downsample(res)
                arr = resize_image(arr, cam.width, cam.height)
            enc = torch.as_tensor(encode_gt(arr, self._gt_np_dtype), device=self.devices[kb])
            if self.cfg.gt_cache_bytes:
                self._gt_cache[key] = enc
                self._gt_cache_bytes += enc.nbytes
                while self._gt_cache_bytes > self.cfg.gt_cache_bytes:
                    _, old = self._gt_cache.popitem(last=False)
                    self._gt_cache_bytes -= old.nbytes
        if enc.dtype == torch.uint8:
            return enc.to(torch.float32) * (1.0 / 255.0)
        return enc

    def close(self) -> None:
        """Stop the image reader threads of streamed blocks."""
        for images in self.block_images:
            if isinstance(images, LazyImageList):
                images.close()

    # ---- the step ------------------------------------------------------------
    def set_rho(self, rho: dict[str, np.float32]) -> None:
        """Hold rho (float32 per parameter) and its 0-d copies on each device."""
        self.rho = {k: np.float32(rho[k]) for k in PARAM_NAMES}
        self._rho_dev = [{k: torch.tensor(v, dtype=torch.float32, device=dev) for k, v in self.rho.items()}
                         for dev in self.devices]

    def active_sh_degree(self, step: int) -> int:
        return schedule.active_sh_degree(self.cfg, step)

    def training_resolution(self, step: int) -> int:
        """Coarse-to-fine factor, the single-device trainer's schedule."""
        return schedule.training_resolution(self.cfg, step)

    def _step_fn(self, active_sh_degree: int):
        key = (active_sh_degree, self.admm_enabled)
        if key not in self._step_fns:
            bg = (1.0, 1.0, 1.0) if self.cfg.white_background else (0.0, 0.0, 0.0)
            self._step_fns[key] = make_train_step(self.cfg, self.raster_cfg, self.spatial_lr_scale,
                                                  active_sh_degree, bg, admm=self.admm_enabled)
        return self._step_fns[key]

    def _next_camera(self, kb: int) -> int:
        """dogs_tpu's camera order: blocks draw in order 0..B-1 each step, a
        block's permutation from the shared seeded RandomState when its list
        runs out, consumed from the end."""
        if not self._cam_order[kb]:
            self._cam_order[kb] = [int(i) for i in self.rng.permutation(len(self.block_cameras[kb]))]
            images = self.block_images[kb]
            streams = self._gt_pool[kb] is None or self.training_resolution(self.step + 1) > 1
            if streams and isinstance(images, LazyImageList):
                images.hint(list(reversed(self._cam_order[kb])))
        return self._cam_order[kb].pop()

    def train_step(self) -> list[dict]:
        """One master step: each block's train step (with the penalty in
        the ADMM phase), then the host events. Returns each block's metrics
        (0-d device tensors). Every block trains at the master step's
        coarse-to-fine factor, on its downsampled camera."""
        step_fn = self._step_fn(self.active_sh_degree(self.step + 1))
        res = self.training_resolution(self.step + 1)
        metrics = []
        for kb, blk in enumerate(self.blocks):
            i = self._next_camera(kb)
            gt = self._gt(kb, i, res)
            cam = self.block_cameras[kb][i]
            extra = (blk.u, blk.z_local, self._rho_dev[kb]) if self.admm_enabled else ()
            blk.train, m = step_fn(blk.train, cam.downsample(res) if res > 1 else cam, gt, *extra)
            metrics.append(m)
        self.step += 1
        self._host_events()
        return metrics

    def _host_events(self) -> None:
        """Post-step events of the block phase, as the slave's
        train_iteration runs them (gaussian_trainer.py:429-476): densify and
        the opacity reset before densify_end_iter, and the LightGaussian
        prune at prune.iterations in either phase."""
        s, cfg = self.step, self.cfg
        if not self.admm_enabled and cfg.densify_start_iter < s < cfg.densify_end_iter \
                and s % cfg.densification_interval == 0:
            self._densify_blocks()
        hit = cfg.opacity_reset_interval > 0 and s % cfg.opacity_reset_interval == 0
        white_kick = cfg.white_background and s == cfg.densify_start_iter
        if s < cfg.densify_end_iter and (hit or white_kick):
            self._reset_opacity_blocks()
        if s in cfg.prune_iterations:
            self._prune_blocks()

    def train_iteration(self) -> dict:
        """`consensus_interval` master steps (master:665-728), then the
        fusion when the block phase ends, or a consensus round in the ADMM
        phase. Returns the last step's block-averaged metrics (the saturation
        counters' max over the steps), with primal_<p> and dual_<p> after a
        consensus round, as floats. Every densify overflow since the last
        drain is read and logged with the metrics, before the fusion."""
        target = self.step + self.admm_cfg.consensus_interval
        sat: dict[str, torch.Tensor] = {}
        metrics: dict[str, torch.Tensor] = {}
        while self.step < target:
            metrics = block_metrics(self.train_step())
            for k in SUMMED_METRICS:
                sat[k] = metrics[k] if k not in sat else torch.maximum(sat[k], metrics[k])
        out = self._drain_overflow({**metrics, **sat})
        if int(out.get("bin_pool_truncated", 0) + out.get("bin_dropped", 0)) > 0:
            logger.warning("tile-bin saturation: pool_truncated=%d dropped=%d",
                           int(out.get("bin_pool_truncated", 0)), int(out.get("bin_dropped", 0)))
        if not self.admm_enabled and self.admm_cfg.enable and self.step >= self.cfg.densify_end_iter:
            # admm.enable=false is the reference's fusion-only mode (master:
            # 686-688): blocks train on and validate() fuses each call.
            self.fuse_and_enable_admm()
        elif self.admm_enabled:
            primal, dual = self.consensus()
            out.update({f"primal_{k}": float(v) for k, v in primal.items()})
            out.update({f"dual_{k}": float(v) for k, v in dual.items()})
        return out

    def consensus(self) -> tuple[dict[str, np.float32], dict[str, np.float32]]:
        """One consensus round; stores the new duals and z_local, adapts rho
        before stop_adapt_iter. Returns the residuals (float32, host)."""
        new_u, z_new, _, _, primal, dual = consensus_round(self.blocks, self.n_global, self._rho_dev[0],
                                                           self.admm_cfg)
        for blk, u, zl in zip(self.blocks, new_u, z_new):
            blk.u, blk.z_local = u, zl
        vals = torch.stack([primal[k] for k in PARAM_NAMES] + [dual[k] for k in PARAM_NAMES]).cpu().numpy()
        primal = dict(zip(PARAM_NAMES, vals[: len(PARAM_NAMES)]))
        dual = dict(zip(PARAM_NAMES, vals[len(PARAM_NAMES):]))
        if self.step < self.admm_cfg.stop_adapt_iter:
            self.set_rho(adapt_rho(self.rho, primal, dual, self.admm_cfg))
        return primal, dual

    def _drain_overflow(self, metrics: dict | None = None) -> dict:
        """Read `metrics` and every pending densify overflow in one transfer;
        log each event's overflow (a dropped candidate is never silent).
        Returns the metrics as floats."""
        metrics = metrics or {}
        pending, self._pending_overflow = self._pending_overflow, []
        vals = [torch.as_tensor(v, dtype=torch.float64).to(self.devices[0]) for v in metrics.values()]
        vals += [ov.to(self.devices[0], torch.float64) for _, _, ov in pending]
        fetched = torch.stack(vals).tolist() if vals else []
        for (step, kb, _), ov in zip(pending, fetched[len(metrics):]):
            if ov > 0:
                logger.warning("densify overflow at step %d, block %d: %d candidates dropped", step, kb, int(ov))
        return dict(zip(metrics, fetched))

    # ---- host events ---------------------------------------------------------
    def _reset_opacity_blocks(self) -> None:
        """The slaves' opacity reset (gaussian_trainer.py:453-456), opacity
        moments zeroed."""
        logger.info("opacity reset at step %d (all blocks)", self.step)
        for blk in self.blocks:
            reset_opacity(blk.train.model)
            zero_opacity_moments(blk.train.opt)

    def _prune_blocks(self) -> None:
        """In-phase LightGaussian prune: each block scores its Gaussians over
        its own cameras at this step's SH degree and drops the lowest
        percentile (gaussian_trainer.py:457-469)."""
        i = list(self.cfg.prune_iterations).index(self.step)
        percent = (self.cfg.prune_decay**i) * self.cfg.prune_percent
        deg = self.active_sh_degree(self.step)
        counts = []
        for kb, blk in enumerate(self.blocks):
            model = blk.train.model
            counts.append(model.num_alive.to(self.devices[0]))
            imp = prune_list(model, self.block_cameras[kb], self.raster_cfg, deg)
            prune_gaussians(model, percent, calculate_v_imp_score(model, imp, self.cfg.prune_v_pow))
            counts.append(model.num_alive.to(self.devices[0]))
        before, after = torch.stack(counts).view(-1, 2).sum(0).tolist()
        logger.info("lightgaussian prune @%d (blocks): %d -> %d gaussians", self.step, before, after)

    def _grow_blocks(self, new_capacity: int) -> None:
        """Grow every block to a shared new capacity bucket (trainer.py's
        grow_capacity per block; duals and z_local pad with zeros, slot maps
        with n_global)."""
        old = self.blocks[0].train.model.capacity
        logger.info("growing block capacity %d -> %d", old, new_capacity)
        pad = new_capacity - old
        for blk in self.blocks:
            blk.train = grow_capacity(blk.train, new_capacity)
            for tree in (blk.u, blk.z_local):
                for k, a in tree.items():
                    tree[k] = torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])
            blk.slot_map = torch.cat([blk.slot_map, blk.slot_map.new_full((pad,), self.n_global)])

    def _split_noise(self, kb: int, capacity: int) -> torch.Tensor:
        """Block kb's split draw of one densify event: (2 capacity, 3)."""
        return torch.randn((2 * capacity, 3), generator=self.noise_gens[kb], device=self.devices[kb])

    def _densify_blocks(self) -> None:
        """Per-block densify and prune into one shared capacity, grown first
        when a block would overflow (grow-first, the port's default) or after
        an event that dropped candidates (reactive_capacity_growth)."""
        cfg = self.cfg
        cap = self.blocks[0].train.model.capacity
        if cfg.reactive_capacity_growth:
            prev = self._last_overflow
            need = int(torch.stack([o.to(self.devices[0]) for o in prev]).max()) if prev else 0
            if need > 0:
                logger.info("reactive block capacity growth %d -> %d (%d dropped last event)",
                            cap, round_up_capacity(cap + need), need)
        else:
            need = int(torch.stack([
                required_slots(b.train.model, cfg.densify_grad_threshold, cfg.percent_dense,
                               self.spatial_lr_scale).to(self.devices[0])
                for b in self.blocks]).max())
        if need > 0:
            self._grow_blocks(round_up_capacity(cap + need))
        overflow = []
        for kb, blk in enumerate(self.blocks):
            _, allocated, ov = densify_and_prune(
                blk.train.model, self._split_noise(kb, blk.train.model.capacity), cfg.densify_grad_threshold,
                cfg.min_opacity, self.spatial_lr_scale, None, percent_dense=cfg.percent_dense,
            )
            zero_moments_at(blk.train.opt, allocated)
            overflow.append(ov)
            self._pending_overflow.append((self.step, kb, ov))
        self._last_overflow = overflow

    # ---- the phase boundary ------------------------------------------------------
    def fuse_and_enable_admm(self) -> None:
        """The one-time fusion (master:557-618, dogs_tpu master.py:703-758):
        fuse with the post-merge prune over every block camera, restart
        each block from its re-selected fused Gaussians (fresh moments,
        exposure, pose and mask; the train step at the master step;
        z_local = x, u = 0) and rho from the global count."""
        all_cams = [c for cams in self.block_cameras for c in cams]
        fused, block_ids = fuse_local_gaussians(
            gather_block_models(self.blocks), self.partition,
            prune_cameras=all_cams if self.cfg.prune_percent > 0 else None,
            raster_cfg=self.raster_cfg, prune_percent=self.cfg.prune_percent, prune_v_pow=self.cfg.prune_v_pow,
            active_sh_degree=self.cfg.max_sh_degree, device=self.devices[0],
        )
        self.n_global = fused["xyz"].shape[0]
        self.blocks = admm_state_from_params(fused, block_ids, max(len(c) for c in self.block_cameras), self.cfg,
                                             self.step, self.devices)
        self.set_rho(self.admm_cfg.initial_rho(self.n_global))
        self.admm_enabled = True
        self._last_overflow = None
        logger.info("ADMM enabled at step %d with %d global gaussians", self.step, self.n_global)

    # ---- checkpoint / resume -------------------------------------------------------
    def state_arrays(self) -> dict[str, np.ndarray]:
        """The blocks stacked as dogs_tpu's AdmmBlockState checkpoint holds
        them: every TrainState leaf under .train/ with a leading block axis,
        the duals under .u/, z_local under .z_local/, and .slot_map."""
        per_block = [train_state_arrays(b.train) for b in self.blocks]
        out = {f".train/{k}": np.stack([a[k] for a in per_block]) for k in per_block[0]}
        for name in ("u", "z_local"):
            for k in PARAM_NAMES:
                out[f".{name}/.{k}"] = np.stack([getattr(b, name)[k].detach().cpu().numpy() for b in self.blocks])
        out[".slot_map"] = np.stack([b.slot_map.cpu().numpy() for b in self.blocks])
        return out

    def save_checkpoint(self, manager) -> str:
        """One checkpoint of the whole block state in dogs_tpu's layout, with
        dogs_tpu's extra keys (step, phase, n_global, rho, the RandomState
        key) and the host state a resumed run needs to continue bit for bit:
        the RandomState position, the blocks' camera orders, the split-noise
        generators (with their device type) and the last event's overflow."""
        _, key, pos, *_ = self.rng.get_state()
        last = self._last_overflow
        extra = {
            "step": self.step,
            "admm_enabled": bool(self.admm_enabled),
            "n_global": int(self.n_global),
            "rho": [float(self.rho[k]) for k in PARAM_NAMES],
            "np_rng": key.tolist(),
            "np_rng_pos": int(pos),
            "spatial_lr_scale": self.spatial_lr_scale,
            "camera_orders": [list(o) for o in self._cam_order],
            "noise_rng": [g.get_state().tolist() for g in self.noise_gens],
            "noise_rng_device": self.devices[0].type,
            "last_overflow": None if last is None else [int(o) for o in last],
        }
        return manager.save_arrays(self.step, self.state_arrays(), extra)

    def load_checkpoint(self, manager, path: str | None = None) -> int:
        """Resume from `path` or the manager's latest checkpoint (the port's,
        or dogs_tpu's stacked block state); returns the restored step (0 when
        there is none). The split-noise generators are restored from a
        checkpoint of the same device type, else reseeded from the seed, the
        block and the step."""
        path = path or manager.latest_path()
        if path is None:
            return 0
        arrays, extra = read_checkpoint(path)
        b = arrays[".slot_map"].shape[0]
        if b != len(self.blocks):
            raise ValueError(f"checkpoint {path} holds {b} blocks, this trainer {len(self.blocks)}")
        blocks = []
        for kb, dev in enumerate(self.devices):
            train = train_state_from_arrays(
                {k[len(".train/"):]: a[kb] for k, a in arrays.items() if k.startswith(".train/")}, dev, path)
            tree = {name: {k: torch.as_tensor(arrays[f".{name}/.{k}"][kb], device=dev) for k in PARAM_NAMES}
                    for name in ("u", "z_local")}
            blocks.append(AdmmBlockState(train=train, slot_map=torch.as_tensor(arrays[".slot_map"][kb], device=dev),
                                         **tree))
        self.blocks = blocks
        self.step = int(extra["step"])
        self.n_global = int(extra["n_global"])
        self.admm_enabled = bool(extra["admm_enabled"])
        self.set_rho(dict(zip(PARAM_NAMES, (np.float32(v) for v in extra["rho"]))))
        st = self.rng.get_state()
        self.rng.set_state((st[0], np.asarray(extra["np_rng"], np.uint32), extra.get("np_rng_pos", 0), 0, 0.0))
        self._cam_order = [list(o) for o in extra.get("camera_orders", [[] for _ in blocks])]
        saved_on = extra.get("noise_rng_device")
        for kb, g in enumerate(self.noise_gens):
            if saved_on == self.devices[kb].type:
                g.set_state(torch.tensor(extra["noise_rng"][kb], dtype=torch.uint8))
            else:
                g.manual_seed(_noise_seed(self.seed, kb, self.step))
        last = extra.get("last_overflow")
        self._last_overflow = None if last is None else [
            torch.tensor(v, dtype=torch.int32, device=dev) for v, dev in zip(last, self.devices)]
        self._pending_overflow = []
        return self.step

    # ---- construction from on-disk block manifests ---------------------------
    @classmethod
    def from_manifests(
        cls,
        scene_root: str,
        mx: int,
        my: int,
        trainer_cfg: TrainerConfig,
        raster_cfg: RasterConfig,
        admm_cfg: AdmmConfig = AdmmConfig(),
        spatial_lr_scale: float = -1.0,
        seed: int = 42,
        device: str = "cuda",
    ) -> "MasterTrainer":
        """The block trainer from the `blocks_{mx}x{my}/block_k` manifests
        that `python -m dogs_tpu_torch.preprocess` (or dogs_tpu's
        preprocess_large_scale_data.py) wrote; images embedded in a manifest
        load up front, others stream from their paths."""
        blocks, partition = load_manifest_partition(scene_root, mx, my)
        devices = block_devices(len(blocks), device)
        block_cameras, block_images = [], []
        for blk, dev in zip(blocks, devices):
            block_cameras.append([dataclasses.replace(r, image_index=i).to_camera(dev)
                                  for i, r in enumerate(blk["cameras"])])
            if blk.get("images") is not None:
                block_images.append(blk["images"])
            else:
                block_images.append(LazyImageList(blk["cameras"]))
        if spatial_lr_scale <= 0:
            spatial_lr_scale = compute_nerf_plus_plus_norm([c for cams in block_cameras for c in cams])
        return cls(
            partition=partition,
            block_points=[blk["points"] for blk in blocks],
            block_colors=[blk["colors"] for blk in blocks],
            block_cameras=block_cameras,
            block_images=block_images,
            trainer_cfg=trainer_cfg,
            raster_cfg=raster_cfg,
            admm_cfg=admm_cfg,
            spatial_lr_scale=spatial_lr_scale,
            seed=seed,
            device=device,
        )

    # ---- evaluation on the fused global model -------------------------------
    def global_model(self, prune: bool | None = None) -> GaussianModelState:
        """The fused global model for validation and export (the master's
        validate-time fusion, master:730-744), on block 0's device. `prune`
        opts into the post-merge prune; by default it runs only in
        fusion-only mode (admm.enable=false), where this is the only fusion."""
        if prune is None:
            prune = not self.admm_cfg.enable and self.cfg.prune_percent > 0
        models = gather_block_models(self.blocks)
        if prune:
            fused, _ = fuse_local_gaussians(
                models, self.partition, prune_cameras=[c for cams in self.block_cameras for c in cams],
                raster_cfg=self.raster_cfg, prune_percent=self.cfg.prune_percent, prune_v_pow=self.cfg.prune_v_pow,
                active_sh_degree=self.cfg.max_sh_degree, device=self.devices[0],
            )
        else:
            fused, _ = fuse_local_gaussians(models, self.partition)
        return fused_model_state(fused, self.devices[0])

    def validate(self, cameras: Sequence[Camera], images) -> dict:
        """Held-out PSNR of the fused global model after color correction
        (the reference's validate-time fusion, master:730-744, scored as
        the evaluator scores val), and its Gaussian count."""
        model = self.global_model()  # its fusion-only prune differentiates
        dev = self.devices[0]
        psnrs = []
        with torch.no_grad():
            for cam, gt in zip(cameras, images):
                gt = torch.as_tensor(np.asarray(gt, np.float32), device=dev)
                out = render_tiled(model.params, _camera_to(cam, dev), self.raster_cfg, alive=model.alive,
                                   active_sh_degree=self.cfg.max_sh_degree)
                img = color_correct(torch.clamp(out.image, 0.0, 1.0), gt)
                mse = float(torch.mean((img - gt) ** 2))
                psnrs.append(-10.0 * math.log10(max(mse, 1e-10)))
        return {"val_psnr": float(np.mean(psnrs)), "num_points": int(model.num_alive)}


def load_manifest_partition(scene_root: str, mx: int, my: int) -> tuple[list[dict], BlockPartition]:
    """The `blocks_{mx}x{my}` manifests and the partition geometry written by
    the preprocess CLI of either package (no device needed)."""
    b = mx * my
    blocks = [load_block(block_dir(scene_root, mx, my, k)) for k in range(b)]
    out_root = os.path.dirname(block_dir(scene_root, mx, my, 0))
    transform = np.load(os.path.join(out_root, "world_to_obb_transform.npy"))

    def read_boxes(name):
        """Reference table format (load_colmap.py:425-429): the first b rows
        are CAMERA boxes, the last b rows POINT boxes; tables with only the
        camera rows have no point boxes."""
        rows = np.loadtxt(os.path.join(out_root, name)).reshape(-1, 2, 2)
        if rows.shape[0] == 2 * b:
            return rows[:b], rows[b:]
        return rows.reshape(b, 2, 2), None

    bounds, pbounds = read_boxes("bounding_boxes_origin.txt")
    bounds_exp, pbounds_exp = read_boxes("bounding_boxes.txt")
    partition = BlockPartition(
        num_blocks=b,
        transform=transform,
        camera_labels=np.concatenate([np.full(len(blk["cameras"]), k, np.int32) for k, blk in enumerate(blocks)]),
        bounds=bounds,
        bounds_expanded=bounds_exp,
        point_masks=[],
        point_bounds=pbounds,
        point_bounds_expanded=pbounds_exp,
    )
    return blocks, partition


def load_fused_from_checkpoint(ckpt_path: str, partition: BlockPartition, device: str = "cuda") -> GaussianModelState:
    """The fused global model from a block checkpoint of either package, on
    one device (the reference evaluator merges per-block checkpoints,
    conerf/evaluators/evaluator.py:213-259): the stacked (B, C, ...) block
    parameters and alive masks read straight from the npz, then the fusion
    crop without the prune. Reads only those leaves."""
    with np.load(ckpt_path, allow_pickle=False) as data:

        def leaf(suffix: str) -> np.ndarray:
            hits = [k for k in data.files if k.endswith(suffix)]
            if len(hits) != 1:
                raise KeyError(f"checkpoint {ckpt_path}: expected one leaf ending {suffix!r}, found {hits}")
            return data[hits[0]]

        stacked = {f: leaf(f".train/.model/.params/.{f}") for f in PARAM_NAMES}
        alive = leaf(".train/.model/.alive").astype(bool)
    models = [dict({f: stacked[f][k] for f in PARAM_NAMES}, alive=alive[k]) for k in range(alive.shape[0])]
    fused, _ = fuse_local_gaussians(models, partition)
    return fused_model_state(fused, device)
