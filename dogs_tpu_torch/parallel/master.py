"""Master orchestration: block training, fusion, ADMM consensus.

Port of dogs_tpu/parallel/master.py (the reference
MasterGaussianSplatTrainer, conerf/trainers/master_gaussian_trainer.py:
201-786). dogs_tpu drives one SPMD program over a mesh; the port drives B
blocks (parallel/admm.py), each an `AdmmBlockState`, all in one process on
one device or, with `distributed`, in one process per rank
(parallel/ranks.py; the reference's one process per GPU), through three
phases:

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
    adapts rho until stop_adapt_iter (master:336-377). The round averages
    the shared rows only, all-reduced over ranks (`consensus_round_shared`).

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
import weakref
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
from dogs_tpu_torch.fields.appearance import flatten as flatten_tree
from dogs_tpu_torch.fields.lightgaussian import calculate_v_imp_score, prune_gaussians, prune_list
from dogs_tpu_torch.fields.model import GaussianModelState, densify_and_prune, fresh_stats, required_slots, reset_opacity
from dogs_tpu_torch import kernels
from dogs_tpu_torch.parallel import ranks as ranks_mod
from dogs_tpu_torch.parallel.admm import (
    SUMMED_METRICS,
    AdmmBlockState,
    AdmmConfig,
    SharedIndex,
    _with_duals,
    adapt_rho,
    block_metrics,
    block_state_from_rows,
    consensus_round_shared,
    shared_rows,
)
from dogs_tpu_torch.raster.tiled import RasterConfig, render_tiled
from dogs_tpu_torch.train import schedule
from dogs_tpu_torch.train import trainer as trainer_mod
from dogs_tpu_torch.train.checkpoint import read_checkpoint, train_state_arrays, train_state_from_arrays
from dogs_tpu_torch.train.trainer import (
    TrainerConfig,
    compute_nerf_plus_plus_norm,
    grow_capacity,
    init_train_state,
    zero_moments_at,
    zero_opacity_moments,
)
from dogs_tpu_torch.utils import trace

logger = logging.getLogger(__name__)


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
    """Host-side phase driver for block-parallel training.

    Block k trains `block_cameras[k]` against `block_images[k]` ((H, W, 3)
    arrays in [0, 1], or a `LazyImageList`) from the points
    `block_points[k]` (`block_points=None`: no block phase; `start_admm`
    gives the blocks their fused parameters), on `device` ("cuda": the
    first card; "cpu").

    `distributed` (the config's trainer.distributed) runs R ranks, one
    process each (parallel/ranks.py): min(B, CUDA devices) on "cuda", B on
    the CPU; otherwise R = 1, the caller's process alone. Block k lives on
    rank k mod R, on that rank's device (`cuda:<rank>`); the caller is rank
    0 and the public methods run on every rank in lockstep, one command per
    call:
    a `train_iteration` is `consensus_interval` steps with no traffic
    between ranks, then the fusion or a consensus round over them
    (`consensus_round_shared`). The block inputs go to each rank once,
    at start; the fusion gathers the blocks to rank 0, fuses and prunes
    there and sends each rank its rows; checkpoints keep the one-file
    format. A rank that dies or stays silent for `rank_timeout_s` makes
    rank 0 raise; `close()` (also at exit) stops the ranks."""

    def __init__(
        self,
        partition: BlockPartition,
        block_points: list[np.ndarray] | None,
        block_colors: list[np.ndarray] | None,
        block_cameras: list[list[Camera]],
        block_images: list,
        trainer_cfg: TrainerConfig,
        raster_cfg: RasterConfig,
        admm_cfg: AdmmConfig = AdmmConfig(),
        spatial_lr_scale: float = 1.0,
        seed: int = 42,
        device: str = "cuda",
        distributed: bool = False,
        rank_timeout_s: float = 600.0,
    ):
        empty = [k for k, cams in enumerate(block_cameras) if not cams]
        if empty:
            raise ValueError(
                f"blocks {empty} have no cameras: every block trains one camera per step; "
                "re-partition with fewer blocks or a different method"
            )
        if admm_cfg.gt_dtype not in ("uint8", "float32"):
            raise ValueError(f"admm.gt_dtype {admm_cfg.gt_dtype!r}: expected 'uint8' or 'float32'")
        b = len(block_cameras)
        world = 1
        if distributed:
            world = max(1, min(b, torch.cuda.device_count() if device == "cuda" else b))
        common = dict(partition=partition, n_cams=[len(c) for c in block_cameras],
                      block_sizes=None if block_points is None else [len(p) for p in block_points],
                      trainer_cfg=trainer_cfg, raster_cfg=raster_cfg, admm_cfg=admm_cfg,
                      spatial_lr_scale=spatial_lr_scale, seed=seed, device=device)

        def part(r: int, items):
            return None if items is None else [items[k] for k in range(r, b, world)]

        self._group = None
        if world > 1:
            if device == "cuda":
                kernels.build_all()  # once, before the ranks start
            payloads = [dict(common, block_points=part(r, block_points), block_colors=part(r, block_colors),
                             block_cameras=[[_camera_to(c, torch.device("cpu")) for c in cams]
                                            for cams in part(r, block_cameras)],
                             block_images=[_portable_images(im) for im in part(r, block_images)])
                        for r in range(1, world)]
            self._group = ranks_mod.RankGroup.start(world, rank_timeout_s, _rank_main, payloads, device)
            self._finalizer = weakref.finalize(self, self._group.close)
        self._setup(0, world, None, block_points=part(0, block_points), block_colors=part(0, block_colors),
                    block_cameras=part(0, block_cameras), block_images=part(0, block_images),
                    all_cameras=[c for cams in block_cameras for c in cams], **common)

    def _setup(self, rank: int, world: int, link, partition, block_points, block_colors, block_cameras,
               block_images, n_cams, block_sizes, trainer_cfg, raster_cfg, admm_cfg, spatial_lr_scale, seed,
               device: str = "cuda", all_cameras=None) -> None:
        """This rank's part: blocks rank, rank + world, ... of the
        len(n_cams) blocks (`block_*` hold those only)."""
        self.rank, self.world, self._link = rank, world, link
        self.partition = partition
        self.cfg = trainer_cfg
        self.raster_cfg = raster_cfg
        self.admm_cfg = admm_cfg
        self.spatial_lr_scale = spatial_lr_scale
        self.seed = seed
        self.num_blocks = b = len(n_cams)
        self.n_cams = list(n_cams)
        self.owned = list(range(rank, b, world))
        self._local = {kb: i for i, kb in enumerate(self.owned)}
        self.devices = [ranks_mod.rank_device(rank, device)] * len(self.owned)
        # Cameras re-indexed to their in-block position (each slave's
        # MiniDataset indexes locally, master:839-873): image_index keys the
        # block's exposure, pose and mask rows and its GT images.
        self.block_cameras = [
            [dataclasses.replace(_camera_to(c, dev), image_index=i) for i, c in enumerate(cams)]
            for cams, dev in zip(block_cameras, self.devices)
        ]
        # Every block's cameras, for the post-merge prune (rank 0).
        self.all_cameras = None if all_cameras is None else [_camera_to(c, self.devices[0]) for c in all_cameras]
        self.block_images = [_local_images(im) for im in block_images]
        # One RandomState on every rank: each draws every block's camera
        # order, in block order, and trains its own blocks.
        self.rng = np.random.RandomState(seed)
        self.noise_gens = [torch.Generator(device=dev).manual_seed(_noise_seed(seed, kb))
                           for kb, dev in zip(self.owned, self.devices)]
        self.admm_enabled = False
        self.step = 0
        self._shared: list[SharedIndex] = []
        self.n_shared = 0

        self.blocks: list[AdmmBlockState] = []
        self.n_global = 0
        if block_points is not None:
            # Before fusion every block trains its own cloud; the global ids
            # are disjoint (no consensus yet, they only reserve slots).
            offsets = np.concatenate([[0], np.cumsum(block_sizes)]).astype(np.int32)
            ids = [np.arange(offsets[k], offsets[k + 1], dtype=np.int32) for k in self.owned]
            cap = round_up_capacity(max(block_sizes), trainer_cfg.min_capacity)
            cfg = dataclasses.replace(trainer_cfg, min_capacity=cap)
            states = [init_train_state(p, c[: len(p)], max(n_cams), cfg, dev)
                      for p, c, dev in zip(block_points, block_colors, self.devices)]
            self.n_global = int(offsets[-1])
            self.blocks = _with_duals(states, ids, self.n_global)
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
        self._gt_pool = [self._resident_gt(i) for i in range(len(self.owned))]

    # ---- ranks -----------------------------------------------------------------
    def _run(self, name: str, *args):
        """`self._<name>(*args)` on every rank; returns rank 0's result and
        the workers' replies."""
        return self._run_each(name, [args] * self.world)

    def _run_each(self, name: str, args_per_rank: list[tuple], outgoing: list | None = None):
        """`self._<name>(*args_per_rank[r])` on every rank r; `outgoing[r]`,
        tensors that rank r's part receives from rank 0, follow the command."""
        if self._group is None:
            return getattr(self, "_" + name)(*args_per_rank[0]), []
        with trace.span("dogs.admm.command"):
            self._group.command(name, args_per_rank[1:])
        self._ship(outgoing)
        mine = getattr(self, "_" + name)(*args_per_rank[0])
        return mine, self._group.replies()

    @staticmethod
    def _ship(outgoing: list | None) -> None:
        for r, tensors in enumerate(outgoing or []):
            if r and tensors:
                ranks_mod.send_tensors(tensors, r)

    def _in_block_order(self, per_rank: list[list]) -> list:
        """Per-rank lists of their blocks' items -> one list in block order."""
        return [per_rank[kb % self.world][kb // self.world] for kb in range(self.num_blocks)]

    def _owned_of(self, r: int) -> list[int]:
        return list(range(r, self.num_blocks, self.world))

    def _all_reduce(self, t: torch.Tensor, op=None) -> torch.Tensor:
        """`t` reduced over ranks in place (a no-op with one rank)."""
        if self.world == 1:
            return t
        return ranks_mod.all_reduce_(t, op or torch.distributed.ReduceOp.SUM)

    def _block_tensors(self, blk: AdmmBlockState, kind: str) -> dict[str, torch.Tensor]:
        if kind == "params":
            return {k: getattr(blk.train.model.params, k).detach() for k in PARAM_NAMES}
        if kind == "alive":
            return {"alive": blk.train.model.alive}
        if kind in ("u", "z_local"):
            return getattr(blk, kind)
        if kind in ("mu", "nu"):
            return getattr(blk.train.opt, kind)
        if kind == "slot_map":
            return {"slot_map": blk.slot_map}
        if kind in ("mask_params", "mask_mu", "mask_nu"):
            return flatten_tree(getattr(blk.train, kind))
        raise ValueError(f"no block tensors {kind!r}")

    def gather_blocks(self, kind: str) -> list[dict[str, torch.Tensor]]:
        """Every block's tensors of `kind` ("params", "alive", "u",
        "z_local", "mu", "nu", "slot_map", or the appearance mask's
        "mask_params", "mask_mu" and "mask_nu" keyed by their paths), in
        block order, on rank 0's device (the blocks on other ranks copied
        over the process group; rank 0's own are its live tensors)."""
        if self.world == 1:
            return [self._block_tensors(b, kind) for b in self.blocks]
        return self._run("send_blocks", kind)[0]

    def _send_blocks(self, kind: str):
        """Rank 0 receives every other rank's blocks of `kind`; the others
        send theirs, in block order."""
        if self.rank != 0:
            for blk in self.blocks:
                ranks_mod.send_tensors(list(self._block_tensors(blk, kind).values()), 0)
            return None
        template = self._block_tensors(self.blocks[0], kind)
        out = []
        for kb in range(self.num_blocks):
            if kb in self._local:
                out.append(self._block_tensors(self.blocks[self._local[kb]], kind))
            else:
                got = ranks_mod.recv_tensors(list(template.values()), kb % self.world)
                out.append(dict(zip(template, got)))
        return out

    def rank_states(self) -> list[dict]:
        """Each rank's step, phase, global count and rho (float32), in rank
        order: the ranks run in lockstep, so these agree."""
        mine, theirs = self._run("rank_state")
        return [mine] + theirs

    def _rank_state(self) -> dict:
        return dict(step=self.step, admm_enabled=self.admm_enabled, n_global=self.n_global, **self.rho)

    def sync(self) -> None:
        """Wait until every rank's device has finished its queued work."""
        self._run("sync_devices")

    def _sync_devices(self) -> None:
        for dev in set(self.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    # ---- GT images -------------------------------------------------------------
    @property
    def _gt_np_dtype(self):
        return np.uint8 if self.admm_cfg.gt_dtype == "uint8" else np.float32

    def _resident_gt(self, kb: int) -> torch.Tensor | None:
        """This rank's block kb's GT images as one (I, H, W, 3) tensor of
        gt_dtype on its device, when admm.gt_resident is on, they share one
        shape and fit admm.gt_resident_max_bytes; else None (they stream
        through the GT cache). A LazyImageList read in full here is closed,
        unless coarse-to-fine is on: its factors above 1 stream from it."""
        images = self.block_images[kb]
        if not self.admm_cfg.gt_resident or not len(images):
            return None
        first = np.asarray(images[0], np.float32)
        nbytes = len(images) * first.size * np.dtype(self._gt_np_dtype).itemsize
        if first.ndim != 3 or first.shape[-1] != 3 or nbytes > self.admm_cfg.gt_resident_max_bytes:
            logger.info("block %d: GT images stream (%.0f MB over the resident budget or not RGB)",
                        self.owned[kb], nbytes / 1e6)
            return None
        stack = np.zeros((len(images),) + first.shape, self._gt_np_dtype)
        for i in range(len(images)):
            im = first if i == 0 else np.asarray(images[i], np.float32)
            if im.shape != first.shape:
                logger.info("block %d: non-uniform image shapes; GT images stream", self.owned[kb])
                return None
            stack[i] = encode_gt(im, self._gt_np_dtype)
        if isinstance(images, LazyImageList) and not self.cfg.coarse_to_fine:  # c2f reads them again
            images.close()
        logger.info("block %d: %d GT images resident at %dx%d %s (%.0f MB)", self.owned[kb], len(images),
                    first.shape[1], first.shape[0], self.admm_cfg.gt_dtype, nbytes / 1e6)
        return torch.as_tensor(stack, device=self.devices[kb])

    def _gt(self, kb: int, i: int, res: int = 1) -> torch.Tensor:
        """This rank's block kb's GT image i at coarse-to-fine factor `res`
        as float32 on its device: stored at gt_dtype and decoded x 1/255 as
        dogs_tpu's step decodes it. The resident pool serves res == 1 only;
        otherwise the image streams through the LRU cache keyed (kb, i,
        res), resized in f32 to the downsampled camera's size first and
        encoded second (dogs_tpu's _gt_stream_cached)."""
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
        """Stop the image reader threads of streamed blocks, and the ranks."""
        for images in self.block_images:
            if isinstance(images, LazyImageList):
                images.close()
        if self._group is not None:
            self._finalizer()

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
            self._step_fns[key] = trainer_mod.make_train_step(self.cfg, self.raster_cfg, self.spatial_lr_scale,
                                                              active_sh_degree, bg, admm=self.admm_enabled)
        return self._step_fns[key]

    def _next_camera(self, kb: int) -> int:
        """dogs_tpu's camera order: blocks draw in order 0..B-1 each step, a
        block's permutation from the shared seeded RandomState when its list
        runs out, consumed from the end."""
        if not self._cam_order[kb]:
            self._cam_order[kb] = [int(i) for i in self.rng.permutation(self.n_cams[kb])]
            if kb in self._local:
                j = self._local[kb]
                images = self.block_images[j]
                streams = self._gt_pool[j] is None or self.training_resolution(self.step + 1) > 1
                if streams and isinstance(images, LazyImageList):
                    images.hint(list(reversed(self._cam_order[kb])))
        return self._cam_order[kb].pop()

    def train_step(self) -> list[dict]:
        """One master step: each block's train step (with the penalty in
        the ADMM phase), then the host events. Returns each block's metrics
        (0-d device tensors; floats over ranks). Every block trains at the
        master step's coarse-to-fine factor, on its downsampled camera."""
        if self.world == 1:
            return self._step_blocks()
        mine, theirs = self._run("step_floats")
        return self._in_block_order([mine] + theirs)

    def _step_floats(self) -> list[dict]:
        metrics = self._step_blocks()
        return [dict(zip(m, v)) for m, v in zip(metrics, self._read([list(m.values()) for m in metrics]))]

    def _read(self, groups: list[list]) -> list[list[float]]:
        """Groups of 0-d tensors (or numbers) read to the host in one transfer."""
        flat = [torch.as_tensor(v, dtype=torch.float64).to(self.devices[0]) for g in groups for v in g]
        vals = torch.stack(flat).tolist() if flat else []
        out, i = [], 0
        for g in groups:
            out.append(vals[i: i + len(g)])
            i += len(g)
        return out

    def _step_blocks(self) -> list[dict]:
        """This rank's blocks' step (every block's camera drawn in block
        order), then the host events."""
        step_fn = self._step_fn(self.active_sh_degree(self.step + 1))
        res = self.training_resolution(self.step + 1)
        metrics = []
        for kb in range(self.num_blocks):
            i = self._next_camera(kb)
            if kb not in self._local:
                continue
            j = self._local[kb]
            blk = self.blocks[j]
            gt = self._gt(j, i, res)
            cam = self.block_cameras[j][i]
            extra = (blk.u, blk.z_local, self._rho_dev[j]) if self.admm_enabled else ()
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
        mine, theirs = self._run("iteration")
        per_rank = [mine] + theirs
        out = block_metrics(self._in_block_order([p["blocks"] for p in per_rank]))
        for k in SUMMED_METRICS:
            out[k] = float(np.max(np.sum([p["saturation"][k] for p in per_rank], axis=0)))
        self._warn_saturation(out)
        if mine["residuals"] is not None:
            primal, dual = mine["residuals"]
            out.update({f"primal_{k}": float(v) for k, v in primal.items()})
            out.update({f"dual_{k}": float(v) for k, v in dual.items()})
        return out

    def _iteration(self) -> dict:
        """One rank's interval: its blocks' steps, one read of their last
        metrics, each step's summed saturation counters and the pending
        overflow, then the fusion or the round (across ranks)."""
        target = self.step + self.admm_cfg.consensus_interval
        metrics: list[dict] = []
        sat: dict[str, list] = {k: [] for k in SUMMED_METRICS}
        while self.step < target:
            metrics = self._step_blocks()
            for k in SUMMED_METRICS:
                sat[k].append(torch.stack([torch.as_tensor(m[k], device=self.devices[0]) for m in metrics]).sum())
        read = self._drain_groups([list(m.values()) for m in metrics] + [sat[k] for k in SUMMED_METRICS])
        blocks = [dict(zip(m, v)) for m, v in zip(metrics, read)]
        out = dict(blocks=blocks, saturation=dict(zip(SUMMED_METRICS, read[len(metrics):])), residuals=None)
        # admm.enable=false is the reference's fusion-only mode (master:
        # 686-688): blocks train on and validate() fuses each call.
        if not self.admm_enabled and self.admm_cfg.enable and self.step >= self.cfg.densify_end_iter:
            self._fuse()
        elif self.admm_enabled:
            out["residuals"] = self._consensus()
        return out

    @staticmethod
    def _warn_saturation(out: dict) -> None:
        if int(out.get("bin_pool_truncated", 0) + out.get("bin_dropped", 0)) > 0:
            logger.warning("tile-bin saturation: pool_truncated=%d dropped=%d",
                           int(out.get("bin_pool_truncated", 0)), int(out.get("bin_dropped", 0)))

    def consensus(self) -> tuple[dict[str, np.float32], dict[str, np.float32]]:
        """One consensus round; stores the new duals and z_local, adapts rho
        before stop_adapt_iter. Returns the residuals (float32, host)."""
        return self._run("consensus")[0]

    def _consensus(self) -> tuple[dict[str, np.float32], dict[str, np.float32]]:
        with trace.span("dogs.admm.consensus"):
            new_u, z_new, primal, dual = consensus_round_shared(
                self.blocks, self._shared, self.n_shared, self.num_blocks, self._rho_dev[0], self.admm_cfg,
                all_reduce=self._all_reduce)
            for blk, u, zl in zip(self.blocks, new_u, z_new):
                blk.u, blk.z_local = u, zl
            if self.step < self.admm_cfg.stop_adapt_iter:
                self.set_rho(adapt_rho(self.rho, primal, dual, self.admm_cfg))
        return primal, dual

    def _drain_groups(self, groups: list[list]) -> list[list[float]]:
        """Read `groups` and every pending densify overflow in one transfer;
        log each event's overflow (a dropped candidate is never silent)."""
        pending, self._pending_overflow = self._pending_overflow, []
        read = self._read(groups + [[ov for _, _, ov in pending]])
        for (step, kb, _), ov in zip(pending, read[-1]):
            if ov > 0:
                logger.warning("densify overflow at step %d, block %d: %d candidates dropped", step, kb, int(ov))
        return read[:-1]

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
        for j, blk in enumerate(self.blocks):
            model = blk.train.model
            counts.append(model.num_alive.to(self.devices[0]))
            imp = prune_list(model, self.block_cameras[j], self.raster_cfg, deg)
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

    def _split_noise(self, j: int, capacity: int) -> torch.Tensor:
        """This rank's block j's split draw of one densify event: (2 capacity, 3)."""
        return torch.randn((2 * capacity, 3), generator=self.noise_gens[j], device=self.devices[j])

    def _densify_blocks(self) -> None:
        """Per-block densify and prune into one shared capacity, grown first
        when a block would overflow (grow-first, the port's default) or after
        an event that dropped candidates (reactive_capacity_growth); the
        growth is the largest over every block of every rank."""
        cfg = self.cfg
        cap = self.blocks[0].train.model.capacity
        dev = self.devices[0]
        if cfg.reactive_capacity_growth:
            prev = self._last_overflow
            need = self._all_reduce(torch.stack([o.to(dev) for o in prev]).max() if prev
                                    else torch.zeros((), dtype=torch.int32, device=dev),
                                    torch.distributed.ReduceOp.MAX)
            need = int(need)
            if need > 0:
                logger.info("reactive block capacity growth %d -> %d (%d dropped last event)",
                            cap, round_up_capacity(cap + need), need)
        else:
            need = int(self._all_reduce(torch.stack([
                required_slots(b.train.model, cfg.densify_grad_threshold, cfg.percent_dense,
                               self.spatial_lr_scale).to(dev)
                for b in self.blocks]).max(), torch.distributed.ReduceOp.MAX))
        if need > 0:
            self._grow_blocks(round_up_capacity(cap + need))
        overflow = []
        for j, blk in enumerate(self.blocks):
            _, allocated, ov = densify_and_prune(
                blk.train.model, self._split_noise(j, blk.train.model.capacity), cfg.densify_grad_threshold,
                cfg.min_opacity, self.spatial_lr_scale, None, percent_dense=cfg.percent_dense,
            )
            zero_moments_at(blk.train.opt, allocated)
            overflow.append(ov)
            self._pending_overflow.append((self.step, self.owned[j], ov))
        self._last_overflow = overflow

    # ---- the phase boundary ------------------------------------------------------
    def fuse_and_enable_admm(self) -> None:
        """The one-time fusion (master:557-618, dogs_tpu master.py:703-758):
        fuse with the post-merge prune over every block camera, restart
        each block from its re-selected fused Gaussians (fresh moments,
        exposure, pose and mask; the train step at the master step;
        z_local = x, u = 0) and rho from the global count."""
        self._run("fuse")

    def _fuse(self) -> None:
        """Every rank's part of the fusion: the blocks to rank 0, which
        fuses, prunes and sends each rank its rows (`start_admm`)."""
        with trace.span("dogs.admm.fusion"):
            models = self._gather_models()
            if self.rank != 0:
                self._start_admm(*self._link.recv())
                return
            fused, block_ids = fuse_local_gaussians(
                models, self.partition,
                prune_cameras=self.all_cameras if self.cfg.prune_percent > 0 else None,
                raster_cfg=self.raster_cfg, prune_percent=self.cfg.prune_percent, prune_v_pow=self.cfg.prune_v_pow,
                active_sh_degree=self.cfg.max_sh_degree, device=self.devices[0],
            )
            parts, outgoing = self._admm_parts(fused, block_ids, self.step)
            for r in range(1, self.world):
                self._group.send(r, parts[r])
            self._ship(outgoing)
            self._start_admm(*parts[0])

    def start_admm(self, fused: dict, block_ids: list[np.ndarray], step: int | None = None) -> None:
        """Enter the ADMM phase from fused parameters (how the fusion ends):
        block k holds fused[f][block_ids[k]] (numpy arrays, or tensors on
        rank 0's device) with fresh moments, densify statistics and
        per-image state, z_local = x and u = 0, at master step `step` (the
        current one by default), and rho from the global count."""
        self._run_each("start_admm", *self._admm_parts(fused, block_ids, self.step if step is None else step))

    def _admm_parts(self, fused: dict, block_ids: list[np.ndarray], step: int) -> tuple[list[tuple], list[list]]:
        """Each rank's arguments of `_start_admm` (its blocks' ids, rows and
        shared slots; the other ranks' rows as (shape, dtype), their
        tensors in `outgoing`, sent from rank 0's device)."""
        n_global = int(fused["xyz"].shape[0])
        cap = round_up_capacity(max(len(ids) for ids in block_ids), self.cfg.min_capacity)
        n_shared, slots = shared_rows(block_ids, n_global, cap)
        parts, outgoing = [], []
        for r in range(self.world):
            rows, wire = [], []
            for kb in self._owned_of(r):
                if torch.is_tensor(fused["xyz"]):
                    sel = torch.as_tensor(block_ids[kb], dtype=torch.int64, device=fused["xyz"].device)
                    block = {k: fused[k][sel] for k in PARAM_NAMES}
                else:
                    block = {k: fused[k][block_ids[kb]] for k in PARAM_NAMES}
                if r:
                    block = {k: torch.as_tensor(v, device=self.devices[0]) for k, v in block.items()}
                    wire += list(block.values())
                    block = {k: (tuple(v.shape), v.dtype) for k, v in block.items()}
                rows.append(block)
            parts.append(([block_ids[kb] for kb in self._owned_of(r)], rows, slots[self._owned_of(r)], n_shared,
                          n_global, cap, step))
            outgoing.append(wire)
        return parts, outgoing

    def _start_admm(self, ids: list[np.ndarray], rows: list[dict], shared_slots, n_shared: int, n_global: int,
                    cap: int, step: int) -> None:
        states = []
        for block_rows, dev in zip(rows, self.devices):
            if isinstance(block_rows["xyz"], tuple):  # (shape, dtype): the rows follow from rank 0
                got = ranks_mod.recv_tensors([torch.empty(sh, dtype=dt, device=dev) for sh, dt in block_rows.values()],
                                             0)
                block_rows = dict(zip(block_rows, got))
            states.append(block_state_from_rows(block_rows, cap, max(self.n_cams), self.cfg, step, dev))
        self.blocks = _with_duals(states, ids, n_global)
        self.n_global = n_global
        self.n_shared = n_shared
        self._shared = [SharedIndex.of(s, dev) for s, dev in zip(shared_slots, self.devices)]
        self.step = step
        self.set_rho(self.admm_cfg.initial_rho(n_global))
        self.admm_enabled = True
        self._last_overflow = None
        logger.info("ADMM enabled at step %d with %d global gaussians (%d shared)", step, n_global, n_shared)

    # ---- checkpoint / resume -------------------------------------------------------
    def _block_arrays(self) -> list[dict[str, np.ndarray]]:
        """This rank's blocks as host arrays, keyed as `state_arrays` keys
        them, unstacked."""
        out = []
        for b in self.blocks:
            a = {f".train/{k}": v for k, v in train_state_arrays(b.train).items()}
            for name in ("u", "z_local"):
                a.update({f".{name}/.{k}": getattr(b, name)[k].detach().cpu().numpy() for k in PARAM_NAMES})
            a[".slot_map"] = b.slot_map.cpu().numpy()
            out.append(a)
        return out

    def _checkpoint_parts(self) -> list[tuple]:
        last = self._last_overflow
        return [(a, g.get_state().tolist(), None if last is None else int(o))
                for a, g, o in zip(self._block_arrays(), self.noise_gens, last or [None] * len(self.blocks))]

    def state_arrays(self) -> dict[str, np.ndarray]:
        """The blocks stacked as dogs_tpu's AdmmBlockState checkpoint holds
        them: every TrainState leaf under .train/ with a leading block axis,
        the duals under .u/, z_local under .z_local/, and .slot_map."""
        return self._stack([p[0] for p in self._all_checkpoint_parts()])

    def _all_checkpoint_parts(self) -> list[tuple]:
        mine, theirs = self._run("checkpoint_parts")
        return self._in_block_order([mine] + theirs)

    @staticmethod
    def _stack(per_block: list[dict[str, np.ndarray]]) -> dict[str, np.ndarray]:
        return {k: np.stack([a[k] for a in per_block]) for k in per_block[0]}

    def save_checkpoint(self, manager) -> str:
        """One checkpoint of the whole block state in dogs_tpu's layout, with
        dogs_tpu's extra keys (step, phase, n_global, rho, the RandomState
        key) and the host state a resumed run needs to continue bit for bit:
        the RandomState position, the blocks' camera orders, the split-noise
        generators (with their device type) and the last event's overflow."""
        parts = self._all_checkpoint_parts()
        _, key, pos, *_ = self.rng.get_state()
        extra = {
            "step": self.step,
            "admm_enabled": bool(self.admm_enabled),
            "n_global": int(self.n_global),
            "rho": [float(self.rho[k]) for k in PARAM_NAMES],
            "np_rng": key.tolist(),
            "np_rng_pos": int(pos),
            "spatial_lr_scale": self.spatial_lr_scale,
            "camera_orders": [list(o) for o in self._cam_order],
            "noise_rng": [p[1] for p in parts],
            "noise_rng_device": self.devices[0].type,
            "last_overflow": None if self._last_overflow is None else [p[2] for p in parts],
        }
        return manager.save_arrays(self.step, self._stack([p[0] for p in parts]), extra)

    def load_checkpoint(self, manager, path: str | None = None) -> int:
        """Resume from `path` or the manager's latest checkpoint (the port's,
        or dogs_tpu's stacked block state, written by any number of ranks);
        returns the restored step (0 when there is none). The split-noise
        generators are restored from a checkpoint of the same device type,
        else reseeded from the seed, the block and the step."""
        path = path or manager.latest_path()
        if path is None:
            return 0
        arrays, extra = read_checkpoint(path)
        b = arrays[".slot_map"].shape[0]
        if b != self.num_blocks:
            raise ValueError(f"checkpoint {path} holds {b} blocks, this trainer {self.num_blocks}")
        n_global = int(extra["n_global"])
        slots, n_shared = None, 0
        if bool(extra["admm_enabled"]):
            maps = arrays[".slot_map"]
            n_shared, slots = shared_rows([m[m < n_global] for m in maps], n_global, maps.shape[1])
        parts = []
        for r in range(self.world):
            kbs = self._owned_of(r)
            parts.append(({k: a[kbs] for k, a in arrays.items()}, extra, path,
                          None if slots is None else slots[kbs], n_shared))
        self._run_each("load_blocks", parts)
        return self.step

    def _load_blocks(self, arrays: dict, extra: dict, path: str, shared_slots, n_shared: int) -> None:
        blocks = []
        for j, dev in enumerate(self.devices):
            train = train_state_from_arrays(
                {k[len(".train/"):]: a[j] for k, a in arrays.items() if k.startswith(".train/")}, dev, path)
            tree = {name: {k: torch.as_tensor(arrays[f".{name}/.{k}"][j], device=dev) for k in PARAM_NAMES}
                    for name in ("u", "z_local")}
            blocks.append(AdmmBlockState(train=train, slot_map=torch.as_tensor(arrays[".slot_map"][j], device=dev),
                                         **tree))
        self.blocks = blocks
        self.step = int(extra["step"])
        self.n_global = int(extra["n_global"])
        self.admm_enabled = bool(extra["admm_enabled"])
        self.n_shared = n_shared
        self._shared = [] if shared_slots is None else [SharedIndex.of(s, dev)
                                                        for s, dev in zip(shared_slots, self.devices)]
        self.set_rho(dict(zip(PARAM_NAMES, (np.float32(v) for v in extra["rho"]))))
        st = self.rng.get_state()
        self.rng.set_state((st[0], np.asarray(extra["np_rng"], np.uint32), extra.get("np_rng_pos", 0), 0, 0.0))
        self._cam_order = [list(o) for o in extra.get("camera_orders", [[] for _ in range(self.num_blocks)])]
        saved_on = extra.get("noise_rng_device")
        for j, (kb, g) in enumerate(zip(self.owned, self.noise_gens)):
            if saved_on == self.devices[j].type:
                g.set_state(torch.tensor(extra["noise_rng"][kb], dtype=torch.uint8))
            else:
                g.manual_seed(_noise_seed(self.seed, kb, self.step))
        last = extra.get("last_overflow")
        self._last_overflow = None if last is None else [
            torch.tensor(last[kb], dtype=torch.int32, device=dev) for kb, dev in zip(self.owned, self.devices)]
        self._pending_overflow = []

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
        distributed: bool = False,
        rank_timeout_s: float = 600.0,
    ) -> "MasterTrainer":
        """The block trainer from the `blocks_{mx}x{my}/block_k` manifests
        that `python -m dogs_tpu_torch.preprocess` (or dogs_tpu's
        preprocess_large_scale_data.py) wrote; images embedded in a manifest
        load up front, others stream from their paths."""
        blocks, partition = load_manifest_partition(scene_root, mx, my)
        block_cameras, block_images = [], []
        for blk in blocks:
            block_cameras.append([dataclasses.replace(r, image_index=i).to_camera(device)
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
            distributed=distributed,
            rank_timeout_s=rank_timeout_s,
        )

    # ---- evaluation on the fused global model -------------------------------
    def _gather_models(self) -> list[dict[str, np.ndarray]] | None:
        """Every block's parameters and alive mask as host arrays on rank 0
        (None on the others, which send theirs)."""
        if self.world == 1:
            return gather_block_models(self.blocks)
        params, alive = self._send_blocks("params"), self._send_blocks("alive")
        if params is None:
            return None
        return [dict({k: v.cpu().numpy() for k, v in p.items()}, alive=a["alive"].cpu().numpy())
                for p, a in zip(params, alive)]

    def global_model(self, prune: bool | None = None) -> GaussianModelState:
        """The fused global model for validation and export (the master's
        validate-time fusion, master:730-744), on rank 0's first device.
        `prune` opts into the post-merge prune; by default it runs only in
        fusion-only mode (admm.enable=false), where this is the only fusion."""
        if prune is None:
            prune = not self.admm_cfg.enable and self.cfg.prune_percent > 0
        models = self._run("gather_models")[0]
        if prune:
            fused, _ = fuse_local_gaussians(
                models, self.partition, prune_cameras=self.all_cameras,
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


def _portable_images(images):
    """A block's images as they travel to its rank: a LazyImageList as its
    camera records (the rank opens its own reader), else host arrays."""
    if isinstance(images, LazyImageList):
        return ("lazy", images.records)
    return [np.asarray(im) for im in images]


def _local_images(images):
    if isinstance(images, tuple) and images and images[0] == "lazy":
        return LazyImageList(images[1])
    return images


def _rank_main(link, payload: dict) -> None:
    """A spawned rank: its part of the trainer, then the command loop."""
    trainer = MasterTrainer.__new__(MasterTrainer)
    trainer._group = None
    trainer._setup(link.rank, link.world, link, **payload)
    try:
        ranks_mod.serve(link, trainer)
    finally:
        for images in trainer.block_images:
            if isinstance(images, LazyImageList):
                images.close()


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
