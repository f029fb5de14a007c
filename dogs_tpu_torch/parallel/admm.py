"""Block-parallel ADMM consensus: the per-block state, the consensus round
and the residual-balancing rho.

Port of dogs_tpu/parallel/admm.py (the reference's master_gaussian_trainer.py
:201-786 + slave_gaussian_trainer.py:15-263). dogs_tpu runs the blocks as one
SPMD program over a mesh with a "block" axis: a shard_mapped train step and
a consensus step whose `psum` sums the blocks. The port keeps that shape in
one process with no mesh: a list of `AdmmBlockState`s, one per block, each
on its own device (round robin over the CUDA devices, all on one card when
there is one).

  * A block trains with `make_train_step(admm=True)`, the single-device step
    plus the scaled-dual penalty sum_p 0.5 rho_p mean_alive((x + u - z)^2).
    `block_metrics` averages the blocks' metrics where dogs_tpu `pmean`s them.
  * `consensus_round` is the reduction the `psum` did: each block's alive
    rows go to the global rows its `slot_map` names, summed in block order
    0..B-1 into one (G+1, ...) buffer on block 0's device (row G takes the
    private and padded slots), then z = sum / max(count, 1), the gather back
    to block slots, the over-relaxed dual update u += (1 + alpha)(x - z) and
    the primal and dual residuals. Within a block the alive slots name
    distinct global rows, so each block's scatter has unique targets and the
    sums do not depend on the order of a device's atomics: the round is
    deterministic on the card.
  * `adapt_rho` (master:336-377) runs on the host in float32, as dogs_tpu
    holds rho.

Parameter trees (x, u, z_local, rho, residuals) are dicts keyed by
`PARAM_NAMES`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dogs_tpu_torch.core.gaussians import PARAM_NAMES, GaussianParams, round_up_capacity
from dogs_tpu_torch.fields.model import GaussianModelState, fresh_stats
from dogs_tpu_torch.train.trainer import TrainerConfig, TrainState, init_train_state, train_state_from_model

# The per-property penalty weights of AdmmConfig, in PARAM_NAMES order.
ALPHA_FIELDS = ("alpha_xyz", "alpha_fdc", "alpha_fr", "alpha_s", "alpha_q", "alpha_o")
# Saturation counters that a master step sums over blocks (their max over
# steps); the other metrics are averaged over blocks.
SUMMED_METRICS = ("bin_pool_truncated", "bin_dropped")


@dataclasses.dataclass(frozen=True)
class AdmmConfig:
    """trainer.admm block of urban3d_admm.yaml:42-55 (dogs_tpu's names and
    defaults). `chain_steps` is accepted and ignored: the port steps once a
    master step (ROADMAP.md queue 3). `gt_resident` keeps each block's GT
    images on its device while they fit `gt_resident_max_bytes`, stored as
    `gt_dtype` ("uint8": 8-bit sources round-trip exactly; "float32")."""

    enable: bool = True
    consensus_interval: int = 200
    chain_steps: int = 10
    gt_resident: bool = True
    gt_resident_max_bytes: int = 4 << 30
    gt_dtype: str = "uint8"
    over_relaxation_coeff: float = 0.5
    alpha_xyz: float = 1e5
    alpha_fdc: float = 1e4
    alpha_fr: float = 1e5
    alpha_s: float = 1e4
    alpha_q: float = 1e5
    alpha_o: float = 1e4
    stop_adapt_iter: int = 32000
    mu: float = 10.0
    tau_inc: float = 2.0
    tau_dec: float = 2.0

    def initial_rho(self, num_gaussians: int) -> dict[str, np.float32]:
        """rho_p = alpha_p / num_global_gaussians in float32
        (master_gaussian_trainer.py:326-334 setup_penalty_parameters)."""
        s = 1.0 / max(num_gaussians, 1)
        return {k: np.float32(s * getattr(self, a)) for k, a in zip(PARAM_NAMES, ALPHA_FIELDS)}


@dataclasses.dataclass
class AdmmBlockState:
    """One block: its TrainState, its duals `u` and cached consensus
    `z_local` ((C, ...) per parameter, on the block's device) and its
    `slot_map` ((C,) int32 global row of each local slot, n_global where the
    slot is private or padding)."""

    train: TrainState
    u: dict[str, torch.Tensor]
    z_local: dict[str, torch.Tensor]
    slot_map: torch.Tensor


def make_slot_maps(global_ids_per_block: list[np.ndarray], capacity: int, n_global: int) -> np.ndarray:
    """Host side: per-block local-slot -> global-slot map (the master's
    global_indices, padded to the shared block capacity)."""
    out = np.full((len(global_ids_per_block), capacity), n_global, np.int32)
    for k, ids in enumerate(global_ids_per_block):
        out[k, : len(ids)] = ids
    return out


def _with_duals(states: list[TrainState], block_ids: list[np.ndarray], n_global: int) -> list[AdmmBlockState]:
    """Zero duals, z_local = x (a zero initial penalty) and the slot maps."""
    cap = states[0].model.capacity
    maps = make_slot_maps(block_ids, cap, n_global)
    out = []
    for ts, sm in zip(states, maps):
        params = ts.model.params
        out.append(AdmmBlockState(
            train=ts,
            u={k: torch.zeros_like(getattr(params, k), requires_grad=False) for k in PARAM_NAMES},
            z_local={k: getattr(params, k).detach().clone() for k in PARAM_NAMES},
            slot_map=torch.as_tensor(sm, device=params.xyz.device),
        ))
    return out


def build_admm_state(
    global_points: np.ndarray,
    global_colors: np.ndarray,
    block_ids: list[np.ndarray],
    n_images_per_block: int,
    cfg: TrainerConfig,
    devices: list[torch.device],
    capacity: int | None = None,
) -> list[AdmmBlockState]:
    """The blocks of the phase-1 start (master:252-273, slave:81-97): block k
    initialises from global_points[block_ids[k]] on devices[k]; all blocks
    share one padded capacity."""
    cap = capacity or round_up_capacity(max(len(ids) for ids in block_ids), cfg.min_capacity)
    cfg = dataclasses.replace(cfg, min_capacity=cap)
    states = [init_train_state(global_points[ids], global_colors[ids], n_images_per_block, cfg, dev)
              for ids, dev in zip(block_ids, devices)]
    return _with_duals(states, block_ids, len(global_points))


def admm_state_from_params(
    fused: dict[str, np.ndarray],
    block_ids: list[np.ndarray],
    n_images_per_block: int,
    cfg: TrainerConfig,
    step: int,
    devices: list[torch.device],
) -> list[AdmmBlockState]:
    """The blocks of the ADMM phase (master.py:703-758): block k holds the
    fused parameters fused[f][block_ids[k]] in its first slots and zeros past
    them, with fresh moments, densify statistics and per-image state, the
    train step set to `step`. dogs_tpu builds the state from the points
    (`build_admm_state`, whose KNN scales it then overwrites) and transplants
    the fused parameters; building it from them directly gives the same
    state."""
    cap = round_up_capacity(max(len(ids) for ids in block_ids), cfg.min_capacity)
    states = []
    for ids, dev in zip(block_ids, devices):
        rows = {}
        for k in PARAM_NAMES:
            a = np.zeros((cap,) + fused[k].shape[1:], np.float32)
            a[: len(ids)] = fused[k][ids]
            rows[k] = torch.as_tensor(a, device=dev)
        model = GaussianModelState(
            GaussianParams(**rows), torch.arange(cap, device=dev) < len(ids), *fresh_stats(cap, dev),
        )
        ts = train_state_from_model(model, n_images_per_block, cfg)
        ts.step = step
        states.append(ts)
    return _with_duals(states, block_ids, len(fused["xyz"]))


def block_metrics(per_block: list[dict]) -> dict[str, torch.Tensor]:
    """One master step's metrics from its blocks' (0-d tensors): the mean
    over blocks, except SUMMED_METRICS, summed (dogs_tpu pmeans the others
    and psums these, admm.py:363-368). On block 0's device."""
    dev = per_block[0]["loss"].device
    out = {}
    for k in per_block[0]:
        vals = torch.stack([torch.as_tensor(m[k], device=dev).to(torch.float32) for m in per_block])
        out[k] = vals.sum() if k in SUMMED_METRICS else vals.mean()
    return out


@torch.no_grad()
def consensus_zsum(
    params: list[GaussianParams],
    alive: list[torch.Tensor],
    slot_map: list[torch.Tensor],
    n_global: int,
) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """z[g] = sum_k alive_k(g) x_k[g] / count(g), the visibility-weighted
    average of the raw parameters (master:538-555), and the (G,) counts, on
    block 0's device. Block k's alive rows land on their global rows (unique
    within the block; private and padded slots on row G, dropped); the
    blocks sum in order 0..B-1."""
    dev = alive[0].device
    counts = torch.zeros((n_global + 1,), dtype=torch.float32, device=dev)
    sums = {k: torch.zeros((n_global + 1,) + getattr(params[0], k).shape[1:], dtype=torch.float32, device=dev)
            for k in PARAM_NAMES}
    for x, al, sm in zip(params, alive, slot_map):
        rows = sm[al].to(dev, torch.int64)
        counts.index_put_((rows,), torch.ones_like(rows, dtype=torch.float32), accumulate=True)
        for k in PARAM_NAMES:
            sums[k].index_put_((rows,), getattr(x, k)[al].to(dev), accumulate=True)
    denom = torch.clamp(counts, min=1.0)
    z = {k: s[:n_global] / denom[:n_global].view((-1,) + (1,) * (s.dim() - 1)) for k, s in sums.items()}
    return z, counts[:n_global]


@torch.no_grad()
def gather_z_local(z: dict[str, torch.Tensor], slot_map: torch.Tensor) -> dict[str, torch.Tensor]:
    """Global z -> one block's slots, on the block's device (master:522-535).
    Private slots (slot_map == G) read row G-1; callers mask by alive."""
    idx = torch.clamp(slot_map, max=z["xyz"].shape[0] - 1).to(torch.int64)
    return {k: a.to(slot_map.device)[idx] for k, a in z.items()}


@torch.no_grad()
def dual_update(
    u: dict[str, torch.Tensor],
    x: GaussianParams,
    z_local: dict[str, torch.Tensor],
    alive: torch.Tensor,
    over_relaxation_coeff: float,
) -> dict[str, torch.Tensor]:
    """u += (1 + alpha)(x - z) on alive slots (slave:99-121)."""
    f = 1.0 + over_relaxation_coeff
    out = {}
    for k in PARAM_NAMES:
        x_p = getattr(x, k)
        mask = alive.view((-1,) + (1,) * (x_p.dim() - 1))
        out[k] = torch.where(mask, u[k] + f * (x_p - z_local[k]), u[k])
    return out


def _mse_alive(a: torch.Tensor, b: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    n_alive = torch.clamp(alive.sum(dtype=torch.float32), min=1.0)
    mask = alive.view((-1,) + (1,) * (a.dim() - 1))
    return torch.where(mask, (a - b) ** 2, 0.0).sum() / (n_alive * float(np.prod(a.shape[1:])))


@torch.no_grad()
def block_residuals(
    x: list[GaussianParams],
    z_local_new: list[dict[str, torch.Tensor]],
    z_local_old: list[dict[str, torch.Tensor]],
    alive: list[torch.Tensor],
    rho: dict[str, torch.Tensor],
) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """(primal, dual) per parameter, 0-d float32 on block 0's device.

    primal_p = sum_k mean_alive((z - x_k)^2)    (master:399-433)
    dual_p   = mean_k rho_p mean_alive((z_new - z_old)^2)  (master:438-456;
    averaged over blocks, whose z slices repeat the shared rows)."""
    dev = alive[0].device
    primal, dual = {}, {}
    for k in PARAM_NAMES:
        p = d = torch.zeros((), dtype=torch.float32, device=dev)
        for xb, zn, zo, al in zip(x, z_local_new, z_local_old, alive):
            p = p + _mse_alive(getattr(xb, k), zn[k], al).to(dev)
            d = d + (rho[k].to(al.device) * _mse_alive(zn[k], zo[k], al)).to(dev)
        primal[k], dual[k] = p, d / float(len(alive))
    return primal, dual


def consensus_round(
    blocks: list[AdmmBlockState],
    n_global: int,
    rho: dict[str, torch.Tensor],
    cfg: AdmmConfig,
):
    """One consensus round (master:665-728 steps 3-6, dogs_tpu's
    make_consensus_step): the z average, the dual update and the residuals.
    Returns (new u per block, new z_local per block, z, counts, primal,
    dual); the caller stores the first two."""
    params = [b.train.model.params for b in blocks]
    alive = [b.train.model.alive for b in blocks]
    z, counts = consensus_zsum(params, alive, [b.slot_map for b in blocks], n_global)
    z_new = [gather_z_local(z, b.slot_map) for b in blocks]
    new_u = [dual_update(b.u, x, zl, al, cfg.over_relaxation_coeff)
             for b, x, zl, al in zip(blocks, params, z_new, alive)]
    primal, dual = block_residuals(params, z_new, [b.z_local for b in blocks], alive, rho)
    return new_u, z_new, z, counts, primal, dual


def adapt_rho(
    rho: dict[str, np.float32],
    primal: dict[str, np.float32],
    dual: dict[str, np.float32],
    cfg: AdmmConfig,
) -> dict[str, np.float32]:
    """Residual balancing (master:336-377), on the host in float32 as
    dogs_tpu computes it: rho x tau_inc where primal > mu dual, rho / tau_dec
    where dual > mu primal, else unchanged."""
    f32 = np.float32
    out = {}
    for k in rho:
        r, p, d = f32(rho[k]), f32(primal[k]), f32(dual[k])
        if p > f32(cfg.mu) * d:
            r = r * f32(cfg.tau_inc)
        elif d > f32(cfg.mu) * p:
            r = r / f32(cfg.tau_dec)
        out[k] = f32(r)
    return out
