"""Tile alpha-blend, forward and backward: the Hopper kernels and their plain
PyTorch versions.

Port of dogs_tpu/raster/pallas_stream.py:blend_forward_stream and
:blend_backward_stream (and of the per-tile pallas_blend.py twins, same
contracts). The kernels (csrc/blend_forward.cu, csrc/blend_backward.cu) run
one CTA per 16x16 tile and read the entry rows straight from the N-space
matrix through `sorted_idx`; their headers say what they compute and what
bounds them. The `*_reference` functions compute the same things the way the
XLA path of dogs_tpu/raster/tiled.py does (tile batches, chunked log-space
cumsum, batch early exit), vectorized in torch.

Contracts:
  ent_n       (N, 16) f32 entry matrix in Gaussian order (ENT_* columns)
  sorted_idx  (K,) int32 row of `ent_n` for each entry, in sorted (tile,
              depth) order; values in [0, N)
  starts      (n_tiles + 1,) int32 tile ranges into the K entries
  forward  -> (n_tiles, 5, 256) f32: rows R, G, B, A, invD per pixel of each
              tile, no background; empty tiles and pixels past width/height are 0.
  cot         (n_tiles, 8, 256) f32 backward input: rows gC r, g, b,
              gA_eff = cot_a - bg . cot_img, gD, Gtot = gC.C + gA_eff A + gD D
              (the forward totals enter here), 0, 0
  backward -> (K, 16) f32 per-entry gradients in sorted order: columns d_mux,
              d_muy, d_ca, d_cb, d_cc, d_r, d_g, d_b, d_opa, d_invd
              (dogs_tpu/raster/tiled.py:310), columns 10-15 zero; with
              depth_threshold > 0 the mean gradients are scaled by
              min(1, (depth / depth_threshold)^2).

`blend_forward` / `blend_backward` launch the kernels and accept CUDA tensors
only; `render_tiled` takes the plain versions for CPU tensors. The kernels
build at first use (dogs_tpu_torch/kernels.py).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from dogs_tpu_torch import kernels

# Entry-matrix columns (row-major (N, ENT_WIDTH)); the kernels read 0-10.
ENT_MUX, ENT_MUY, ENT_CA, ENT_CB, ENT_CC, ENT_R, ENT_G, ENT_B, ENT_OPA, ENT_INVD, ENT_DEPTH = range(11)
ENT_WIDTH = 16
N_GRADS = 10  # live gradient columns of the backward (ENT_MUX .. ENT_INVD)
OUT_ROWS = 5  # R, G, B, A, invD
COT_ROWS = 8  # gC r, g, b, gA_eff, gD, Gtot, 0, 0
TILE = 16  # the kernels' tile edge: one CTA per 16x16 tile
LOG_TMIN = math.log(1e-4)
ALPHA_MIN = 1.0 / 255.0
# Plain blend schedule: tiles per batch and entries per step. Each step holds
# a few (batch, chunk, 256) f32 arrays, ~8 MB each.
_REF_TILE_BATCH, _REF_CHUNK = 256, 32

_VP, _INT = ctypes.c_void_p, ctypes.c_int
_FWD_ARGTYPES = (_VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT, _VP)
_BWD_ARGTYPES = (_VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT, _INT, ctypes.c_float, _VP)


def _check_inputs(ent_n: torch.Tensor, sorted_idx: torch.Tensor, starts: torch.Tensor, n_tiles: int) -> None:
    if ent_n.dtype != torch.float32 or ent_n.dim() != 2 or ent_n.shape[1] != ENT_WIDTH:
        raise ValueError(f"ent_n must be (N, {ENT_WIDTH}) float32, got {tuple(ent_n.shape)} {ent_n.dtype}")
    if sorted_idx.dtype != torch.int32 or sorted_idx.dim() != 1:
        raise ValueError(f"sorted_idx must be (K,) int32, got {tuple(sorted_idx.shape)} {sorted_idx.dtype}")
    if starts.dtype != torch.int32 or tuple(starts.shape) != (n_tiles + 1,):
        raise ValueError(
            f"starts must be ({n_tiles + 1},) int32, got {tuple(starts.shape)} {starts.dtype}"
        )
    if not (ent_n.is_contiguous() and sorted_idx.is_contiguous() and starts.is_contiguous()):
        raise ValueError("ent_n, sorted_idx and starts must be contiguous")


def _check_cot(cot: torch.Tensor, n_tiles: int, tile_size: int = TILE) -> None:
    shape = (n_tiles, COT_ROWS, tile_size * tile_size)
    if cot.dtype != torch.float32 or tuple(cot.shape) != shape:
        raise ValueError(f"cot must be {shape} float32, got {tuple(cot.shape)} {cot.dtype}")
    if not cot.is_contiguous():
        raise ValueError("cot must be contiguous")


def _check_kernel_args(name: str, ent_n: torch.Tensor, *tensors: torch.Tensor) -> None:
    kernels.require_cuda(name, ent_n, *tensors)
    if ent_n.data_ptr() % 16:
        raise ValueError(f"{name}: ent_n must be 16-byte aligned (the kernel copies 16-byte pieces)")


def blend_forward(
    ent_n: torch.Tensor,
    sorted_idx: torch.Tensor,
    starts: torch.Tensor,
    n_tiles_y: int,
    n_tiles_x: int,
    width: int,
    height: int,
) -> torch.Tensor:
    """Launch the Hopper blend forward kernel on the current stream (no sync).

    CUDA tensors only: a CPU tensor raises, since the kernel has no CPU
    build (use `blend_forward_reference` there). `starts` must be
    nondecreasing with starts[-1] <= K and `sorted_idx` in [0, N), as
    build_tile_bins makes them; that is not checked here, since reading them
    back would synchronize."""
    n_tiles = n_tiles_y * n_tiles_x
    _check_kernel_args("blend_forward", ent_n, sorted_idx, starts)
    _check_inputs(ent_n, sorted_idx, starts, n_tiles)
    out = torch.empty((n_tiles, OUT_ROWS, TILE * TILE), dtype=torch.float32, device=ent_n.device)
    kernels.launch("blend_forward", "dogs_blend_forward", _FWD_ARGTYPES, ent_n.data_ptr(), sorted_idx.data_ptr(),
                   starts.data_ptr(), out.data_ptr(), n_tiles_x, n_tiles, width, height, device=ent_n.device)
    return out


def blend_backward(
    ent_n: torch.Tensor,
    sorted_idx: torch.Tensor,
    starts: torch.Tensor,
    cot: torch.Tensor,
    n_tiles_y: int,
    n_tiles_x: int,
    width: int,
    height: int,
    depth_threshold: float = 0.0,
) -> torch.Tensor:
    """Launch the Hopper blend backward kernel on the current stream (no sync).

    CUDA tensors only, as `blend_forward`; `blend_backward_reference` is the
    plain version. Returns d_ent (K, 16) in sorted order; the kernel writes
    every element, so it is allocated uninitialized here."""
    n_tiles = n_tiles_y * n_tiles_x
    _check_kernel_args("blend_backward", ent_n, sorted_idx, starts, cot)
    _check_inputs(ent_n, sorted_idx, starts, n_tiles)
    _check_cot(cot, n_tiles)
    k = sorted_idx.shape[0]
    d_ent = torch.empty((k, ENT_WIDTH), dtype=torch.float32, device=ent_n.device)
    kernels.launch("blend_backward", "dogs_blend_backward", _BWD_ARGTYPES, ent_n.data_ptr(), sorted_idx.data_ptr(),
                   starts.data_ptr(), cot.data_ptr(), d_ent.data_ptr(), n_tiles_x, n_tiles, k, width, height,
                   float(depth_threshold), device=ent_n.device)
    return d_ent


def backward_cotangent(
    out: torch.Tensor,
    cot_img: torch.Tensor,
    cot_a: torch.Tensor,
    cot_d: torch.Tensor,
    background: torch.Tensor,
) -> torch.Tensor:
    """The backward's (T, 8, P) `cot` from the forward output `out` (T, 5, P)
    and the cotangents of the composited image (T, P, 3), alpha (T, P) and
    inverse depth (T, P) (dogs_tpu/raster/tiled.py:434-453). The image is
    C + (1 - A) bg, so the effective alpha cotangent is cot_a - bg . cot_img;
    Gtot = gC . C + gA_eff A + gD D from the splat-only forward totals."""
    cot_rgb = cot_img.transpose(1, 2)  # (T, 3, P)
    cot_a_eff = cot_a - (cot_rgb * background[None, :, None]).sum(dim=1)
    g_tot = (cot_rgb * out[:, 0:3]).sum(dim=1) + cot_a_eff * out[:, 3] + cot_d * out[:, 4]
    return torch.cat(
        [cot_rgb, cot_a_eff[:, None], cot_d[:, None], g_tot[:, None], torch.zeros_like(cot_rgb[:, :2])],
        dim=1,
    ).contiguous()


def _tile_batches(starts, n_tiles_y, n_tiles_x, width, height, ts):
    """Yields, per batch of _REF_TILE_BATCH tiles with any entries: the tile
    ids, their entry ranges s0/s1, the longest range, the pixel centres
    (TB, P) and the initial log T (0 in the image, -inf past its edge, where
    pixels never blend)."""
    n_tiles = n_tiles_y * n_tiles_x
    device = starts.device
    lane = torch.arange(ts * ts, device=device)
    starts64 = starts.to(torch.int64)
    for b0 in range(0, n_tiles, _REF_TILE_BATCH):
        tiles = torch.arange(b0, min(b0 + _REF_TILE_BATCH, n_tiles), device=device)
        s0 = starts64[tiles]
        s1 = starts64[tiles + 1]
        max_cnt = int((s1 - s0).max())
        if max_cnt == 0:
            continue
        ix = (tiles % n_tiles_x)[:, None] * ts + lane % ts  # (TB, P)
        iy = (tiles // n_tiles_x)[:, None] * ts + lane // ts
        log_t = torch.where(
            (ix < width) & (iy < height),
            torch.zeros((), device=device),
            torch.full((), -math.inf, device=device),
        )
        yield tiles, s0, s1, max_cnt, ix.float() + 0.5, iy.float() + 0.5, log_t


def _chunk(ent_n, sorted_idx, s0, s1, off, px, py, log_t):
    """One step of _REF_CHUNK entries for every tile of a batch. Returns the
    entry positions and their validity (TB, CH), the rows (TB, CH, 16),
    gathered from `ent_n` through `sorted_idx`, and per (tile, entry, pixel):
    dx, dy, alpha, exp(min(power, 0)), log(1 - alpha), its inclusive cumsum,
    whether the entry contributes (before the stop), T before the entry, and
    the blend weight w."""
    ar = torch.arange(_REF_CHUNK, device=ent_n.device)
    pos = s0[:, None] + off + ar
    valid = pos < s1[:, None]
    rows = ent_n[sorted_idx[torch.clamp(pos, max=sorted_idx.shape[0] - 1)]]
    dx = px[:, None, :] - rows[:, :, ENT_MUX, None]
    dy = py[:, None, :] - rows[:, :, ENT_MUY, None]
    power = (
        -0.5 * (rows[:, :, ENT_CA, None] * dx * dx + rows[:, :, ENT_CC, None] * dy * dy)
        - rows[:, :, ENT_CB, None] * dx * dy
    )
    expp = torch.exp(torch.clamp(power, max=0.0))
    alpha = torch.clamp(rows[:, :, ENT_OPA, None] * expp, max=0.99)
    alpha = torch.where((alpha >= ALPHA_MIN) & valid[:, :, None], alpha, 0.0)
    lg = torch.log1p(-alpha)
    cum = torch.cumsum(lg, dim=1)
    log_t_incl = log_t[:, None, :] + cum
    contributes = log_t_incl >= LOG_TMIN
    t_excl = torch.exp(log_t_incl - lg)
    w = torch.where(contributes, alpha * t_excl, 0.0)
    return pos, valid, rows, dx, dy, alpha, expp, lg, cum, contributes, t_excl, w


def blend_forward_reference(
    ent_n: torch.Tensor,
    sorted_idx: torch.Tensor,
    starts: torch.Tensor,
    n_tiles_y: int,
    n_tiles_x: int,
    width: int,
    height: int,
    tile_size: int = TILE,
) -> torch.Tensor:
    """Plain PyTorch blend forward with the kernel's contract, on any device.

    Tiles go in batches of _REF_TILE_BATCH; each batch gathers and walks its
    entries _REF_CHUNK at a time with the inclusive log-transmittance from a
    cumsum, and stops once every pixel of the batch is saturated."""
    n_tiles = n_tiles_y * n_tiles_x
    _check_inputs(ent_n, sorted_idx, starts, n_tiles)
    p = tile_size * tile_size
    out = torch.zeros((n_tiles, OUT_ROWS, p), dtype=torch.float32, device=ent_n.device)
    if sorted_idx.shape[0] == 0:
        return out
    batches = _tile_batches(starts, n_tiles_y, n_tiles_x, width, height, tile_size)
    for tiles, s0, s1, max_cnt, px, py, log_t in batches:
        acc = torch.zeros((tiles.shape[0], OUT_ROWS, p), dtype=torch.float32, device=ent_n.device)
        for off in range(0, max_cnt, _REF_CHUNK):
            if float(log_t.max()) < LOG_TMIN:
                break  # every pixel of the batch is done
            _, _, rows, _, _, _, _, _, cum, _, _, w = _chunk(ent_n, sorted_idx, s0, s1, off, px, py, log_t)
            cols = rows[:, :, [ENT_R, ENT_G, ENT_B, ENT_INVD]]  # (TB, CH, 4)
            # Elementwise products summed over the chunk: exact f32, no TF32.
            acc[:, [0, 1, 2, 4]] += (w[:, :, None, :] * cols[:, :, :, None]).sum(dim=1)
            acc[:, 3] += w.sum(dim=1)
            log_t = log_t + cum[:, -1, :]
        out[tiles] = acc
    return out


def blend_backward_reference(
    ent_n: torch.Tensor,
    sorted_idx: torch.Tensor,
    starts: torch.Tensor,
    cot: torch.Tensor,
    n_tiles_y: int,
    n_tiles_x: int,
    width: int,
    height: int,
    depth_threshold: float = 0.0,
    tile_size: int = TILE,
) -> torch.Tensor:
    """Plain PyTorch blend backward with the kernel's contract, on any device:
    dogs_tpu/raster/tiled.py backward_batch, vectorized over a tile batch.

    Replays the forward's chunk schedule front to back; the suffix of later
    entries' G is Gtot minus the running inclusive prefix."""
    n_tiles = n_tiles_y * n_tiles_x
    _check_inputs(ent_n, sorted_idx, starts, n_tiles)
    _check_cot(cot, n_tiles, tile_size)
    d_ent = torch.zeros((sorted_idx.shape[0], ENT_WIDTH), dtype=torch.float32, device=ent_n.device)
    if sorted_idx.shape[0] == 0:
        return d_ent
    batches = _tile_batches(starts, n_tiles_y, n_tiles_x, width, height, tile_size)
    for tiles, s0, s1, max_cnt, px, py, log_t in batches:
        c = cot[tiles]  # (TB, 8, P)
        g_r, g_g, g_b, g_a, g_d, g_tot = (c[:, i, None, :] for i in range(6))
        prefix_g = torch.zeros_like(log_t)
        for off in range(0, max_cnt, _REF_CHUNK):
            if float(log_t.max()) < LOG_TMIN:
                break  # every pixel of the batch is done; its rows stay zero
            pos, valid, rows, dx, dy, alpha, expp, _, cum, contributes, t_excl, w = _chunk(
                ent_n, sorted_idx, s0, s1, off, px, py, log_t
            )
            col = [rows[:, :, i, None] for i in range(ENT_DEPTH + 1)]
            direct = col[ENT_R] * g_r + col[ENT_G] * g_g + col[ENT_B] * g_b + g_a + col[ENT_INVD] * g_d
            g_term = direct * w  # G_j per (tile, entry, pixel)
            prefix_incl = prefix_g[:, None, :] + torch.cumsum(g_term, dim=1)
            suffix = g_tot - prefix_incl
            d_alpha = torch.where(
                contributes & (alpha > 0.0) & (alpha < 0.99),
                direct * t_excl - suffix / (1.0 - alpha),
                0.0,
            )
            d_power = d_alpha * alpha
            # power = -0.5 (a dx^2 + c dy^2) - b dx dy with d = pix - mu, so
            # d(power)/d(mu_x) = a dx + b dy (sign flip through d).
            d_mux = (d_power * (col[ENT_CA] * dx + col[ENT_CB] * dy)).sum(2)
            d_muy = (d_power * (col[ENT_CC] * dy + col[ENT_CB] * dx)).sum(2)
            if depth_threshold > 0.0:
                damp = torch.clamp((rows[:, :, ENT_DEPTH] / depth_threshold) ** 2, max=1.0)
                d_mux = d_mux * damp
                d_muy = d_muy * damp
            grads = torch.stack(
                [
                    d_mux,
                    d_muy,
                    (d_power * (-0.5 * dx * dx)).sum(2),
                    (d_power * (-dx * dy)).sum(2),
                    (d_power * (-0.5 * dy * dy)).sum(2),
                    (w * g_r).sum(2),
                    (w * g_g).sum(2),
                    (w * g_b).sum(2),
                    (d_alpha * expp).sum(2),
                    (w * g_d).sum(2),
                ],
                dim=-1,
            )  # (TB, CH, 10)
            # Entry positions are unique (each entry belongs to one tile).
            d_ent[pos[valid], :N_GRADS] = grads[valid]
            prefix_g = prefix_incl[:, -1, :]
            log_t = log_t + cum[:, -1, :]
    return d_ent


@dataclasses.dataclass(frozen=True)
class BlendWork:
    """What a blend of these inputs must do, counted by the plain path."""

    visited: int  # (pixel, entry) pairs up to and including each pixel's stop
    contributing: int  # visited pairs with alpha >= 1/255 before the stop
    tile_end: torch.Tensor  # (n_tiles,) int64: rows from here on reach no pixel


def blend_work(
    ent_n: torch.Tensor,
    sorted_idx: torch.Tensor,
    starts: torch.Tensor,
    n_tiles_y: int,
    n_tiles_x: int,
    width: int,
    height: int,
    tile_size: int = TILE,
) -> BlendWork:
    """Count the blend's pairs with the plain forward's schedule: a pixel
    visits its tile's entries in order up to and including the one that
    stops it (log T below log(1e-4)), or to the tile's end; pixels past the
    image edge visit none. `tile_end[t]` is the tile's start plus its
    longest visit, so the backward's rows from there on are zero."""
    n_tiles = n_tiles_y * n_tiles_x
    _check_inputs(ent_n, sorted_idx, starts, n_tiles)
    tile_end = starts[:-1].to(torch.int64).clone()
    visited = contributing = 0
    if sorted_idx.shape[0] == 0:
        return BlendWork(0, 0, tile_end)
    batches = _tile_batches(starts, n_tiles_y, n_tiles_x, width, height, tile_size)
    for tiles, s0, s1, max_cnt, px, py, log_t in batches:
        seen = torch.zeros_like(log_t, dtype=torch.int64)  # (TB, P) entries visited
        for off in range(0, max_cnt, _REF_CHUNK):
            if float(log_t.max()) < LOG_TMIN:
                break
            _, valid, _, _, _, alpha, _, _, cum, contributes, _, _ = _chunk(
                ent_n, sorted_idx, s0, s1, off, px, py, log_t
            )
            # log T before each entry: the exclusive cumsum, shifted exactly.
            excl = log_t[:, None, :] + torch.nn.functional.pad(cum[:, :-1], (0, 0, 1, 0))
            visits = valid[:, :, None] & (excl >= LOG_TMIN)
            seen += visits.sum(dim=1)
            contributing += int((contributes & (alpha > 0.0)).sum())
            log_t = log_t + cum[:, -1, :]
        visited += int(seen.sum())
        tile_end[tiles] = s0 + seen.amax(dim=1)
    return BlendWork(visited, contributing, tile_end)
