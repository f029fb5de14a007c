"""Tile binning: duplicate Gaussians into per-tile depth-sorted lists.

Port of dogs_tpu/raster/binning.py with exact-size ragged storage, as the
original CUDA binning (rasterizer_impl.cu:120-232) does: per-Gaussian
candidate counts -> prefix sum -> one candidate per (Gaussian, tile) ->
per-tile max-alpha cull -> compaction -> one stable sort of packed int32
(tile, depth) keys -> tile starts.

Render semantics kept from the JAX package: the 3-sigma tile rect, the
centred clamp of that rect to `max_tiles_per_gaussian`, the exact per-tile
max-alpha cull, and the key packing. What existed there only because XLA
needs static shapes is gone: the sentinel tail, `bin_capacity` and the
two-tier overflow pool. So nothing is ever dropped past the rect clamp, and
`sorted_idx` holds exactly `num_valid` entries. The host waits for the
device three times, each a `dogs.sync.bin_*` span (utils/trace.py): for the
expansion's size, the cull's compaction and the truncated count.
"""

from __future__ import annotations

import dataclasses

import torch

from dogs_tpu_torch.raster.projection import ALPHA_MIN, ProjectedGaussians
from dogs_tpu_torch.utils import trace


@dataclasses.dataclass
class TileBins:
    """Sorted splat lists per tile; K = num_valid entries, no padding."""

    sorted_idx: torch.Tensor  # (K,) int32 gaussian index per entry
    sorted_tile: torch.Tensor  # (K,) int32 tile id per entry
    tile_starts: torch.Tensor  # (n_tiles + 1,) int32 range offsets
    # (K,) int64 the key sort's permutation: sorted position -> position in
    # the Gaussian-major expansion (each Gaussian's tiles ascending), which
    # the K -> N gradient reduce inverts (raster/reduce.py:gaussian_runs).
    order: torch.Tensor
    num_valid: int  # K: (gaussian, tile) entries kept (telemetry)
    num_truncated: int  # gaussians whose rect exceeded the budget (telemetry)


def _tile_rect(means2d, radius, n_tiles_x: int, n_tiles_y: int, tile_size: int):
    """Per-Gaussian touched tile rectangle [tx0, tx1) x [ty0, ty1)."""
    x, y = means2d[:, 0], means2d[:, 1]

    def edge(v, n):
        return torch.clamp(v, 0, n).to(torch.int32)

    tx0 = edge(torch.floor((x - radius) / tile_size), n_tiles_x)
    ty0 = edge(torch.floor((y - radius) / tile_size), n_tiles_y)
    tx1 = edge(torch.floor((x + radius) / tile_size) + 1, n_tiles_x)
    ty1 = edge(torch.floor((y + radius) / tile_size) + 1, n_tiles_y)
    return tx0, ty0, tx1, ty1


def _cull(tix, tiy, mux, muy, a, b, c, opa, tile_size: int):
    """Exact per-tile max-alpha test over the tile's pixel centres (the
    convex quadratic's minimum over the centre rect: 0 inside, else the
    best of four closed-form edge minima). Keeps a candidate iff its best
    alpha in the tile reaches ALPHA_MIN. Same arithmetic as dogs_tpu."""
    px0 = tix.to(torch.float32) * tile_size
    py0 = tiy.to(torch.float32) * tile_size
    dxl = px0 + 0.5 - mux
    dxu = px0 + (tile_size - 0.5) - mux
    dyl = py0 + 0.5 - muy
    dyu = py0 + (tile_size - 0.5) - muy
    ae = torch.clamp(a, min=1e-12)
    ce = torch.clamp(c, min=1e-12)

    def q(dx, dy):
        return 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy

    def edge_x(d):  # dx pinned to an edge, minimize the 1-D quadratic
        return q(d, torch.minimum(torch.maximum(-b * d / ce, dyl), dyu))

    def edge_y(d):
        return q(torch.minimum(torch.maximum(-b * d / ae, dxl), dxu), d)

    qmin = torch.minimum(
        torch.minimum(edge_x(dxl), edge_x(dxu)),
        torch.minimum(edge_y(dyl), edge_y(dyu)),
    )
    inside = (dxl <= 0.0) & (dxu >= 0.0) & (dyl <= 0.0) & (dyu >= 0.0)
    qmin = torch.where(inside, torch.zeros_like(qmin), torch.clamp(qmin, min=0.0))
    return opa * torch.exp(-qmin) >= ALPHA_MIN


def depth_bits_for(n_tiles: int) -> int:
    """Bits of the positive-float depth pattern kept below the tile id."""
    depth_bits = max(30 - max(n_tiles.bit_length(), 1), 8)
    if (n_tiles << depth_bits) >= 2**31:
        raise ValueError(f"{n_tiles} tiles do not fit a packed int32 key")
    return depth_bits


def build_tile_bins(
    proj: ProjectedGaussians,
    height: int,
    width: int,
    tile_size: int = 16,
    max_tiles_per_gaussian: int = 25,
    tile_culling: bool = True,
) -> TileBins:
    """Bin projected Gaussians into per-tile depth-ordered index lists."""
    n_tiles_x = -(-width // tile_size)
    n_tiles_y = -(-height // tile_size)
    n_tiles = n_tiles_x * n_tiles_y
    mt = max_tiles_per_gaussian
    device = proj.means2d.device
    visible = proj.radius > 0.0

    tx0, ty0, tx1, ty1 = _tile_rect(proj.means2d, proj.radius, n_tiles_x, n_tiles_y, tile_size)
    rect_w = tx1 - tx0
    rect_h = ty1 - ty0
    truncated = visible & ((rect_w * rect_h) > mt)

    # Clamp the rect to the key budget, keeping it centred on the Gaussian:
    # width first, then height gets the remaining rows; re-balance toward a
    # square when both axes overflow.
    one = torch.ones_like(rect_w)
    bw = torch.clamp(rect_w, max=mt)
    bh = torch.minimum(rect_h, torch.maximum(mt // torch.maximum(bw, one), one))
    side = max(int(mt**0.5), 1)
    both_over = (rect_w > side) & (rect_h > side)
    bw = torch.where(both_over, torch.clamp(rect_w, max=side), bw)
    bh = torch.where(both_over, torch.minimum(rect_h, mt // torch.maximum(bw, one)), bh)

    # Centre tile; clamp in float first so far-off-screen means cannot
    # overflow the int conversion (truncation toward zero, as astype does).
    ctx = torch.clamp(
        torch.clamp(proj.means2d[:, 0] / tile_size, -1.0, float(n_tiles_x)).to(torch.int32),
        0, n_tiles_x - 1,
    )
    cty = torch.clamp(
        torch.clamp(proj.means2d[:, 1] / tile_size, -1.0, float(n_tiles_y)).to(torch.int32),
        0, n_tiles_y - 1,
    )
    sx0 = torch.minimum(torch.maximum(ctx - bw // 2, tx0), torch.maximum(tx1 - bw, tx0))
    sy0 = torch.minimum(torch.maximum(cty - bh // 2, ty0), torch.maximum(ty1 - bh, ty0))

    # Ragged candidate expansion: Gaussian g owns counts[g] consecutive slots.
    counts = torch.where(visible, bw * bh, torch.zeros_like(bw)).to(torch.int64)
    # The expansion's size, read once: without it repeat_interleave reads
    # the size and checks the counts' signs, two syncs.
    with trace.readback("bin_expand"):
        total = int(counts.sum())
    gid = torch.repeat_interleave(torch.arange(counts.shape[0], device=device), counts, output_size=total)
    first = torch.cumsum(counts, 0) - counts
    j = torch.arange(gid.shape[0], device=device) - first[gid]
    bwg = torch.clamp(bw, min=1).to(torch.int64)[gid]
    jy = j // bwg
    tix = sx0[gid] + (j - jy * bwg)
    tiy = sy0[gid] + jy
    # Three (candidates,) int64 temporaries freed before the cull, whose own
    # temporaries set the render's peak memory.
    del first, j, bwg, jy
    if tile_culling:
        keep = _cull(
            tix, tiy, proj.means2d[gid, 0], proj.means2d[gid, 1],
            proj.conic[gid, 0], proj.conic[gid, 1], proj.conic[gid, 2],
            proj.opacity[gid], tile_size,
        )
        with trace.readback("bin_cull"):
            kept = torch.nonzero(keep).squeeze(1)
        gid, tix, tiy = gid[kept], tix[kept], tiy[kept]

    # Packed key: tile in the top bits, the top `depth_bits` of the positive
    # f32 depth pattern below (positive float bits order like ints).
    depth_bits = depth_bits_for(n_tiles)
    dq = torch.clamp(proj.depth, min=1e-12).view(torch.int32) >> (31 - depth_bits)
    tile = (tiy * n_tiles_x + tix).to(torch.int32)
    key = (tile << depth_bits) | dq[gid]
    # Stable: a Gaussian's entries keep their expansion order (its tiles
    # ascending) among equal keys, which the gradient reduce relies on.
    sorted_key, order = torch.sort(key, stable=True)
    sorted_idx = gid[order].to(torch.int32)
    sorted_tile = sorted_key >> depth_bits
    tile_starts = torch.searchsorted(
        sorted_tile, torch.arange(n_tiles + 1, dtype=torch.int32, device=device), side="left"
    ).to(torch.int32)
    with trace.readback("bin_truncated"):
        num_truncated = int(truncated.sum())
    return TileBins(
        sorted_idx=sorted_idx,
        sorted_tile=sorted_tile,
        tile_starts=tile_starts,
        order=order,
        num_valid=int(sorted_idx.shape[0]),
        num_truncated=num_truncated,
    )


def bins_membership(bins: TileBins, n_gaussians: int) -> torch.Tensor:
    """(n_tiles, N) bool: which Gaussians were binned to each tile. Lets the
    dense oracle (raster/reference.py, `tile_membership`) give each Gaussian
    exactly the tiles the tiled path blends it in."""
    n_tiles = bins.tile_starts.shape[0] - 1
    member = torch.zeros((n_tiles, n_gaussians), dtype=torch.bool, device=bins.sorted_idx.device)
    member[bins.sorted_tile.long(), bins.sorted_idx.long()] = True
    return member
