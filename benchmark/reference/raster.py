"""Plain PyTorch 3DGS rasterizer: the benchmark's reference render.

It computes the render that dogs_tpu_torch defines, written here without
importing the program: 3DGS projection (EWA with the 0.3 px low-pass, the
3-sigma radius, SH up to degree 3), tiles of 16 px, the tile rectangle
clamped to `max_tiles` around the Gaussian's centre, the exact per-tile
alpha cull, one stable sort of the packed (tile, quantized depth) key, and
the front-to-back blend with alpha clamped to 0.99, entries under 1/255
skipped and a pixel stopped once its transmittance would fall below 1e-4.
The quantized depth key and the rectangle clamp are the program's render
semantics (dogs_tpu's), so they are kept; the cull changes no pixel.

The gradient is autograd's, through a blend recomputed tile batch by tile
batch (`blend_vjp`), not a hand-derived backward. Everything runs in the
dtype of the inputs (float32 for the comparison, bfloat16 for the control).
"""

from __future__ import annotations

import math

import torch

TILE = 16
LOW_PASS = 0.3
NEAR = 0.2
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
LOG_T_MIN = math.log(1e-4)
TILE_BATCH = 512  # tiles a step of the blend without a graph
VJP_TILE_BATCH = 128  # tiles a step of the blend under autograd (its graph is held until the batch's VJP)
CHUNK = 32

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005, -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154,
         -0.4570457994644658, 1.445305721320277, -0.5900435899266435)


class View:
    """A pinhole camera: x_cam = R x + t, +z forward, y down, pixels
    (fx, fy, cx, cy), an image of width x height."""

    def __init__(self, R, t, fx, fy, cx, cy, width, height):
        self.R, self.t = R, t
        self.fx, self.fy, self.cx, self.cy = float(fx), float(fy), float(cx), float(cy)
        self.width, self.height = int(width), int(height)

    @property
    def center(self):
        return -(self.R * self.t[:, None]).sum(dim=0)


def sh_color(deg: int, sh: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Real SH of degree <= 3 at unit directions d (N, 3); sh (N, K, 3)."""
    out = SH_C0 * sh[:, 0]
    if deg == 0:
        return out
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    out = out - SH_C1 * y * sh[:, 1] + SH_C1 * z * sh[:, 2] - SH_C1 * x * sh[:, 3]
    if deg == 1:
        return out
    xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
    out = (out + SH_C2[0] * xy * sh[:, 4] + SH_C2[1] * yz * sh[:, 5] + SH_C2[2] * (2 * zz - xx - yy) * sh[:, 6]
           + SH_C2[3] * xz * sh[:, 7] + SH_C2[4] * (xx - yy) * sh[:, 8])
    if deg == 2:
        return out
    return (out + SH_C3[0] * y * (3 * xx - yy) * sh[:, 9] + SH_C3[1] * xy * z * sh[:, 10]
            + SH_C3[2] * y * (4 * zz - xx - yy) * sh[:, 11] + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[:, 12]
            + SH_C3[4] * x * (4 * zz - xx - yy) * sh[:, 13] + SH_C3[5] * z * (xx - yy) * sh[:, 14]
            + SH_C3[6] * x * (xx - 3 * yy) * sh[:, 15])


def rotation(quat: torch.Tensor) -> torch.Tensor:
    """(N, 4) wxyz, normalized here -> (N, 3, 3)."""
    q = quat / torch.clamp(torch.linalg.vector_norm(quat, dim=-1, keepdim=True), min=1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def project(g: dict, view: View, sh_degree: int, alive: torch.Tensor | None = None,
            colors: torch.Tensor | None = None, offset2d: torch.Tensor | None = None) -> dict:
    """Screen-space Gaussians. `g` holds xyz (N, 3), log_scale (N, 3), quat
    (N, 4), logit_opacity (N, 1) and, without `colors`, feat (N, K, 3).
    Returns mean (N, 2), conic (N, 3) as (a, b, c) of the inverse 2-D
    covariance, color (N, 3), opacity (N,), depth (N,), radius (N,)
    (0 = not drawn). Products are written out, so no TF32 setting applies."""
    xyz, R = g["xyz"], view.R
    p = (xyz[:, 0:1] * R[:, 0] + xyz[:, 1:2] * R[:, 1] + xyz[:, 2:3] * R[:, 2] + view.t)
    z = p[:, 2]
    front = z > NEAR
    zs = torch.where(front, z, torch.ones_like(z))
    mean = torch.stack([view.fx * p[:, 0] / zs + view.cx, view.fy * p[:, 1] / zs + view.cy], -1)
    if offset2d is not None:
        mean = mean + offset2d
    M = rotation(g["quat"]) * torch.exp(g["log_scale"])[:, None, :]  # R S
    sigma = (M[:, :, None, :] * M[:, None, :, :]).sum(-1)  # R S S^T R^T
    ps = torch.where(front[:, None], p, torch.ones_like(p))
    lx, ly = 1.3 * 0.5 * view.width / view.fx, 1.3 * 0.5 * view.height / view.fy
    tx = torch.clamp(ps[:, 0] / ps[:, 2], -lx, lx)
    ty = torch.clamp(ps[:, 1] / ps[:, 2], -ly, ly)
    iz = 1.0 / ps[:, 2]
    zero = torch.zeros_like(iz)
    J = torch.stack([torch.stack([view.fx * iz, zero, -view.fx * tx * iz], -1),
                     torch.stack([zero, view.fy * iz, -view.fy * ty * iz], -1)], -2)  # (N, 2, 3)
    T = (J[:, :, :, None] * R[None, None, :, :]).sum(2)  # J W
    cov = ((T[:, :, None, :, None] * sigma[:, None, None, :, :] * T[:, None, :, None, :]).sum((-1, -2)))
    a, b, c = cov[:, 0, 0] + LOW_PASS, cov[:, 0, 1], cov[:, 1, 1] + LOW_PASS
    det = a * c - b * b
    inv = 1.0 / torch.where(det > 0, det, torch.ones_like(det))
    conic = torch.stack([c * inv, -b * inv, a * inv], -1)
    opacity = torch.sigmoid(g["logit_opacity"][:, 0])
    mid = 0.5 * (a + c)
    radius = torch.ceil(3.0 * torch.sqrt(mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))))
    drawn = front & (det > 0) & (opacity > ALPHA_MIN)
    if alive is not None:
        drawn = drawn & alive
    radius = torch.where(drawn, radius, torch.zeros_like(radius)).detach()
    if colors is None:
        d = xyz - view.center
        d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-12)
        colors = sh_color(sh_degree, g["feat"], d) + 0.5
    color = torch.clamp(colors, min=0.0)
    return dict(mean=mean, conic=conic, color=color, opacity=opacity, depth=z, radius=radius)


def tile_lists(proj: dict, width: int, height: int, max_tiles: int) -> tuple:
    """The sorted (Gaussian, tile) entries: (gid (K,) int64, tile_starts
    (n_tiles + 1,) int64, n_tiles_x, n_tiles_y), ordered by tile, then by
    the top bits of the depth's float pattern, then by Gaussian id."""
    mean, radius = proj["mean"].detach().float(), proj["radius"].float()
    conic, opa, depth = proj["conic"].detach().float(), proj["opacity"].detach().float(), proj["depth"].detach()
    ntx, nty = -(-width // TILE), -(-height // TILE)
    n_tiles = ntx * nty
    dev = mean.device
    vis = radius > 0

    def edge(v, n):
        return torch.clamp(v, 0, n).long()

    x, y = mean[:, 0], mean[:, 1]
    tx0, tx1 = edge(torch.floor((x - radius) / TILE), ntx), edge(torch.floor((x + radius) / TILE) + 1, ntx)
    ty0, ty1 = edge(torch.floor((y - radius) / TILE), nty), edge(torch.floor((y + radius) / TILE) + 1, nty)
    rw, rh = tx1 - tx0, ty1 - ty0
    one = torch.ones_like(rw)
    bw = torch.clamp(rw, max=max_tiles)
    bh = torch.minimum(rh, torch.maximum(max_tiles // torch.maximum(bw, one), one))
    side = max(int(max_tiles ** 0.5), 1)
    both = (rw > side) & (rh > side)
    bw = torch.where(both, torch.clamp(rw, max=side), bw)
    bh = torch.where(both, torch.minimum(rh, max_tiles // torch.maximum(bw, one)), bh)
    cx = torch.clamp(torch.clamp(x / TILE, -1.0, float(ntx)).to(torch.int32).long(), 0, ntx - 1)
    cy = torch.clamp(torch.clamp(y / TILE, -1.0, float(nty)).to(torch.int32).long(), 0, nty - 1)
    sx = torch.minimum(torch.maximum(cx - bw // 2, tx0), torch.maximum(tx1 - bw, tx0))
    sy = torch.minimum(torch.maximum(cy - bh // 2, ty0), torch.maximum(ty1 - bh, ty0))

    count = torch.where(vis, bw * bh, torch.zeros_like(bw))
    gid = torch.repeat_interleave(torch.arange(count.shape[0], device=dev), count)
    j = torch.arange(gid.shape[0], device=dev) - (torch.cumsum(count, 0) - count)[gid]
    w = torch.clamp(bw, min=1)[gid]
    tix, tiy = sx[gid] + j % w, sy[gid] + j // w
    # Exact cull: the best alpha of the entry over the tile's pixel centres.
    dxl = tix.float() * TILE + 0.5 - x[gid]
    dxu = dxl + (TILE - 1)
    dyl = tiy.float() * TILE + 0.5 - y[gid]
    dyu = dyl + (TILE - 1)
    a, b, c = conic[gid, 0], conic[gid, 1], conic[gid, 2]
    ae, ce = torch.clamp(a, min=1e-12), torch.clamp(c, min=1e-12)

    def q(dx, dy):
        return 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy

    qmin = torch.minimum(
        torch.minimum(q(dxl, torch.minimum(torch.maximum(-b * dxl / ce, dyl), dyu)),
                      q(dxu, torch.minimum(torch.maximum(-b * dxu / ce, dyl), dyu))),
        torch.minimum(q(torch.minimum(torch.maximum(-b * dyl / ae, dxl), dxu), dyl),
                      q(torch.minimum(torch.maximum(-b * dyu / ae, dxl), dxu), dyu)))
    inside = (dxl <= 0) & (dxu >= 0) & (dyl <= 0) & (dyu >= 0)
    qmin = torch.where(inside, torch.zeros_like(qmin), torch.clamp(qmin, min=0.0))
    keep = opa[gid] * torch.exp(-qmin) >= ALPHA_MIN
    gid, tile = gid[keep], (tiy * ntx + tix)[keep]

    depth_bits = max(30 - max(n_tiles.bit_length(), 1), 8)
    dq = (torch.clamp(depth.float(), min=1e-12).view(torch.int32) >> (31 - depth_bits)).long()
    key = (tile << depth_bits) | dq[gid]
    key, order = torch.sort(key, stable=True)
    gid = gid[order]
    starts = torch.searchsorted(key >> depth_bits, torch.arange(n_tiles + 1, device=dev), side="left")
    return gid, starts, ntx, nty


def _batches(starts, ntx, nty, width, height, dtype, batch):
    """Per batch of `batch` tiles: tiles, entry ranges, longest range,
    pixel centres (B, P) and the starting log T (-inf past the image)."""
    dev = starts.device
    lane = torch.arange(TILE * TILE, device=dev)
    n_tiles = ntx * nty
    for b0 in range(0, n_tiles, batch):
        tiles = torch.arange(b0, min(b0 + batch, n_tiles), device=dev)
        s0, s1 = starts[tiles], starts[tiles + 1]
        longest = int((s1 - s0).max())
        if longest == 0:
            continue
        ix = (tiles % ntx)[:, None] * TILE + lane % TILE
        iy = (tiles // ntx)[:, None] * TILE + lane // TILE
        inside = (ix < width) & (iy < height)
        log_t = torch.where(inside, 0.0, -math.inf).to(dtype)
        yield tiles, s0, s1, longest, (ix + 0.5).to(dtype), (iy + 0.5).to(dtype), log_t


def _blend_batch(rows_of, s0, s1, longest, px, py, log_t, n_cols: int):
    """Front-to-back blend of one tile batch. `rows_of(pos)` gives the
    entry rows (B, CH, 9 + ...) at entry positions pos (B, CH): mean x, y,
    conic a, b, c, colour (n_cols), opacity. Returns (acc (B, n_cols, P),
    alpha (B, P), visited (B, P) entries each pixel visited, contributing
    pairs)."""
    dev = px.device
    b = px.shape[0]
    ar = torch.arange(CHUNK, device=dev)
    acc = torch.zeros((b, n_cols, px.shape[1]), dtype=px.dtype, device=dev)
    acc_a = torch.zeros_like(px)
    visited = torch.zeros(px.shape, dtype=torch.int64, device=dev)
    contributing = 0
    for off in range(0, longest, CHUNK):
        if float(log_t.detach().max()) < LOG_T_MIN:
            break
        pos = s0[:, None] + off + ar
        valid = pos < s1[:, None]
        r = rows_of(torch.where(valid, pos, s0[:, None]))
        dx = px[:, None, :] - r[:, :, 0, None]
        dy = py[:, None, :] - r[:, :, 1, None]
        power = -0.5 * (r[:, :, 2, None] * dx * dx + r[:, :, 4, None] * dy * dy) - r[:, :, 3, None] * dx * dy
        alpha = torch.clamp(r[:, :, -1, None] * torch.exp(torch.clamp(power, max=0.0)), max=ALPHA_MAX)
        alpha = torch.where((alpha >= ALPHA_MIN) & valid[:, :, None], alpha, torch.zeros_like(alpha))
        lg = torch.log1p(-alpha)
        cum = torch.cumsum(lg, dim=1)
        incl = log_t[:, None, :] + cum
        on = incl >= LOG_T_MIN
        w = torch.where(on, alpha * torch.exp(incl - lg), torch.zeros_like(alpha))
        acc = acc + (w[:, :, None, :] * r[:, :, 5:5 + n_cols, None]).sum(1)
        acc_a = acc_a + w.sum(1)
        excl = incl - lg
        visited += (valid[:, :, None] & (excl.detach() >= LOG_T_MIN)).sum(1)
        contributing += int((on & (alpha > 0)).sum())
        log_t = log_t + cum[:, -1, :]
    return acc, acc_a, visited, contributing


def entry_rows(proj: dict, depth_damp: float = 0.0) -> torch.Tensor:
    """(N, 9) rows: mean x, y, conic a, b, c, colour r, g, b, opacity. With
    `depth_damp` > 0 the gradient of the mean is scaled by min(1,
    (depth / depth_damp)^2), the render's near-Gaussian damping."""
    mean = proj["mean"]
    if depth_damp > 0 and mean.requires_grad:
        damp = torch.clamp((proj["depth"].detach() / depth_damp) ** 2, max=1.0)
        mean.register_hook(lambda g: g * damp[:, None])
    opa = torch.where(proj["radius"] > 0, proj["opacity"], torch.zeros_like(proj["opacity"]))
    return torch.cat([mean, proj["conic"], proj["color"], opa[:, None]], dim=1)


def _untile(x: torch.Tensor, ntx: int, nty: int, width: int, height: int) -> torch.Tensor:
    """(n_tiles, C, P) -> (H, W, C)."""
    c = x.shape[1]
    x = x.reshape(nty, ntx, c, TILE, TILE).permute(0, 3, 1, 4, 2).reshape(nty * TILE, ntx * TILE, c)
    return x[:height, :width]


@torch.no_grad()
def blend(rows: torch.Tensor, gid, starts, ntx, nty, width, height) -> tuple:
    """Colour (H, W, 3), alpha (H, W) and the pair counts (visited,
    contributing) of the blend of `rows` (N, 9) over the tile lists."""
    n_tiles = ntx * nty
    dt = rows.dtype
    acc = torch.zeros((n_tiles, 3, TILE * TILE), dtype=dt, device=rows.device)
    alpha = torch.zeros((n_tiles, 1, TILE * TILE), dtype=dt, device=rows.device)
    visited = contributing = 0
    last = max(gid.shape[0] - 1, 0)  # an empty tile's start may be K: its rows are read, then masked
    for tiles, s0, s1, longest, px, py, log_t in _batches(starts, ntx, nty, width, height, dt, TILE_BATCH):
        c, a, v, k = _blend_batch(lambda pos: rows[gid[pos.clamp(max=last)]], s0, s1, longest, px, py, log_t, 3)
        acc[tiles], alpha[tiles, 0] = c, a
        visited += int(v.sum())
        contributing += k
    return (_untile(acc, ntx, nty, width, height), _untile(alpha, ntx, nty, width, height)[..., 0],
            visited, contributing)


def blend_vjp(rows: torch.Tensor, gid, starts, ntx, nty, width, height, d_color, d_alpha) -> torch.Tensor:
    """d rows (N, 9): the blend recomputed one tile batch at a time under
    autograd, each batch's graph freed before the next. d_color (H, W, 3)
    and d_alpha (H, W) are the cotangents of `blend`'s outputs."""
    leaf = rows.detach().requires_grad_(True)
    grad = torch.zeros_like(leaf)
    pad_h, pad_w = nty * TILE - height, ntx * TILE - width

    def tiled(x):  # (H, W, C) -> (n_tiles, C, P)
        x = torch.nn.functional.pad(x, (0, 0, 0, pad_w, 0, pad_h))
        c = x.shape[-1]
        return x.reshape(nty, TILE, ntx, TILE, c).permute(0, 2, 4, 1, 3).reshape(nty * ntx, c, TILE * TILE)

    dc, da = tiled(d_color), tiled(d_alpha[..., None])[:, 0]
    last = max(gid.shape[0] - 1, 0)
    for tiles, s0, s1, longest, px, py, log_t in _batches(starts, ntx, nty, width, height, rows.dtype,
                                                          VJP_TILE_BATCH):
        with torch.enable_grad():
            c, a, _, _ = _blend_batch(lambda pos: leaf[gid[pos.clamp(max=last)]], s0, s1, longest, px, py, log_t, 3)
            (g,) = torch.autograd.grad((c * dc[tiles]).sum() + (a * da[tiles]).sum(), leaf, allow_unused=True)
        if g is not None:
            grad += g
    return grad
