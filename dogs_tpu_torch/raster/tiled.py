"""Tiled rasterizer, differentiable.

Port of dogs_tpu/raster/tiled.py:render_tiled: project -> bin -> build the
N-space entry matrix -> blend its rows in sorted order -> composite the
background -> untile and crop. The blend is one `torch.autograd.Function`
(`_TileBlend`) that reads the N-space matrix through the sorted entry ids
(the kernels gather rows themselves; no sorted (K, 16) copy is made), and
whose backward is the blend backward plus the K -> N reduce (a segment sum
over runs read through binning's key-sort permutation; no id sort). The
blends and the segment sum are hand-written Hopper kernels
(raster/blend.py, raster/reduce.py) for CUDA tensors and their plain
PyTorch versions for CPU tensors. There is no fallback between them: a
kernel that fails to build or launch raises. Projection's gradient is torch
autograd.
"""

from __future__ import annotations

import dataclasses

import torch

from dogs_tpu_torch.core.camera import Camera
from dogs_tpu_torch.core.gaussians import GaussianParams, NeuralGaussians
from dogs_tpu_torch.raster import blend, reduce
from dogs_tpu_torch.raster.binning import build_tile_bins
from dogs_tpu_torch.raster.projection import ProjectedGaussians, project_gaussians


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Rasterizer knobs with a render meaning.

    The TPU schedule fields of dogs_tpu's RasterConfig are not carried:
    tile_batch, chunk, pallas_chunk, pallas_tiles_per_program, pallas_stream
    (the Hopper kernels have one schedule), bin_capacity, base_tiles and
    overflow_capacity (binning here is exact-size). `use_kernel` replaces
    `use_pallas`.

    `reduce_dtype` is the K -> N gradient reduce: "f32" sums the exact
    per-entry gradients; "bf16" rounds each to bf16 (round to nearest even)
    before the f32 sum, as dogs_tpu does by default. The port defaults to
    "f32": on the TPU, bf16 pair packing halved the bytes the id sort moved
    as payload, but here no id sort runs and the segment-sum kernel reads
    the f32 rows and rounds them in registers, so bf16 buys no bytes and
    only rounds.
    """

    tile_size: int = 16
    max_tiles_per_gaussian: int = 25
    antialiasing: bool = False
    tile_culling: bool = True
    depth_threshold: float = 0.0  # near-Gaussian grad damping (backward only)
    # On CUDA tensors, blend with the hand-written kernel; False blends with
    # the plain PyTorch version on the card (reference renders). CPU tensors
    # always take the plain version: the kernel has no CPU build.
    use_kernel: bool = True
    reduce_dtype: str = "f32"


@dataclasses.dataclass
class RenderOutput:
    image: torch.Tensor  # (H, W, 3)
    alpha: torch.Tensor  # (H, W) accumulated opacity
    invdepth: torch.Tensor  # (H, W) expected inverse depth
    radii: torch.Tensor  # (C,) screen radii; 0 = culled
    bin_valid: int  # (gaussian, tile) entries blended
    bin_rect_truncated: int  # gaussians whose tile rect was clamped
    bin_dropped: int = 0  # ragged binning drops nothing past the clamp


def entry_matrix(proj: ProjectedGaussians, invd_offset: torch.Tensor | None = None) -> torch.Tensor:
    """The blend's (N, 16) entry matrix in Gaussian order (blend.ENT_*
    columns), as dogs_tpu/raster/tiled.py:619-643 builds it. The depth column
    (read only by the backward's depth damping) carries no gradient, as
    there (`stop_gradient(dsafe)`); the inverse depth does."""
    visible = proj.radius > 0.0
    zero = torch.zeros((), device=proj.depth.device)
    opacity = torch.where(visible, proj.opacity, zero)
    dsafe = torch.where(visible, proj.depth, torch.ones_like(zero))
    invd = torch.where(visible, 1.0 / dsafe, zero)
    if invd_offset is not None:
        invd = invd + invd_offset
    return torch.cat(
        [
            proj.means2d,
            proj.conic,
            proj.color,
            opacity[:, None],
            invd[:, None],
            dsafe.detach()[:, None],
            torch.zeros((dsafe.shape[0], blend.ENT_WIDTH - 11), device=dsafe.device),
        ],
        dim=1,
    )


class _TileBlend(torch.autograd.Function):
    """Alpha blending over tiles with a hand-written backward: the port of
    dogs_tpu/raster/tiled.py:_blend_with_vjp_pallas.

    Inputs: the N-space entry matrix `ent_n` (N, 16) and the background (3,)
    carry gradients; `sorted_idx` (K,) int32, `starts`, binning's key-sort
    permutation `order` (K,), the tile grid and the config do not. Outputs
    (T, P, 3) background-composited colour, (T, P) alpha and (T, P) inverse
    depth.

    The blends read `ent_n` through `sorted_idx`, so the gradient comes back
    per sorted entry and the K -> N reduce of the backward is the
    segment-sum kernel over runs that `order` gives (raster/reduce.py), not
    autograd's scatter-add for an index. On CUDA tensors with
    `cfg.use_kernel` the forward launches the blend forward kernel and the
    backward the blend backward and segment-sum kernels; otherwise all three
    are their plain versions. Saved for the backward: `ent_n`, `sorted_idx`,
    `starts`, `order`, the background and the (T, 5, P) forward output.
    """

    @staticmethod
    def forward(ctx, ent_n, background, sorted_idx, starts, order, grid, cfg):
        args = (ent_n, sorted_idx, starts, *grid)
        if ent_n.is_cuda and cfg.use_kernel:
            out = blend.blend_forward(*args)
        else:
            out = blend.blend_forward_reference(*args, tile_size=cfg.tile_size)
        # out: (T, 5, P) rows R, G, B, A, invD, no background.
        aa = out[:, 3]
        img = out[:, 0:3].transpose(1, 2) + (1.0 - aa)[..., None] * background
        ctx.save_for_backward(ent_n, sorted_idx, starts, order, background, out)
        ctx.grid, ctx.cfg = grid, cfg
        return img, aa, out[:, 4]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, cot_img, cot_a, cot_d):
        ent_n, sorted_idx, starts, order, background, out = ctx.saved_tensors
        cfg = ctx.cfg
        aa = out[:, 3]
        d_bg = (cot_img * (1.0 - aa)[..., None]).sum(dim=(0, 1))
        if not ctx.needs_input_grad[0]:
            return None, d_bg, None, None, None, None, None
        cot = blend.backward_cotangent(out, cot_img, cot_a, cot_d, background)
        args = (ent_n, sorted_idx, starts, cot, *ctx.grid)
        use_kernel = ent_n.is_cuda and cfg.use_kernel
        if use_kernel:
            d_ent = blend.blend_backward(*args, depth_threshold=cfg.depth_threshold)
        else:
            d_ent = blend.blend_backward_reference(
                *args, depth_threshold=cfg.depth_threshold, tile_size=cfg.tile_size
            )
        d_ent_n = reduce.reduce_entries(
            d_ent, order, sorted_idx, ent_n.shape[0], cfg.reduce_dtype, use_kernel
        )
        return d_ent_n, d_bg, None, None, None, None, None


def _detached(proj: ProjectedGaussians) -> ProjectedGaussians:
    return ProjectedGaussians(
        **{f.name: getattr(proj, f.name).detach() for f in dataclasses.fields(proj)}
    )


def render_tiled(
    params: GaussianParams | NeuralGaussians,
    camera: Camera,
    cfg: RasterConfig = RasterConfig(),
    background: torch.Tensor | None = None,
    alive: torch.Tensor | None = None,
    active_sh_degree: int = 3,
    scale_modifier: float = 1.0,
    means2d_offset: torch.Tensor | None = None,
    invd_offset: torch.Tensor | None = None,
    color_override: torch.Tensor | None = None,
) -> RenderOutput:
    """Render one camera; differentiable in the parameters, `background`,
    `means2d_offset` (the densify signal), `invd_offset` (the importance
    signal) and `color_override`; in the fields of `NeuralGaussians`
    (Scaffold-GS's decoded Gaussians) too. Arguments as dogs_tpu's
    render_tiled.
    Serving callers wrap it in `torch.no_grad()`."""
    h, w = camera.height, camera.width
    ts = cfg.tile_size
    n_tiles_y = -(-h // ts)
    n_tiles_x = -(-w // ts)
    n_tiles = n_tiles_y * n_tiles_x
    device = params.xyz.device
    if background is None:
        background = torch.zeros((3,), dtype=torch.float32, device=device)
    if device.type == "cuda" and cfg.use_kernel and ts != blend.TILE:
        raise ValueError(f"the blend kernels are built for {blend.TILE}px tiles, not {ts}")

    proj = project_gaussians(
        params,
        camera,
        alive=alive,
        active_sh_degree=active_sh_degree,
        antialiasing=cfg.antialiasing,
        scale_modifier=scale_modifier,
        means2d_offset=means2d_offset,
        color_override=color_override,
    )
    # Binning's outputs are integers: it runs on detached fields, so no
    # K-sized autograd graph is recorded for it.
    bins = build_tile_bins(
        _detached(proj), h, w,
        tile_size=ts,
        max_tiles_per_gaussian=cfg.max_tiles_per_gaussian,
        tile_culling=cfg.tile_culling,
    )
    img, aa, dd = _TileBlend.apply(
        entry_matrix(proj, invd_offset), background, bins.sorted_idx, bins.tile_starts, bins.order,
        (n_tiles_y, n_tiles_x, w, h), cfg,
    )

    def untile(x):
        if x.dim() == 2:
            x = x[..., None]
        c = x.shape[-1]
        x = x[:n_tiles].reshape(n_tiles_y, n_tiles_x, ts, ts, c)
        x = x.permute(0, 2, 1, 3, 4).reshape(n_tiles_y * ts, n_tiles_x * ts, c)
        return x[:h, :w]

    return RenderOutput(
        image=untile(img),
        alpha=untile(aa)[..., 0],
        invdepth=untile(dd)[..., 0],
        radii=proj.radius,
        bin_valid=bins.num_valid,
        bin_rect_truncated=bins.num_truncated,
    )
