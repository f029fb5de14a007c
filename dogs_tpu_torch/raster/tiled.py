"""Tiled rasterizer, forward (render) path.

Port of dogs_tpu/raster/tiled.py:render_tiled: project -> bin -> build the
N-space entry matrix -> gather it to sorted order -> blend -> composite the
background -> untile and crop. The blend is the hand-written Hopper kernel
(raster/blend.py) for CUDA tensors and its plain PyTorch version for CPU
tensors. There is no fallback between them: a kernel that fails to build or
launch raises. The backward pass comes with the training slice.
"""

from __future__ import annotations

import dataclasses

import torch

from dogs_tpu_torch.core.camera import Camera
from dogs_tpu_torch.core.gaussians import GaussianParams
from dogs_tpu_torch.raster import blend
from dogs_tpu_torch.raster.binning import TileBins, build_tile_bins
from dogs_tpu_torch.raster.projection import ProjectedGaussians, project_gaussians


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Rasterizer knobs with a render meaning.

    The TPU schedule fields of dogs_tpu's RasterConfig are not carried:
    tile_batch, chunk, pallas_chunk, pallas_tiles_per_program, pallas_stream
    (the Hopper kernel has one schedule), bin_capacity, base_tiles and
    overflow_capacity (binning here is exact-size), and reduce_dtype (a
    backward-pass setting). `use_kernel` replaces `use_pallas`.
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


@dataclasses.dataclass
class RenderOutput:
    image: torch.Tensor  # (H, W, 3)
    alpha: torch.Tensor  # (H, W) accumulated opacity
    invdepth: torch.Tensor  # (H, W) expected inverse depth
    radii: torch.Tensor  # (C,) screen radii; 0 = culled
    bin_valid: int  # (gaussian, tile) entries blended
    bin_rect_truncated: int  # gaussians whose tile rect was clamped
    bin_dropped: int = 0  # ragged binning drops nothing past the clamp


def sorted_entries(
    proj: ProjectedGaussians, bins: TileBins, invd_offset: torch.Tensor | None = None
) -> torch.Tensor:
    """The blend's (K, 16) entry matrix: per-Gaussian columns (blend.ENT_*)
    built in N-space, then gathered once into sorted order."""
    visible = proj.radius > 0.0
    zero = torch.zeros((), device=proj.depth.device)
    opacity = torch.where(visible, proj.opacity, zero)
    dsafe = torch.where(visible, proj.depth, torch.ones_like(zero))
    invd = torch.where(visible, 1.0 / dsafe, zero)
    if invd_offset is not None:
        invd = invd + invd_offset
    ent_n = torch.cat(
        [
            proj.means2d,
            proj.conic,
            proj.color,
            opacity[:, None],
            invd[:, None],
            dsafe[:, None],
            torch.zeros((dsafe.shape[0], blend.ENT_WIDTH - 11), device=dsafe.device),
        ],
        dim=1,
    )
    return ent_n[bins.sorted_idx].contiguous()


@torch.no_grad()
def render_tiled(
    params: GaussianParams,
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
    """Render one camera. Arguments as dogs_tpu's render_tiled."""
    h, w = camera.height, camera.width
    ts = cfg.tile_size
    n_tiles_y = -(-h // ts)
    n_tiles_x = -(-w // ts)
    n_tiles = n_tiles_y * n_tiles_x
    device = params.xyz.device
    if background is None:
        background = torch.zeros((3,), dtype=torch.float32, device=device)

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
    bins = build_tile_bins(
        proj, h, w,
        tile_size=ts,
        max_tiles_per_gaussian=cfg.max_tiles_per_gaussian,
        tile_culling=cfg.tile_culling,
    )
    ent = sorted_entries(proj, bins, invd_offset)
    args = (ent, bins.tile_starts, n_tiles_y, n_tiles_x, w, h)
    if ent.is_cuda and cfg.use_kernel:
        if ts != blend.TILE:
            raise ValueError(f"the blend kernel is built for {blend.TILE}px tiles, not {ts}")
        out = blend.blend_forward(*args)
    else:
        out = blend.blend_forward_reference(*args, tile_size=ts)
    # out: (T, 5, P) rows R, G, B, A, invD.
    tot_c = out[:, 0:3, :].transpose(1, 2)  # (T, P, 3)
    aa = out[:, 3, :]
    img = tot_c + (1.0 - aa)[..., None] * background

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
        invdepth=untile(out[:, 4, :])[..., 0],
        radii=proj.radius,
        bin_valid=bins.num_valid,
        bin_rect_truncated=bins.num_truncated,
    )
