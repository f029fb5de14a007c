"""The dense per-pixel renderer: the correctness oracle of the tiled path.

Port of dogs_tpu/raster/reference.py. It renders the blend's math with no
tiles: every Gaussian sorted by depth, every (pixel, Gaussian) alpha
evaluated, composited with an exclusive cumulative product of
transmittance and the blend's sticky early stop at T < 1e-4. O(H W N)
memory, so for small test scenes only; autograd through it gives the
reference gradients.
"""

from __future__ import annotations

import dataclasses

import torch

from dogs_tpu_torch.core.camera import Camera
from dogs_tpu_torch.core.gaussians import GaussianParams
from dogs_tpu_torch.raster.projection import gaussian_alpha, project_gaussians


@dataclasses.dataclass
class ReferenceOutput:
    image: torch.Tensor  # (H, W, 3)
    alpha: torch.Tensor  # (H, W) accumulated opacity
    invdepth: torch.Tensor  # (H, W) expected inverse depth
    radii: torch.Tensor  # (C,) screen radii; 0 = culled


def render_reference(
    params: GaussianParams,
    camera: Camera,
    background: torch.Tensor | None = None,
    alive: torch.Tensor | None = None,
    active_sh_degree: int = 3,
    antialiasing: bool = False,
    means2d_offset: torch.Tensor | None = None,
    tile_membership: torch.Tensor | None = None,
    tile_size: int = 16,
) -> ReferenceOutput:
    """`tile_membership`: optional (n_tiles, C) bool of which Gaussians were
    binned to each tile; it restricts each Gaussian to its tiles, as the
    tiled path blends only inside its tile rectangle."""
    h, w = camera.height, camera.width
    device = params.xyz.device
    if background is None:
        background = torch.zeros((3,), device=device)
    proj = project_gaussians(params, camera, alive=alive, active_sh_degree=active_sh_degree,
                             antialiasing=antialiasing, means2d_offset=means2d_offset)
    visible = proj.radius > 0.0
    order = torch.argsort(torch.where(visible, proj.depth, torch.full_like(proj.depth, float("inf"))), stable=True)
    means2d, conic, color = proj.means2d[order], proj.conic[order], proj.color[order]
    opacity = torch.where(visible, proj.opacity, 0.0)[order]
    depth = proj.depth[order]

    ys = torch.arange(h, dtype=torch.float32, device=device) + 0.5
    xs = torch.arange(w, dtype=torch.float32, device=device) + 0.5
    pix = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), dim=-1)  # (H, W, 2)
    alphas = gaussian_alpha(conic[None, None], opacity[None, None], means2d[None, None], pix[:, :, None, :])
    if tile_membership is not None:
        n_tiles_x = -(-w // tile_size)
        py = torch.arange(h, device=device) // tile_size
        px = torch.arange(w, device=device) // tile_size
        pix_tile = py[:, None] * n_tiles_x + px[None, :]
        alphas = torch.where(tile_membership[:, order][pix_tile], alphas, 0.0)
    # Exclusive transmittance as a prefix sum of log(1 - alpha).
    trans_incl = torch.exp(torch.cumsum(torch.log1p(-alphas), dim=-1))
    trans_excl = torch.cat([torch.ones_like(trans_incl[..., :1]), trans_incl[..., :-1]], dim=-1)
    # The blend stops for good once the would-be transmittance drops below 1e-4.
    contributes = torch.cumsum((trans_incl < 1e-4).to(torch.int32), dim=-1) == 0
    weight = torch.where(contributes, alphas * trans_excl, 0.0)

    image = (weight[..., None] * color).sum(dim=-2)
    acc_alpha = weight.sum(dim=-1)
    invdepth = (weight / depth).sum(dim=-1)
    image = image + (1.0 - acc_alpha)[..., None] * background
    return ReferenceOutput(image=image, alpha=acc_alpha, invdepth=invdepth, radii=proj.radius)
