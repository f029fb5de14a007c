"""Scaffold-GS: anchor-based neural Gaussians.

Port of dogs_tpu/fields/scaffold.py (the reference ScaffoldGS,
conerf/model/gaussian_fields/scaffold_gs.py and
conerf/trainers/scaffold_gs_trainer.py). Voxelized anchors carry a 32-d
feature and k learnable offsets; three small MLP heads decode per view the
opacity, colour and covariance of each anchor's k neural Gaussians, which
render with precomputed colours through the same tiled rasterizer and its
three kernels (raster/tiled.py, `color_override`, SH degree 0). The decode
returns `NeuralGaussians`, plain tensors, so the gradient of the render
flows back through the heads into the anchors.

The MLPs are dense matmuls that dogs_tpu leaves to XLA at
`Precision.HIGHEST`; here they are `torch.matmul` in exact f32: TF32 is off
for the decode and for the step's backward (`appearance.exact_f32`), set
here and not left to a caller's global flag.

Anchor dynamics as in dogs_tpu: the densify statistics accumulate inside
the step (screen-space gradient norms per neural Gaussian through the
means2d-offset trick, opacity per anchor, counts); anchor growing and
pruning run on the host in numpy every `densification_interval` steps,
exactly as dogs_tpu runs them (`np.unique`, a Python set for the dedup
against the existing anchors, `np.maximum.at`), and the anchor buffers grow
in power-of-two buckets of 256 when the free slots run out. The frustum
prefilter is dogs_tpu's analytic mask over anchors.

The host randomness is a numpy `RandomState` as in dogs_tpu: the camera
permutation and the growth keep-mask draw the same numbers in both
packages. Parameters and Adam moments are `ScaffoldParams` of tensors; the
parameter leaves require grad and are updated in place.

Checkpoints keep dogs_tpu's npz layout (`scaffold_state_arrays`,
`scaffold_state_from_arrays`; train/checkpoint.py reads them): `.params/`,
`.mu/` and `.nu/` leaves keyed as JAX flattens `ScaffoldParams`
(`.params/.anchor_xyz`, `.params/.mlp_opacity/['w0']`, ...), then `.step`,
`.alive`, `.opacity_accum`, `.anchor_denom`, `.offset_grad_accum`,
`.offset_denom`. The port also stores the RandomState's position and the
pending camera order, so that its own resume continues bit for bit; a
dogs_tpu file restores the generator at position 0, as dogs_tpu does.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Callable, Sequence

import numpy as np
import torch

from dogs_tpu_torch.core.camera import Camera
from dogs_tpu_torch.core.gaussians import NeuralGaussians, round_up_capacity
from dogs_tpu_torch.fields.appearance import exact_f32, flatten
from dogs_tpu_torch.raster.ssim import ssim
from dogs_tpu_torch.raster.tiled import RasterConfig, RenderOutput, render_tiled
from dogs_tpu_torch.train.optim import adam_step, exponential_lr
from dogs_tpu_torch.train.trainer import _as_image

logger = logging.getLogger(__name__)

FEAT_DIM = 32
HIDDEN = 64
ANCHOR_LEAVES = ("anchor_xyz", "anchor_feat", "offsets", "log_scaling")
STATS = ("opacity_accum", "anchor_denom", "offset_grad_accum", "offset_denom")
PREFILTER_MARGIN = 3.0  # the prefilter's pixel radius, in anchor offset extents


@dataclasses.dataclass
class ScaffoldParams:
    """Anchors, per-anchor offsets and the MLP heads, in dogs_tpu's field
    order (its checkpoint leaf order). Each MLP is a dict of `w{i}` (in,
    out) and `b{i}` (out,) tensors."""

    anchor_xyz: torch.Tensor  # (A, 3)
    anchor_feat: torch.Tensor  # (A, FEAT_DIM)
    offsets: torch.Tensor  # (A, K, 3) in units of the offset extent
    log_scaling: torch.Tensor  # (A, 6): [:3] offset extent, [3:] base scale
    mlp_opacity: dict
    mlp_color: dict
    mlp_cov: dict
    mlp_feat_bank: dict  # {} when use_feat_bank is off
    app_embedding: torch.Tensor  # (num_cameras, appearance_dim); (0, 0) when off

    @property
    def num_anchors(self) -> int:
        return self.anchor_xyz.shape[0]

    @property
    def k_offsets(self) -> int:
        return self.offsets.shape[1]

    @property
    def appearance_dim(self) -> int:
        return self.app_embedding.shape[1]

    def leaves(self) -> dict[str, torch.Tensor]:
        """Every tensor keyed by its dogs_tpu checkpoint path below
        `.params` (`.anchor_xyz`, `.mlp_opacity/['b0']`, ...), in JAX's
        flattening order."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, dict):
                out.update({f".{f.name}/{k}": t for k, t in flatten(v).items()})
            else:
                out[f".{f.name}"] = v
        return out

    def map(self, fn: Callable[[str, torch.Tensor], torch.Tensor]) -> "ScaffoldParams":
        """New params with `fn(field name, tensor)` applied to every tensor."""

        def m(name, v):
            return {k: m(name, x) for k, x in v.items()} if isinstance(v, dict) else fn(name, v)

        return ScaffoldParams(**{f.name: m(f.name, getattr(self, f.name)) for f in dataclasses.fields(self)})


def scaffold_params_from_numpy(arrays: dict, device: torch.device | str = "cuda",
                               requires_grad: bool = True) -> ScaffoldParams:
    """`ScaffoldParams` from numpy arrays keyed as `ScaffoldParams.leaves`
    keys them (dogs_tpu's checkpoint keys below `.params/`), as float32 on
    `device`. An MLP with no leaves is {} (the feat bank when it is off)."""
    fields = {f.name: {} for f in dataclasses.fields(ScaffoldParams)}
    for key, a in arrays.items():
        name, _, sub = key[1:].partition("/")
        t = torch.tensor(np.asarray(a, np.float32), device=device, requires_grad=requires_grad)
        if sub:
            fields[name][sub[2:-2]] = t  # "['w0']" -> "w0"
        else:
            fields[name] = t
    missing = [k for k in (*ANCHOR_LEAVES, "app_embedding") if not torch.is_tensor(fields[k])]
    if missing:
        raise KeyError(f"missing Scaffold-GS parameter arrays: {missing}")
    return ScaffoldParams(**fields)


def _mlp_init(rng: np.random.RandomState, sizes: list[int]) -> dict:
    params = {}
    for i, (cin, cout) in enumerate(zip(sizes[:-1], sizes[1:])):
        # float32 draws times a float64 scale, rounded to float32 once, as
        # jnp.asarray rounds dogs_tpu's product.
        params[f"w{i}"] = (rng.randn(cin, cout).astype(np.float32) * np.sqrt(2.0 / cin)).astype(np.float32)
        params[f"b{i}"] = np.zeros((cout,), np.float32)
    return params


def _mlp_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    n = len(p) // 2
    with exact_f32():
        for i in range(n):
            x = torch.matmul(x, p[f"w{i}"]) + p[f"b{i}"]
            if i < n - 1:
                x = torch.relu(x)
    return x


def voxelize_points(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """Unique voxel centers of a point cloud (scaffold_gs.py anchor init)."""
    q = np.floor(points / voxel_size)
    uniq = np.unique(q, axis=0)
    return (uniq + 0.5) * voxel_size


def init_scaffold_arrays(
    points: np.ndarray,
    voxel_size: float = 0.05,
    k_offsets: int = 10,
    seed: int = 0,
    capacity: int | None = None,
    use_feat_bank: bool = False,
    appearance_dim: int = 0,
    num_cameras: int = 0,
) -> tuple[dict[str, np.ndarray], np.ndarray]:
    """dogs_tpu's initial Scaffold-GS arrays, keyed as
    `ScaffoldParams.leaves`, and the anchor alive mask: anchors at the
    voxel centers padded to `capacity` (default: a power-of-two bucket of
    256), drawn from `RandomState(seed)` in dogs_tpu's order (anchor_feat,
    offsets, then w0 and w1 of the opacity, colour, covariance and feat-bank
    heads, then the appearance embedding)."""
    rng = np.random.RandomState(seed)
    anchors = voxelize_points(np.asarray(points, np.float32), voxel_size)
    a = anchors.shape[0]
    cap = capacity or round_up_capacity(a, 256)
    if cap < a:
        raise ValueError(f"capacity {cap} < {a} anchors")

    def padded(x):
        out = np.zeros((cap,) + x.shape[1:], np.float32)
        out[:a] = x
        return out

    sp = dict(
        anchor_xyz=padded(anchors),
        anchor_feat=padded(rng.randn(a, FEAT_DIM).astype(np.float32) * 0.01),
        offsets=padded(rng.uniform(-0.5, 0.5, (a, k_offsets, 3)).astype(np.float32)),
        log_scaling=np.tile(
            np.array([np.log(voxel_size)] * 3 + [np.log(voxel_size * 0.5)] * 3, np.float32)[None], (cap, 1)
        ),
        mlp_opacity=_mlp_init(rng, [FEAT_DIM + 3, HIDDEN, k_offsets]),
        mlp_color=_mlp_init(rng, [FEAT_DIM + 3 + appearance_dim, HIDDEN, 3 * k_offsets]),
        mlp_cov=_mlp_init(rng, [FEAT_DIM + 3, HIDDEN, 7 * k_offsets]),
        mlp_feat_bank=_mlp_init(rng, [4, FEAT_DIM, 3]) if use_feat_bank else {},
        app_embedding=(
            rng.randn(num_cameras, appearance_dim).astype(np.float32) * 0.01
            if appearance_dim else np.zeros((0, 0), np.float32)
        ),
    )
    arrays = {}
    for name, v in sp.items():  # ScaffoldParams' field order
        if isinstance(v, dict):
            arrays.update({f".{name}/['{k}']": v[k] for k in sorted(v)})
        else:
            arrays[f".{name}"] = v
    return arrays, np.arange(cap) < a


def init_scaffold(
    points: np.ndarray,
    voxel_size: float = 0.05,
    k_offsets: int = 10,
    seed: int = 0,
    capacity: int | None = None,
    use_feat_bank: bool = False,
    appearance_dim: int = 0,
    num_cameras: int = 0,
    device: torch.device | str = "cuda",
) -> tuple[ScaffoldParams, torch.Tensor]:
    """(params at fixed capacity on `device`, anchor alive mask):
    `init_scaffold_arrays` as tensors."""
    arrays, alive = init_scaffold_arrays(points, voxel_size, k_offsets, seed, capacity, use_feat_bank,
                                         appearance_dim, num_cameras)
    return scaffold_params_from_numpy(arrays, device), torch.as_tensor(alive, device=device)


@torch.no_grad()
def anchor_frustum_mask(sp: ScaffoldParams, camera: Camera) -> torch.Tensor:
    """dogs_tpu's `prefilter_voxel`: an analytic in-frustum test of every
    anchor, camera-space depth > 0.01 and the projected center inside the
    image grown by a conservative pixel radius from the anchor's offset
    extent. A mask, not a compaction: the rasterizer's alive mask skips the
    culled Gaussians. The camera transform is written as sums (exact f32 on
    every device, where dogs_tpu's matmul runs at HIGHEST)."""
    xyz, R = sp.anchor_xyz, camera.R
    p_cam = xyz[:, 0:1] * R[:, 0] + xyz[:, 1:2] * R[:, 1] + xyz[:, 2:3] * R[:, 2] + camera.t
    z = p_cam[:, 2]
    r_world = PREFILTER_MARGIN * torch.exp(sp.log_scaling[:, 0:3]).amax(dim=-1)
    safe_z = torch.clamp(z, min=1e-6)
    u = camera.fx * p_cam[:, 0] / safe_z + camera.cx
    v = camera.fy * p_cam[:, 1] / safe_z + camera.cy
    r_pix = camera.fx * r_world / safe_z
    return (z > 0.01) & (u > -r_pix) & (u < camera.width + r_pix) & (v > -r_pix) & (v < camera.height + r_pix)


def generate_neural_gaussians(
    sp: ScaffoldParams,
    camera: Camera,
    alive: torch.Tensor | None = None,
    visible_mask: torch.Tensor | None = None,
    with_aux: bool = False,
):
    """Per-view decode (scaffold_gs.py:271-348 generate_neural_gaussians).

    Returns (NeuralGaussians of capacity A*K, colours (A*K, 3), alive mask
    (A*K,)) [+ aux dict when with_aux], differentiable in every leaf of
    `sp`. The opacity head is tanh; neural Gaussians with opacity <= 0 are
    masked out, and dead or culled anchors mask all their K Gaussians."""
    a, k = sp.num_anchors, sp.k_offsets
    view = sp.anchor_xyz - camera.camera_center
    # dogs_tpu's max(|view|, 1e-12), with the floor taken under the square
    # root: the same value, but a finite gradient for an anchor at the
    # camera centre, where dogs_tpu's is 0 * inf = NaN. bench.py's cameras
    # stand at the origin, where the padding anchors sit: there the NaN
    # reaches the dead anchors' xyz at step 1 and every MLP weight at step 2.
    dist = torch.sqrt(torch.clamp((view * view).sum(dim=-1, keepdim=True), min=1e-24))
    view_dir = view / dist

    feats = sp.anchor_feat
    if sp.mlp_feat_bank:
        # Multi-resolution mixing (scaffold_gs.py:294-305): the stride-4 and
        # stride-2 channel subsets tiled back to full width, blended by a
        # softmax over 3 view-conditioned weights.
        bank_w = torch.softmax(_mlp_apply(sp.mlp_feat_bank, torch.cat([view_dir, dist], -1)), dim=-1)
        c = feats.shape[1]
        f4 = feats[:, ::4].repeat(1, 4)[:, :c]
        f2 = feats[:, ::2].repeat(1, 2)[:, :c]
        feats = f4 * bank_w[:, 0:1] + f2 * bank_w[:, 1:2] + feats * bank_w[:, 2:3]

    feat = torch.cat([feats, view_dir], dim=-1)  # (A, F+3)
    opacity = torch.tanh(_mlp_apply(sp.mlp_opacity, feat))  # (A, K)
    color_in = feat
    if sp.appearance_dim:
        # dogs_tpu's gather clamps an index past the last row.
        app = sp.app_embedding[min(camera.image_index, sp.app_embedding.shape[0] - 1)]
        color_in = torch.cat([feat, app.expand(a, sp.appearance_dim)], dim=-1)
    color = torch.sigmoid(_mlp_apply(sp.mlp_color, color_in).reshape(a, k, 3))
    cov = _mlp_apply(sp.mlp_cov, feat).reshape(a, k, 7)

    offset_extent = torch.exp(sp.log_scaling[:, None, 0:3])
    base_scale = torch.exp(sp.log_scaling[:, None, 3:6])
    xyz = sp.anchor_xyz[:, None, :] + sp.offsets * offset_extent  # (A, K, 3)
    scale = base_scale * torch.sigmoid(cov[..., 0:3]) * 2.0
    quat = cov[..., 3:7]

    anchor_ok = torch.ones((a,), dtype=torch.bool, device=feat.device)
    if alive is not None:
        anchor_ok = anchor_ok & alive
    if visible_mask is not None:
        anchor_ok = anchor_ok & visible_mask
    neural_alive = ((opacity > 0.0) & anchor_ok[:, None]).reshape(-1)
    op = torch.clamp(opacity.reshape(-1, 1), 1e-4, 1.0 - 1e-4)
    gauss = NeuralGaussians(
        xyz=xyz.reshape(-1, 3),
        feat_dc=torch.zeros((a * k, 1, 3), device=feat.device),
        feat_rest=torch.zeros((a * k, 0, 3), device=feat.device),
        log_scale=torch.log(torch.clamp(scale.reshape(-1, 3), min=1e-8)),
        quat=quat.reshape(-1, 4),
        logit_opacity=torch.log(op / (1.0 - op)),
    )
    colors = color.reshape(-1, 3)
    if with_aux:
        aux = {
            "neural_opacity": opacity,  # (A, K), the tanh output before the mask
            "anchor_ok": anchor_ok,  # (A,)
            "scale": scale,  # (A, K, 3)
        }
        return gauss, colors, neural_alive, aux
    return gauss, colors, neural_alive


def render_scaffold(
    sp: ScaffoldParams,
    camera: Camera,
    raster_cfg: RasterConfig,
    background: torch.Tensor | None = None,
    alive: torch.Tensor | None = None,
) -> RenderOutput:
    """scaffold_gs_render.py:17-105: frustum-cull the anchors, decode,
    rasterize with the precomputed colours."""
    visible = anchor_frustum_mask(sp, camera)
    gauss, colors, neural_alive = generate_neural_gaussians(sp, camera, alive=alive, visible_mask=visible)
    return render_tiled(gauss, camera, raster_cfg, background=background, alive=neural_alive,
                        active_sh_degree=0, color_override=colors)


@dataclasses.dataclass(frozen=True)
class ScaffoldConfig:
    """dogs_tpu's ScaffoldConfig, field for field, with its defaults."""

    max_iterations: int = 30000
    voxel_size: float = 0.05
    k_offsets: int = 10
    lambda_dssim: float = 0.2
    lambda_scale: float = 0.01
    # per-group LRs (reference config optimizer.lr.* for scaffold)
    anchor_lr_init: float = 1.6e-4
    anchor_lr_final: float = 1.6e-6
    feat_lr: float = 4e-3
    offset_lr_init: float = 1e-2
    offset_lr_final: float = 1e-4
    scaling_lr: float = 7e-3
    mlp_lr_init: float = 2e-3
    mlp_lr_final: float = 2e-5
    app_lr: float = 5e-2
    # anchor dynamics (reference geometry.* block)
    update_depth: int = 3
    update_init_factor: int = 16
    update_hierarchy_factor: int = 4
    stat_start_iter: int = 500
    densify_start_iter: int = 1500
    densify_end_iter: int = 15000
    densification_interval: int = 100
    densify_grad_threshold: float = 2e-4
    check_interval: int = 100
    success_threshold: float = 0.8
    min_opacity: float = 0.005
    prune_anchors: bool = True
    # optional heads
    use_feat_bank: bool = False
    appearance_dim: int = 0


@dataclasses.dataclass
class ScaffoldTrainState:
    """dogs_tpu's ScaffoldTrainState: parameters, their Adam moments (no
    grad), the step (a host int counted from 0) and the anchor-capacity
    buffers, alive-masked."""

    params: ScaffoldParams
    mu: ScaffoldParams
    nu: ScaffoldParams
    step: int
    alive: torch.Tensor  # (cap,) bool
    opacity_accum: torch.Tensor  # (cap,)
    anchor_denom: torch.Tensor  # (cap,)
    offset_grad_accum: torch.Tensor  # (cap, K)
    offset_denom: torch.Tensor  # (cap, K)

    @property
    def capacity(self) -> int:
        return self.alive.shape[0]

    @property
    def num_alive(self) -> torch.Tensor:
        return self.alive.sum(dtype=torch.int32)


def init_scaffold_state(sp: ScaffoldParams, alive: torch.Tensor) -> ScaffoldTrainState:
    """Zero moments, step 0 and zero statistics around `sp`."""
    cap, k = sp.num_anchors, sp.k_offsets
    zeros = lambda _, t: torch.zeros_like(t, requires_grad=False)  # noqa: E731
    kw = dict(device=alive.device)
    return ScaffoldTrainState(
        params=sp, mu=sp.map(zeros), nu=sp.map(zeros), step=0, alive=alive,
        opacity_accum=torch.zeros((cap,), **kw), anchor_denom=torch.zeros((cap,), **kw),
        offset_grad_accum=torch.zeros((cap, k), **kw), offset_denom=torch.zeros((cap, k), **kw),
    )


def scaffold_state_leaves(state: ScaffoldTrainState) -> dict[str, torch.Tensor | np.ndarray]:
    """The leaves of a JAX `ScaffoldTrainState` keyed and ordered as its
    flattening names them; the step is int32, alive bool."""
    out = {}
    for prefix in ("params", "mu", "nu"):
        out.update({f".{prefix}/{k}": v for k, v in getattr(state, prefix).leaves().items()})
    out[".step"] = np.asarray(state.step, np.int32)
    out[".alive"] = state.alive
    out.update({f".{k}": getattr(state, k) for k in STATS})
    return out


def scaffold_state_arrays(state: ScaffoldTrainState) -> dict[str, np.ndarray]:
    """`state` as the numpy leaves a dogs_tpu scaffold checkpoint holds."""
    return {k: v.detach().cpu().numpy() if torch.is_tensor(v) else v
            for k, v in scaffold_state_leaves(state).items()}


def scaffold_state_from_arrays(arrays: dict, device: torch.device | str = "cuda") -> ScaffoldTrainState:
    """The port's state from the leaves of a scaffold checkpoint of either
    package (a dict of arrays or an open npz), keyed as
    `scaffold_state_leaves` keys them."""
    def params(prefix, requires_grad):
        p = f".{prefix}/"
        return scaffold_params_from_numpy({k[len(p):]: arrays[k] for k in arrays if k.startswith(p)}, device,
                                          requires_grad)

    def f32(key):
        return torch.as_tensor(np.asarray(arrays[key], np.float32), device=device)

    return ScaffoldTrainState(
        params=params("params", True), mu=params("mu", False), nu=params("nu", False),
        step=int(arrays[".step"]), alive=torch.as_tensor(np.asarray(arrays[".alive"], bool), device=device),
        **{k: f32(f".{k}") for k in STATS},
    )


def scaffold_loss_and_grads(
    sp: ScaffoldParams,
    camera: Camera,
    gt: torch.Tensor,
    alive: torch.Tensor,
    cfg: ScaffoldConfig,
    raster_cfg: RasterConfig,
) -> tuple[torch.Tensor, list[torch.Tensor], torch.Tensor, dict]:
    """dogs_tpu's value_and_grad of the scaffold step's loss_fn: prefilter,
    decode, `render_tiled` with a zero means2d offset, L1 + D-SSIM + the
    scale regularizer over the alive neural Gaussians, and the gradient of
    every leaf of `sp` and of the offset (through the three kernels on the
    card and the MLP heads), forward and backward in exact f32. Returns
    (loss, the leaf gradients in `sp.leaves()` order, the offset's gradient
    (cap*K, 2), aux: the clipped render `img`, `radii`, `neural_opacity`
    (cap, K), `visible` (the prefilter and `alive`) and binning's `bin_valid`
    and `bin_dropped`)."""
    cap, k = sp.num_anchors, sp.k_offsets
    offset2d = torch.zeros((cap * k, 2), device=sp.anchor_xyz.device, requires_grad=True)
    with exact_f32():
        visible = anchor_frustum_mask(sp, camera)
        gauss, colors, neural_alive, aux = generate_neural_gaussians(
            sp, camera, alive=alive, visible_mask=visible, with_aux=True)
        out = render_tiled(gauss, camera, raster_cfg, alive=neural_alive, active_sh_degree=0,
                           color_override=colors, means2d_offset=offset2d)
        img = torch.clamp(out.image, 0.0, 1.0)
        l1 = torch.mean(torch.abs(img - gt))
        s = ssim(img, gt)
        # Scale regularizer over the alive neural Gaussians
        # (scaffold_gs_trainer.py:273-276 loss_scaling).
        vol = torch.prod(aux["scale"].reshape(-1, 3), dim=-1)
        n_alive = torch.clamp(neural_alive.sum(dtype=torch.float32), min=1.0)
        loss_scaling = torch.where(neural_alive, vol, torch.zeros_like(vol)).sum() / n_alive
        loss = (1.0 - cfg.lambda_dssim) * l1 + cfg.lambda_dssim * (1.0 - s) + cfg.lambda_scale * loss_scaling
        # Leaves the loss does not reach (a (0, 0) appearance embedding) get
        # zero gradients, as JAX gives them.
        *grads, g_off = torch.autograd.grad(loss, list(sp.leaves().values()) + [offset2d], allow_unused=True,
                                            materialize_grads=True)
    raux = dict(img=img.detach(), radii=out.radii.detach(), neural_opacity=aux["neural_opacity"].detach(),
                visible=visible & alive, bin_valid=out.bin_valid, bin_dropped=out.bin_dropped)
    return loss.detach(), grads, g_off, raux


def make_scaffold_step(cfg: ScaffoldConfig, raster_cfg: RasterConfig) -> Callable:
    """Build `step(state, camera, gt) -> (state, metrics)`, the port of
    dogs_tpu's jitted Scaffold-GS step: `scaffold_loss_and_grads`, dense
    bias-corrected Adam over every leaf at the per-group learning rates, and
    the densify statistics while `stat_start_iter <= state.step <
    densify_end_iter`. The state is updated in place and returned; the
    metrics are device tensors (loss, psnr) and binning's host ints
    (`bin_valid`, the entries K; `bin_pool_truncated` and `bin_dropped`, 0
    in ragged binning)."""
    anchor_lr = exponential_lr(cfg.anchor_lr_init, cfg.anchor_lr_final, cfg.max_iterations)
    offset_lr = exponential_lr(cfg.offset_lr_init, cfg.offset_lr_final, cfg.max_iterations)
    mlp_lr = exponential_lr(cfg.mlp_lr_init, cfg.mlp_lr_final, cfg.max_iterations)

    def lrs(step: int) -> dict[str, float]:
        mlp = mlp_lr(step)
        return dict(anchor_xyz=anchor_lr(step), anchor_feat=cfg.feat_lr, offsets=offset_lr(step),
                    log_scaling=cfg.scaling_lr, mlp_opacity=mlp, mlp_color=mlp, mlp_cov=mlp, mlp_feat_bank=mlp,
                    app_embedding=cfg.app_lr)

    def step_fn(state: ScaffoldTrainState, camera: Camera, gt: torch.Tensor):
        sp = state.params
        cap, k = state.capacity, sp.k_offsets
        device = sp.anchor_xyz.device
        loss, grads, g_off, aux = scaffold_loss_and_grads(sp, camera, gt, state.alive, cfg, raster_cfg)
        with torch.no_grad():
            lr = lrs(state.step)
            for (path, p), g, m, v in zip(sp.leaves().items(), grads, state.mu.leaves().values(),
                                          state.nu.leaves().values()):
                new = adam_step(p, g, m, v, lr[path[1:].split("/")[0]], state.step)
                for dst, src in zip((p, m, v), new):
                    dst.copy_(src)
            if cfg.stat_start_iter <= state.step < cfg.densify_end_iter:
                # Densify statistics (scaffold_gs.py:407-434).
                op = aux["neural_opacity"]  # (cap, K)
                vis_anchor = aux["visible"]
                sel = (op > 0.0) & vis_anchor[:, None]
                upd = (aux["radii"].reshape(cap, k) > 0.0) & sel
                # Screen-gradient norm in pixels (update_densify_stats' convention).
                half = torch.tensor([0.5 * camera.width, 0.5 * camera.height], device=device)
                gs = g_off.reshape(cap, k, 2) * half
                gn = torch.sqrt((gs * gs).sum(dim=-1))
                zero = torch.zeros((), device=device)
                state.opacity_accum += torch.where(vis_anchor, torch.clamp(op, min=0.0).sum(dim=1), zero)
                state.anchor_denom += vis_anchor.float()
                state.offset_grad_accum += torch.where(upd, gn, zero)
                state.offset_denom += upd.float()
            mse = torch.mean((aux["img"] - gt) ** 2)
            metrics = dict(loss=loss, psnr=-10.0 * torch.log(mse) / math.log(10.0), bin_valid=aux["bin_valid"],
                           bin_pool_truncated=0, bin_dropped=aux["bin_dropped"])
        state.step += 1
        return state, metrics

    return step_fn


def grow_and_prune_anchors(
    state: ScaffoldTrainState,
    cfg: ScaffoldConfig,
    rng: np.random.RandomState,
    do_prune: bool,
) -> tuple[ScaffoldTrainState, dict]:
    """Host-side anchor dynamics, every densification_interval
    (scaffold_gs.py:435-580 anchor_growing + prune_anchors, cadence from
    scaffold_gs_trainer.py:296-312), in numpy exactly as dogs_tpu runs them.

    Growing: for each of update_depth hierarchy levels i, neural Gaussians
    whose averaged screen gradient reaches threshold*(f/2)^i (and that
    survive a 1 - 0.5^(i+1) random keep) are anchor candidates; their
    positions voxelize at voxel_size * init_factor / hier_factor^i, dedup
    against the existing anchor grid, and the new anchors take the max
    feature of their contributing parents. Pruning: anchors whose
    accumulated opacity stays below min_opacity * denom over a full check
    window die. New anchors fill dead slots first; the buffers grow to the
    next power-of-two bucket of 256 when the free slots run out, with the
    4 anchor leaves of the moments zero-extended, and the moments of the
    filled slots are zeroed. When nothing grows and nothing is pruned, the
    state comes back unchanged (the check windows are not reset), as in
    dogs_tpu. Returns (state, {"grown", "pruned"})."""

    def host(t):
        return t.detach().cpu().numpy().copy()

    k = state.params.k_offsets
    alive = host(state.alive)
    cap = alive.shape[0]
    anchor_xyz, anchor_feat, offsets, log_scaling = (host(getattr(state.params, n)) for n in ANCHOR_LEAVES)
    grad_accum = host(state.offset_grad_accum)  # (cap, K)
    denom = host(state.offset_denom)  # (cap, K)
    grads = np.where(denom > 0, grad_accum / np.maximum(denom, 1.0), 0.0)
    offset_ok = (denom > cfg.check_interval * cfg.success_threshold * 0.5) & alive[:, None]

    new_xyz, new_feat, new_scaling = [], [], []
    for i in range(cfg.update_depth):
        cur_threshold = cfg.densify_grad_threshold * ((cfg.update_hierarchy_factor // 2) ** i)
        candidate = (grads >= cur_threshold) & offset_ok
        candidate &= rng.rand(*candidate.shape) > 0.5 ** (i + 1)
        if not candidate.any():
            continue
        size_factor = max(cfg.update_init_factor // (cfg.update_hierarchy_factor**i), 1)
        cur_size = cfg.voxel_size * size_factor
        # candidate neural-Gaussian world positions
        all_xyz = anchor_xyz[:, None, :] + offsets * np.exp(log_scaling[:, None, 0:3])
        sel = all_xyz[candidate]  # (M, 3)
        sel_grid = np.round(sel / cur_size).astype(np.int64)
        uniq_grid, inverse = np.unique(sel_grid, axis=0, return_inverse=True)
        # dedup against the EXISTING (alive) anchor grid at this level
        exist_grid = np.round(anchor_xyz[alive] / cur_size).astype(np.int64)
        exist_set = set(map(tuple, exist_grid))
        fresh = np.array([tuple(g) not in exist_set for g in uniq_grid], bool)
        if not fresh.any():
            continue
        # feature: max over the contributing parents of each unique cell
        # (the reference's scatter_max, scaffold_gs.py:504-507)
        parent_feat = np.repeat(anchor_feat, k, axis=0).reshape(cap, k, -1)[candidate]  # (M, F)
        pooled = np.full((uniq_grid.shape[0], parent_feat.shape[1]), -np.inf, np.float32)
        np.maximum.at(pooled, inverse, parent_feat)
        new_xyz.append((uniq_grid[fresh] * cur_size).astype(np.float32))
        new_feat.append(pooled[fresh])
        new_scaling.append(np.full((int(fresh.sum()), 6), np.log(cur_size), np.float32))

    stats = {"grown": 0, "pruned": 0}
    # ---- prune (scaffold_gs.py:530-580) ----
    opacity_accum = host(state.opacity_accum)
    anchor_denom = host(state.anchor_denom)
    if do_prune:
        checked = anchor_denom > cfg.check_interval * cfg.success_threshold
        prune = (opacity_accum < cfg.min_opacity * anchor_denom) & checked & alive
        alive = alive & ~prune
        stats["pruned"] = int(prune.sum())
        # reset the windows of anchors that completed a check interval
        opacity_accum = np.where(checked, 0.0, opacity_accum)
        anchor_denom = np.where(checked, 0.0, anchor_denom)

    grown = int(sum(x.shape[0] for x in new_xyz))
    stats["grown"] = grown
    if grown == 0 and stats["pruned"] == 0:
        return state, stats

    device = state.alive.device
    mu, nu = state.mu, state.nu
    if grown:
        gx, gf, gs = (np.concatenate(x, 0) for x in (new_xyz, new_feat, new_scaling))
        free = np.flatnonzero(~alive)
        if len(free) < grown:
            new_cap = round_up_capacity(cap + grown - len(free), 256)
            pad = new_cap - cap

            def extend(a):
                return np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)], axis=0)

            anchor_xyz, anchor_feat, offsets, log_scaling, alive, grad_accum, denom, opacity_accum, anchor_denom = (
                extend(a) for a in (anchor_xyz, anchor_feat, offsets, log_scaling, alive, grad_accum, denom,
                                    opacity_accum, anchor_denom))

            def extend_moment(name, t):
                if name in ANCHOR_LEAVES and t.dim() and t.shape[0] == cap:
                    return torch.cat([t, t.new_zeros((pad,) + t.shape[1:])])
                return t

            mu, nu = mu.map(extend_moment), nu.map(extend_moment)
            cap = new_cap
            free = np.flatnonzero(~alive)
            logger.info("anchor capacity grown to %d", cap)
        slots = free[:grown]
        anchor_xyz[slots] = gx
        anchor_feat[slots] = gf
        log_scaling[slots] = gs
        offsets[slots] = 0.0  # reference: new offsets start at zero
        alive[slots] = True
        for a in (grad_accum, denom, opacity_accum, anchor_denom):
            a[slots] = 0.0
        # Zero the Adam moments of the filled slots (the reference's
        # densification_postfix zero-extends the optimizer state): every
        # moment leaf whose first dimension is the capacity, as dogs_tpu.
        slot_mask = torch.zeros((cap,), dtype=torch.bool, device=device)
        slot_mask[torch.as_tensor(slots, device=device)] = True

        def zero_slots(_, t):
            if t.dim() and t.shape[0] == cap:
                return t.masked_fill(slot_mask.view((cap,) + (1,) * (t.dim() - 1)), 0.0)
            return t

        mu, nu = mu.map(zero_slots), nu.map(zero_slots)

    def leaf(a):
        return torch.tensor(np.asarray(a, np.float32), device=device, requires_grad=True)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    params = dataclasses.replace(state.params, **{n: leaf(a) for n, a in zip(
        ANCHOR_LEAVES, (anchor_xyz, anchor_feat, offsets, log_scaling))})
    new_state = ScaffoldTrainState(
        params=params, mu=mu, nu=nu, step=state.step, alive=torch.as_tensor(alive, device=device),
        opacity_accum=f32(opacity_accum), anchor_denom=f32(anchor_denom),
        offset_grad_accum=f32(grad_accum), offset_denom=f32(denom),
    )
    return new_state, stats


class ScaffoldGSTrainer:
    """Anchor-based trainer (conerf/trainers/scaffold_gs_trainer.py:21-319),
    the port of dogs_tpu's: joint Adam over anchors, features, offsets,
    scalings and MLPs with per-group exponential LR schedules, the densify
    statistics in the step, and host-side anchor growing and pruning after
    step `step` (counted from 1) when densify_start_iter < step <=
    densify_end_iter and step is a multiple of densification_interval.

    Cameras must be on `device`. Every image (H, W, 3) in [0, 1] is taken
    once, as dogs_tpu's `np.asarray` per image takes it, and kept on the
    device."""

    def __init__(
        self,
        cameras: Sequence[Camera],
        images: Sequence,
        points: np.ndarray,
        raster_cfg: RasterConfig = RasterConfig(),
        val_cameras: Sequence[Camera] = (),
        val_images: Sequence = (),
        seed: int = 42,
        scaffold_cfg: ScaffoldConfig | None = None,
        device: torch.device | str = "cuda",
    ):
        if len(cameras) != len(images):
            raise ValueError(f"{len(cameras)} cameras but {len(images)} images")
        self.device = torch.device(device)
        self.cameras = list(cameras)
        self.images = [_as_image(im, self.device) for im in images]
        self.val_cameras = list(val_cameras)
        self.val_images = [_as_image(im, self.device) for im in val_images]
        self.cfg = scaffold_cfg or ScaffoldConfig()
        self.raster_cfg = raster_cfg
        self.rng = np.random.RandomState(seed)
        sp, alive = init_scaffold(
            points, self.cfg.voxel_size, self.cfg.k_offsets, seed, use_feat_bank=self.cfg.use_feat_bank,
            appearance_dim=self.cfg.appearance_dim, num_cameras=len(self.cameras), device=self.device,
        )
        self.state = init_scaffold_state(sp, alive)
        self._order: list[int] = []
        self.metrics_history: list[dict] = []
        self._step_fn = make_scaffold_step(self.cfg, raster_cfg)
        logger.info("scaffold: %d anchors (cap %d) x %d offsets", int(self.state.num_alive), self.state.capacity,
                    sp.k_offsets)

    def _next_camera(self) -> int:
        """dogs_tpu's camera order: a permutation from the seeded
        RandomState, consumed from its end, drawn anew when used up."""
        if not self._order:
            self._order = list(self.rng.permutation(len(self.cameras)))
        return int(self._order.pop())

    def _anchor_event(self, step: int, metrics: dict) -> None:
        cfg = self.cfg
        if not (cfg.densify_start_iter < step <= cfg.densify_end_iter and step % cfg.densification_interval == 0):
            return
        self.state, stats = grow_and_prune_anchors(self.state, cfg, self.rng, do_prune=cfg.prune_anchors)
        if stats["grown"] or stats["pruned"]:
            metrics["anchors_grown"] = stats["grown"]
            metrics["anchors_pruned"] = stats["pruned"]
            logger.info("step %d anchors +%d -%d (alive %d)", step, stats["grown"], stats["pruned"],
                        int(self.state.num_alive))

    def train_iteration(self, step: int) -> dict:
        """Take training step `step` (1-based), then its anchor event."""
        idx = self._next_camera()
        self.state, metrics = self._step_fn(self.state, self.cameras[idx], self.images[idx])
        self._anchor_event(step, metrics)
        return metrics

    def train(self, num_iterations: int | None = None, log_every: int = 100, **_) -> dict:
        """Take `num_iterations` steps (default: cfg.max_iterations), logging
        every `log_every` steps to `metrics_history` with the anchor count.
        Other keywords (the CLI's validate_every, checkpoint_every,
        checkpoint_manager, tensorboard_writer) are ignored, as dogs_tpu's
        scaffold trainer ignores them. Returns the last step's metrics."""
        n = num_iterations or self.cfg.max_iterations
        start = self.state.step
        t0 = time.time()
        metrics = {}
        for step in range(start + 1, start + n + 1):
            metrics = self.train_iteration(step)
            if log_every and step % log_every == 0:
                vals = torch.stack([torch.as_tensor(v, dtype=torch.float64, device=self.device)
                                    for v in metrics.values()]).tolist()  # one transfer
                m = dict(zip(metrics, vals))
                m["step"] = step
                m["iters_per_sec"] = (step - start) / (time.time() - t0)
                m["n_anchors"] = int(self.state.num_alive)
                self.metrics_history.append(m)
                logger.info("scaffold step %d loss %.4f psnr %.2f anchors %d", step, m["loss"], m["psnr"],
                            m["n_anchors"])
        return metrics

    @torch.no_grad()
    def validate(self) -> dict:
        """Mean PSNR over the val split, without colour correction (as
        dogs_tpu's scaffold trainer validates)."""
        if not self.val_cameras:
            return {}
        psnrs = []
        for cam, gt in zip(self.val_cameras, self.val_images):
            out = render_scaffold(self.state.params, cam, self.raster_cfg, alive=self.state.alive)
            mse = float(torch.mean((torch.clamp(out.image, 0.0, 1.0) - gt) ** 2))
            psnrs.append(-10.0 * np.log10(max(mse, 1e-10)))
        return {"val_psnr": float(np.mean(psnrs))}

    def save_checkpoint(self, manager) -> str:
        """Store the state in dogs_tpu's scaffold layout; returns the path.
        `np_rng` is dogs_tpu's; the RandomState's position and the unused
        part of the camera permutation, which dogs_tpu ignores, let the
        port resume bit for bit."""
        _, key, pos, *_ = self.rng.get_state()
        extra = {"np_rng": key.tolist(), "np_rng_pos": int(pos), "camera_order": [int(i) for i in self._order]}
        return manager.save_arrays(self.state.step, scaffold_state_arrays(self.state), extra)

    def load_checkpoint(self, manager, path: str | None = None) -> int:
        """Resume from `path` or the manager's latest checkpoint, written by
        either package, at its stored capacity; returns the restored step (0
        when there is none). A dogs_tpu file restores the RandomState's key
        at position 0 and leaves the camera order as it is, as dogs_tpu's
        load does."""
        from dogs_tpu_torch.train.checkpoint import load_scaffold_state  # imports this module

        path = path or manager.latest_path()
        if path is None:
            return 0
        self.state, extra = load_scaffold_state(path, self.state)
        if "np_rng" in extra:
            st = self.rng.get_state()
            self.rng.set_state((st[0], np.asarray(extra["np_rng"], np.uint32), extra.get("np_rng_pos", 0), 0, 0.0))
        if "camera_order" in extra:
            self._order = list(extra["camera_order"])
        return self.state.step
