"""The Gaussian field parameters as an `nn.Module`.

Port of dogs_tpu/core/gaussians.py. The six pre-activation tensors keep
their JAX names and layouts, so a `dogs_tpu` checkpoint maps onto them leaf
for leaf (`params_from_numpy`):

  xyz            (C, 3)      world position
  feat_dc        (C, 1, 3)   SH DC coefficients
  feat_rest      (C, K-1, 3) higher SH coefficients, K = (max_sh_degree+1)^2
  log_scale      (C, 3)      log of per-axis extent          -> exp
  quat           (C, 4)      wxyz rotation, unnormalized     -> normalize
  logit_opacity  (C, 1)      opacity logit                   -> sigmoid
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

PARAM_NAMES = ("xyz", "feat_dc", "feat_rest", "log_scale", "quat", "logit_opacity")


class GaussianParams(nn.Module):
    """Fixed-capacity padded Gaussian buffers (dead slots are masked by the
    model state's `alive`, as in the JAX package)."""

    def __init__(
        self,
        xyz: torch.Tensor,
        feat_dc: torch.Tensor,
        feat_rest: torch.Tensor,
        log_scale: torch.Tensor,
        quat: torch.Tensor,
        logit_opacity: torch.Tensor,
    ):
        super().__init__()
        self.xyz = nn.Parameter(xyz)
        self.feat_dc = nn.Parameter(feat_dc)
        self.feat_rest = nn.Parameter(feat_rest)
        self.log_scale = nn.Parameter(log_scale)
        self.quat = nn.Parameter(quat)
        self.logit_opacity = nn.Parameter(logit_opacity)

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def max_sh_degree(self) -> int:
        k = 1 + self.feat_rest.shape[1]
        return int(round(k**0.5)) - 1

    @property
    def scale(self) -> torch.Tensor:
        """Linear per-axis scales."""
        return torch.exp(self.log_scale)

    @property
    def opacity(self) -> torch.Tensor:
        """Opacity in (0,1)."""
        return torch.sigmoid(self.logit_opacity)

    @property
    def features(self) -> torch.Tensor:
        """(C, K, 3) full SH coefficient stack."""
        return torch.cat([self.feat_dc, self.feat_rest], dim=1)


@dataclasses.dataclass
class NeuralGaussians:
    """The six fields of `GaussianParams` as plain tensors, for Gaussians
    computed inside a differentiable function (Scaffold-GS decodes them per
    view from its anchor MLPs, fields/scaffold.py). `GaussianParams` wraps
    each field in `nn.Parameter`, a new autograd leaf that would cut the
    decoded tensors off from the MLPs; this keeps the graph. The projection
    and `render_tiled` take either."""

    xyz: torch.Tensor
    feat_dc: torch.Tensor
    feat_rest: torch.Tensor
    log_scale: torch.Tensor
    quat: torch.Tensor
    logit_opacity: torch.Tensor

    capacity = GaussianParams.capacity
    max_sh_degree = GaussianParams.max_sh_degree
    scale = GaussianParams.scale
    opacity = GaussianParams.opacity
    features = GaussianParams.features


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Logit; used for opacity init/reset."""
    return torch.log(x / (1.0 - x))


def empty_params(
    capacity: int, max_sh_degree: int = 3, device: torch.device | str = "cuda"
) -> GaussianParams:
    """Inert padded parameter buffers (tiny scale, near-zero opacity)."""
    k = (max_sh_degree + 1) ** 2
    kw = dict(dtype=torch.float32, device=device)
    quat = torch.zeros((capacity, 4), **kw)
    quat[:, 0] = 1.0
    return GaussianParams(
        xyz=torch.zeros((capacity, 3), **kw),
        feat_dc=torch.zeros((capacity, 1, 3), **kw),
        feat_rest=torch.zeros((capacity, k - 1, 3), **kw),
        log_scale=torch.full((capacity, 3), -10.0, **kw),
        quat=quat,
        logit_opacity=torch.full((capacity, 1), -10.0, **kw),
    )


def params_from_numpy(
    arrays: dict[str, np.ndarray], device: torch.device | str = "cuda"
) -> GaussianParams:
    """Build `GaussianParams` from the six named numpy arrays (a JAX model's
    leaves, `np.asarray(getattr(jax_params, name))`), as float32 on `device`."""
    missing = [k for k in PARAM_NAMES if k not in arrays]
    if missing:
        raise KeyError(f"missing Gaussian parameter arrays: {missing}")
    return GaussianParams(
        **{
            k: torch.as_tensor(np.asarray(arrays[k], np.float32), device=device)
            for k in PARAM_NAMES
        }
    )


def round_up_capacity(n: int, min_capacity: int = 1024) -> int:
    """Capacity as the smallest power-of-two multiple of `min_capacity`
    that holds `n` (dogs_tpu buckets capacity this way; the port keeps the
    buckets so that checkpoints and step comparisons line up slot for slot)."""
    c = max(min_capacity, 1)
    while c < n:
        c *= 2
    return c


def pad_to_capacity(params: GaussianParams, capacity: int) -> GaussianParams:
    """New parameters grown to `capacity` slots; the new slots get the inert
    defaults of `empty_params`."""
    cur = params.capacity
    if capacity < cur:
        raise ValueError(f"cannot pad {cur} slots down to {capacity}")
    if capacity == cur:
        return params
    pad = empty_params(capacity - cur, params.max_sh_degree, params.xyz.device)
    return GaussianParams(
        **{
            k: torch.cat([getattr(params, k).detach(), getattr(pad, k).detach()], dim=0)
            for k in PARAM_NAMES
        }
    )
