"""Optimizers and learning-rate schedules for Gaussian training.

Port of dogs_tpu/train/optim.py: the visibility-masked sparse Adam of the
reference's `SparseGaussianAdam` (adam.cu) and the log-linear learning-rate
schedule. Moments are plain dictionaries of tensors keyed by the parameter
names (core/gaussians.PARAM_NAMES), the port of the JAX moment pytrees.
`sparse_adam_step` updates parameters and moments in place, under
`torch.no_grad()`, where the JAX version returns new arrays.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from dogs_tpu_torch.core.gaussians import PARAM_NAMES, GaussianParams


def exponential_lr(
    lr_init: float,
    lr_final: float,
    max_steps: int,
    lr_delay_steps: int = 0,
    lr_delay_mult: float = 1.0,
):
    """Log-linear decay lr(step) from lr_init to lr_final over max_steps,
    with the optional sine warm-up of `lr_delay_steps`. Returns a function of
    the (host) step that gives a Python float."""
    lr_init = float(lr_init)
    lr_final = float(max(lr_final, 1e-32))

    def lr(step: int) -> float:
        t = min(max(step / max_steps, 0.0), 1.0)
        log_lerp = math.exp((1.0 - t) * math.log(lr_init) + t * math.log(lr_final))
        if lr_delay_steps > 0:
            s = min(max(step / lr_delay_steps, 0.0), 1.0)
            delay = lr_delay_mult + (1.0 - lr_delay_mult) * math.sin(0.5 * math.pi * s)
        else:
            delay = 1.0
        return delay * log_lerp

    return lr


def constant_lr(value: float):
    """lr(step) = value at every step, a Python float."""
    value = float(value)

    def lr(step: int) -> float:
        del step
        return value

    return lr


@dataclasses.dataclass
class SparseAdamState:
    """First and second moments, one tensor per parameter name."""

    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


def init_sparse_adam(params: GaussianParams) -> SparseAdamState:
    return SparseAdamState(
        mu={k: torch.zeros_like(getattr(params, k), requires_grad=False) for k in PARAM_NAMES},
        nu={k: torch.zeros_like(getattr(params, k), requires_grad=False) for k in PARAM_NAMES},
    )


@torch.no_grad()
def sparse_adam_step(
    params: GaussianParams,
    grads: dict[str, torch.Tensor],
    state: SparseAdamState,
    visible: torch.Tensor,
    lrs: dict[str, float],
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-15,
) -> None:
    """One visibility-masked Adam step over every parameter, IN PLACE.

    Semantics of adam.cu as dogs_tpu keeps them: b1 0.9, b2 0.999, eps 1e-15
    and no bias correction; Gaussians with `visible` False keep their
    parameters and their moments untouched."""
    for k in PARAM_NAMES:
        p, g, m, v = getattr(params, k), grads[k], state.mu[k], state.nu[k]
        mask = visible.reshape((-1,) + (1,) * (p.dim() - 1))
        m_new = b1 * m + (1.0 - b1) * g
        v_new = b2 * v + (1.0 - b2) * g * g
        step = -lrs[k] * m_new / (torch.sqrt(v_new) + eps)
        p.copy_(torch.where(mask, p + step, p))
        m.copy_(torch.where(mask, m_new, m))
        v.copy_(torch.where(mask, v_new, v))


def adam_step(
    param: torch.Tensor,
    grad: torch.Tensor,
    mu: torch.Tensor,
    nu: torch.Tensor,
    lr: float,
    step: int,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain bias-corrected Adam for the auxiliary parameters (exposure,
    appearance, pose; the reference uses torch.optim.Adam for them).
    `step` counts from 0. Returns new (param, mu, nu)."""
    mu = b1 * mu + (1.0 - b1) * grad
    nu = b2 * nu + (1.0 - b2) * grad * grad
    t = step + 1.0
    mu_hat = mu / (1.0 - b1**t)
    nu_hat = nu / (1.0 - b2**t)
    return param - lr * mu_hat / (torch.sqrt(nu_hat) + eps), mu, nu
