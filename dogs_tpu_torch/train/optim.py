"""Optimizers and learning-rate schedules for Gaussian training.

Port of dogs_tpu/train/optim.py: the visibility-masked sparse Adam of the
reference's `SparseGaussianAdam` (adam.cu) and the log-linear learning-rate
schedule. Moments are plain dictionaries of tensors keyed by the parameter
names (core/gaussians.PARAM_NAMES), the port of the JAX moment pytrees.
`sparse_adam_step` updates parameters and moments in place, under
`torch.no_grad()`, where the JAX version returns new arrays: on CUDA tensors
in one launch of the hand-written kernel csrc/sparse_adam.cu for all six
leaves, on CPU tensors in the plain loop `sparse_adam_step_reference`. The
two agree bit for bit. `adam_step` and `adam_in_place` are the plain
bias-corrected Adam of the auxiliary parameters and of Scaffold-GS.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from dogs_tpu_torch import kernels
from dogs_tpu_torch.core.gaussians import PARAM_NAMES, GaussianParams

_VP = ctypes.c_void_p


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


class KernelLeaf(ctypes.Structure):
    """csrc/sparse_adam.cuh's `Leaf`, field for field."""

    _fields_ = [(name, _VP) for name in ("p", "g", "m", "v")] + [
        ("width", ctypes.c_longlong), ("neg_lr", ctypes.c_float)]


class KernelArgs(ctypes.Structure):
    """csrc/sparse_adam.cuh's `Args`, field for field."""

    _fields_ = [("leaf", KernelLeaf * len(PARAM_NAMES)), ("visible", _VP), ("n", ctypes.c_longlong)] + [
        (name, ctypes.c_float) for name in ("b1", "c1", "b2", "c2", "eps")]


_ARGTYPES = (ctypes.POINTER(KernelArgs), _VP)


def kernel_inputs(
    params: GaussianParams, grads: dict[str, torch.Tensor], state: SparseAdamState, visible: torch.Tensor
) -> dict[str, tuple[torch.Tensor, ...]]:
    """Each leaf's (p, g, m, v) as the kernel takes them. Raise on what it
    does not take: a `visible` that is not a contiguous (N,) bool, a tensor
    that is not float32 or not of its parameter's shape, a parameter or
    moment that is not contiguous or not 16-byte aligned. A gradient that is
    not contiguous or not aligned (autograd may hand over a view) is copied."""
    n = params.xyz.shape[0]
    if visible.dtype != torch.bool or tuple(visible.shape) != (n,) or not visible.is_contiguous():
        raise ValueError(f"sparse_adam_step: visible must be a contiguous ({n},) bool, got "
                         f"{tuple(visible.shape)} {visible.dtype}")
    out = {}
    for k in PARAM_NAMES:
        p, g, m, v = getattr(params, k), grads[k], state.mu[k], state.nu[k]
        for what, t in (("parameter", p), ("gradient", g), ("first moment", m), ("second moment", v)):
            if t.dtype != torch.float32 or t.shape != p.shape or p.shape[0] != n:
                raise ValueError(f"sparse_adam_step: the {what} of {k} must be float32 of shape ({n}, ...) as "
                                 f"its parameter {tuple(p.shape)}, got {tuple(t.shape)} {t.dtype}")
        for what, t in (("parameter", p), ("first moment", m), ("second moment", v)):
            if not t.is_contiguous() or (t.numel() and t.data_ptr() % 16):
                raise ValueError(f"sparse_adam_step: the {what} of {k} must be contiguous and 16-byte aligned")
        if not g.is_contiguous() or (g.numel() and g.data_ptr() % 16):
            g = torch.empty_like(p).copy_(g)
        out[k] = (p, g, m, v)
    return out


def kernel_args(leaves: dict[str, tuple[torch.Tensor, ...]], visible: torch.Tensor, lrs: dict[str, float],
                b1: float, b2: float, eps: float) -> KernelArgs:
    """The C struct of `kernel_inputs`' leaves (pointers into them, which
    must outlive the launch's enqueue): each scalar the float32 of the
    double the plain loop multiplies by."""
    return KernelArgs(
        (KernelLeaf * len(PARAM_NAMES))(*(
            KernelLeaf(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), math.prod(p.shape[1:]),
                       -float(lrs[k]))
            for k, (p, g, m, v) in leaves.items())),
        visible.data_ptr(), visible.shape[0], b1, 1.0 - b1, b2, 1.0 - b2, eps,
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
    parameters and their moments untouched. On CUDA tensors one launch of
    csrc/sparse_adam.cu on the current stream (no sync) updates all six
    leaves; what it does not take raises (`kernel_inputs`), and nothing falls
    back. On CPU tensors, `sparse_adam_step_reference`."""
    if not params.xyz.is_cuda:
        sparse_adam_step_reference(params, grads, state, visible, lrs, b1, b2, eps)
        return
    kernels.require_cuda("sparse_adam_step", visible, *(t for k in PARAM_NAMES for t in (
        getattr(params, k), grads[k], state.mu[k], state.nu[k])))
    leaves = kernel_inputs(params, grads, state, visible)
    args = kernel_args(leaves, visible, lrs, b1, b2, eps)
    kernels.launch("sparse_adam", "dogs_sparse_adam", _ARGTYPES, ctypes.byref(args), device=visible.device)


@torch.no_grad()
def sparse_adam_step_reference(
    params: GaussianParams,
    grads: dict[str, torch.Tensor],
    state: SparseAdamState,
    visible: torch.Tensor,
    lrs: dict[str, float],
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-15,
) -> None:
    """`sparse_adam_step` as plain PyTorch, leaf by leaf, on any device: the
    chain whose operations the kernel repeats one for one."""
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


@torch.no_grad()
def adam_in_place(param, grad, mu, nu, lr: float, step: int) -> None:
    """`adam_step` written back into `param`, `mu` and `nu`."""
    for dst, src in zip((param, mu, nu), adam_step(param, grad, mu, nu, lr, step)):
        dst.copy_(src)
