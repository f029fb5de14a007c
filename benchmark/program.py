"""The benchmark's side of the program under test, dogs_tpu_torch: its
inputs built from the benchmark's scenes and poses, and what the checks
read back from its state. The drivers reach the program through this
module and the program's public entries only."""

from __future__ import annotations

import numpy as np
import torch

from dogs_tpu_torch.core.camera import make_camera
from benchmark.reference.gs3d import LEAVES
from dogs_tpu_torch.core.gaussians import PARAM_NAMES, GaussianParams

if tuple(PARAM_NAMES) != LEAVES:
    raise ImportError(f"the program's Gaussian leaves {PARAM_NAMES} are not the reference's {LEAVES}")


def camera(pose: dict, device, index: int = 0):
    return make_camera(pose["R"], pose["t"], pose["fx"], pose["fy"], pose["cx"], pose["cy"], pose["width"],
                       pose["height"], image_index=index, device=device)


def params(leaves: dict) -> GaussianParams:
    """The program's parameters around the benchmark's tensors (shared, not
    copied: the program updates them in place)."""
    return GaussianParams(**{k: leaves[k] for k in PARAM_NAMES})


def leaves_of(p) -> dict:
    return {k: getattr(p, k).detach() for k in PARAM_NAMES}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def free(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def as_numpy_points(xyz: torch.Tensor) -> np.ndarray:
    return xyz.detach().cpu().numpy().astype(np.float32)


def host_copy(t: torch.Tensor) -> torch.Tensor:
    """`t` copied to host memory without waiting for the device: pinned and
    non-blocking from a CUDA tensor (read it after a synchronize)."""
    if not t.is_cuda:
        return t.detach().clone()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t.detach(), non_blocking=True)
    return out
