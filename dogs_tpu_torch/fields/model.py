"""Gaussian model state: padded parameters, alive mask, densify statistics.

Port of the state container of dogs_tpu/fields/model.py. The fixed-capacity
layout with an `alive` mask is kept, so a `dogs_tpu` checkpoint loads slot
for slot. Densify, clone/split and prune come with the training slice.
"""

from __future__ import annotations

import dataclasses

import torch

from dogs_tpu_torch.core.gaussians import GaussianParams


@dataclasses.dataclass
class GaussianModelState:
    """Padded model + alive mask + densification bookkeeping."""

    params: GaussianParams
    alive: torch.Tensor  # (C,) bool
    grad_accum: torch.Tensor  # (C,) sum of screen-space grad norms
    denom: torch.Tensor  # (C,) number of accumulation events
    max_radii2d: torch.Tensor  # (C,) running max screen radius

    @property
    def capacity(self) -> int:
        return self.params.capacity

    @property
    def num_alive(self) -> torch.Tensor:
        return self.alive.sum(dtype=torch.int32)
