"""Read `dogs_tpu` checkpoints (numpy only, no JAX).

A `dogs_tpu` checkpoint is one npz of flattened pytree leaves
(dogs_tpu/train/checkpoint.py `save_pytree`). Leaf keys join the pytree path
entries with "/", so a bare `GaussianModelState` stores `.params/.xyz`, ...,
`.alive`, `.grad_accum`, `.denom`, `.max_radii2d`, and a trainer checkpoint
(`TrainState`) stores the same keys under `.model/`.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from dogs_tpu_torch.core.gaussians import PARAM_NAMES, params_from_numpy
from dogs_tpu_torch.fields.model import GaussianModelState

FORMAT_VERSION = 1  # highest dogs_tpu checkpoint format this reader knows
_STATS = ("grad_accum", "denom", "max_radii2d")


def load_jax_checkpoint(path: str, device: torch.device | str = "cpu") -> GaussianModelState:
    """Load a `dogs_tpu` model or trainer checkpoint as a `GaussianModelState`."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"])) if "__meta__" in data else {}
        version = meta.get("format_version", 1)
        if version > FORMAT_VERSION:
            raise ValueError(
                f"checkpoint {path} has format_version {version} > supported "
                f"{FORMAT_VERSION}"
            )
        for prefix in ("", ".model/"):
            if f"{prefix}.params/.xyz" in data:
                break
        else:
            raise KeyError(
                f"checkpoint {path} holds no model state (no .params/.xyz or "
                f".model/.params/.xyz leaf)"
            )
        params = params_from_numpy(
            {k: data[f"{prefix}.params/.{k}"] for k in PARAM_NAMES}, device
        )
        alive = torch.as_tensor(data[f"{prefix}.alive"].astype(bool), device=device)
        stats = {
            k: torch.as_tensor(data[f"{prefix}.{k}"].astype(np.float32), device=device)
            for k in _STATS
        }
    return GaussianModelState(params=params, alive=alive, **stats)
