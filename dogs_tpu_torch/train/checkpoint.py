"""Read `dogs_tpu` checkpoints (numpy only, no JAX).

A `dogs_tpu` checkpoint is one npz of flattened pytree leaves
(dogs_tpu/train/checkpoint.py `save_pytree`). Leaf keys join the pytree path
entries with "/", so a bare `GaussianModelState` stores `.params/.xyz`, ...,
`.alive`, `.grad_accum`, `.denom`, `.max_radii2d`, and a trainer checkpoint
(`TrainState`) stores the same keys under `.model/`, the sparse-Adam
moments under `.opt/.mu/` and `.opt/.nu/`, and the step as `.step`.
Writing checkpoints comes with the host-loop slice.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from dogs_tpu_torch.core.gaussians import PARAM_NAMES, params_from_numpy
from dogs_tpu_torch.fields.model import GaussianModelState
from dogs_tpu_torch.train.optim import SparseAdamState
from dogs_tpu_torch.train.trainer import TrainState

FORMAT_VERSION = 1  # highest dogs_tpu checkpoint format this reader knows
_STATS = ("grad_accum", "denom", "max_radii2d")


def _open(path: str):
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["__meta__"])) if "__meta__" in data else {}
    version = meta.get("format_version", 1)
    if version > FORMAT_VERSION:
        data.close()
        raise ValueError(
            f"checkpoint {path} has format_version {version} > supported "
            f"{FORMAT_VERSION}"
        )
    return data


def _model_state(data, prefix: str, device) -> GaussianModelState:
    params = params_from_numpy({k: data[f"{prefix}.params/.{k}"] for k in PARAM_NAMES}, device)
    alive = torch.as_tensor(data[f"{prefix}.alive"].astype(bool), device=device)
    stats = {
        k: torch.as_tensor(data[f"{prefix}.{k}"].astype(np.float32), device=device)
        for k in _STATS
    }
    return GaussianModelState(params=params, alive=alive, **stats)


def load_jax_checkpoint(path: str, device: torch.device | str = "cuda") -> GaussianModelState:
    """Load a `dogs_tpu` model or trainer checkpoint as a `GaussianModelState`."""
    with _open(path) as data:
        for prefix in ("", ".model/"):
            if f"{prefix}.params/.xyz" in data:
                return _model_state(data, prefix, device)
    raise KeyError(
        f"checkpoint {path} holds no model state (no .params/.xyz or "
        f".model/.params/.xyz leaf)"
    )


def load_jax_train_state(path: str, device: torch.device | str = "cuda") -> TrainState:
    """Load a `dogs_tpu` trainer checkpoint (a saved `TrainState`) as the
    port's `TrainState`: the model, the sparse-Adam moments and the step.
    The JAX state's per-image fields (exposure, appearance mask, pose deltas)
    belong to loss terms the port does not have yet and are not read."""
    with _open(path) as data:
        missing = [
            key for key in (".model/.params/.xyz", ".opt/.mu/.xyz", ".opt/.nu/.xyz", ".step")
            if key not in data
        ]
        if missing:
            raise KeyError(f"checkpoint {path} is not a trainer checkpoint: no {missing}")
        opt = SparseAdamState(
            **{
                m: {
                    k: torch.as_tensor(data[f".opt/.{m}/.{k}"].astype(np.float32), device=device)
                    for k in PARAM_NAMES
                }
                for m in ("mu", "nu")
            }
        )
        return TrainState(
            model=_model_state(data, ".model/", device), opt=opt, step=int(data[".step"])
        )
