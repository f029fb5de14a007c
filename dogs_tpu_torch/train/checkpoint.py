"""Checkpoints in `dogs_tpu`'s format (numpy only, no JAX): read, write and
a manager with retention.

A `dogs_tpu` checkpoint is one compressed npz of flattened pytree leaves
(dogs_tpu/train/checkpoint.py `save_pytree`) plus a JSON `__meta__` entry
(`extra` and `format_version`). Leaf keys join the pytree path entries with
"/", so a bare `GaussianModelState` stores `.params/.xyz`, ..., `.alive`,
`.grad_accum`, `.denom`, `.max_radii2d`, and a trainer checkpoint
(`TrainState`) stores the same keys under `.model/`, the sparse-Adam
moments under `.opt/.mu/` and `.opt/.nu/`, the per-image exposure, the
step, the appearance mask CNN's parameters and moments under
`.mask_params/`, `.mask_mu/`, `.mask_nu/` (each leaf keyed by its
`jax.tree_util` path, `['conv_in']/['w']`, ...; none when the mask is off)
and the pose deltas with their moments. The port writes exactly the leaf
keys, shapes and dtypes of a JAX `TrainState`, so either package resumes
from the other's checkpoints. A Scaffold-GS checkpoint holds a
`ScaffoldTrainState` in the same way (fields/scaffold.py keys its leaves:
`.params/.anchor_xyz`, `.params/.mlp_opacity/['w0']`, ..., the moments under
`.mu/` and `.nu/`, `.step`, `.alive` and the anchor statistics);
`load_scaffold_state` reads it.
"""

from __future__ import annotations

import json
import os
import zipfile

import numpy as np
import torch

from dogs_tpu_torch.core.gaussians import PARAM_NAMES, params_from_numpy
from dogs_tpu_torch.fields.appearance import flatten
from dogs_tpu_torch.fields.model import GaussianModelState
from dogs_tpu_torch.fields.scaffold import ScaffoldTrainState, scaffold_state_from_arrays, scaffold_state_leaves
from dogs_tpu_torch.train.optim import SparseAdamState
from dogs_tpu_torch.train.trainer import TrainState

FORMAT_VERSION = 1  # the dogs_tpu checkpoint format written, and the highest read
_STATS = ("grad_accum", "denom", "max_radii2d")
_MASK = ("mask_params", "mask_mu", "mask_nu")
_PER_IMAGE = ("exposure", "exposure_mu", "exposure_nu", "pose_deltas", "pose_mu", "pose_nu")


def _leaves(ts: TrainState) -> dict[str, torch.Tensor | np.ndarray]:
    """The leaves of a JAX `TrainState` (dogs_tpu/train/trainer.py:168-189),
    keyed and ordered as its flattening names them; the step is int32."""
    model = ts.model
    out = {f".model/.params/.{k}": getattr(model.params, k) for k in PARAM_NAMES}
    out[".model/.alive"] = model.alive
    out.update({f".model/.{k}": getattr(model, k) for k in _STATS})
    for m in ("mu", "nu"):
        out.update({f".opt/.{m}/.{k}": getattr(ts.opt, m)[k] for k in PARAM_NAMES})
    for k in _PER_IMAGE[:3]:
        out[f".{k}"] = getattr(ts, k)
    out[".step"] = np.asarray(ts.step, np.int32)
    for k in _MASK:
        out.update({f".{k}/{path}": v for path, v in flatten(getattr(ts, k)).items()})
    for k in _PER_IMAGE[3:]:
        out[f".{k}"] = getattr(ts, k)
    return out


def train_state_arrays(ts: TrainState) -> dict[str, np.ndarray]:
    """`ts` as the numpy leaves a JAX `TrainState` checkpoint holds."""
    return {k: v.detach().cpu().numpy() if torch.is_tensor(v) else v for k, v in _leaves(ts).items()}


def save_arrays(path: str, arrays: dict[str, np.ndarray], extra: dict | None = None) -> None:
    """Write leaf arrays and `extra` as dogs_tpu's `save_pytree` writes a pytree."""
    meta = {"extra": extra or {}, "format_version": FORMAT_VERSION}
    np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)


def save_train_state(path: str, ts: TrainState, extra: dict | None = None) -> None:
    """Write `ts` as dogs_tpu's `save_pytree` writes a `TrainState`."""
    save_arrays(path, train_state_arrays(ts), extra)


def _meta(data) -> dict:
    return json.loads(str(data["__meta__"])) if "__meta__" in data else {}


def _open(path: str):
    data = np.load(path, allow_pickle=False)
    version = _meta(data).get("format_version", 1)
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


def _mask_tree(data, prefix: str, paths: list[str], device, requires_grad: bool) -> dict:
    """The nested parameter dictionary of the leaves `<prefix>/<path>`."""
    tree: dict = {}
    for path in paths:
        *parents, name = [part[2:-2] for part in path.split("/")]  # "['conv_in']" -> "conv_in"
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = torch.tensor(data[f"{prefix}/{path}"].astype(np.float32), device=device,
                                  requires_grad=requires_grad)
    return tree


def _train_state(data, path: str, device, mask_paths: list[str]) -> TrainState:
    """The port's TrainState from the leaves of a trainer checkpoint (an
    open npz or a dict of its arrays), with the mask leaves `mask_paths`."""
    missing = [
        key for key in (".model/.params/.xyz", ".opt/.mu/.xyz", ".opt/.nu/.xyz", ".step", ".exposure",
                        ".pose_deltas")
        if key not in data
    ]
    if missing:
        raise KeyError(f"checkpoint {path} is not a trainer checkpoint: no {missing}")

    def f32(key):
        return torch.as_tensor(data[key].astype(np.float32), device=device)

    opt = SparseAdamState(**{m: {k: f32(f".opt/.{m}/.{k}") for k in PARAM_NAMES} for m in ("mu", "nu")})
    return TrainState(
        model=_model_state(data, ".model/", device), opt=opt, step=int(data[".step"]),
        **{k: f32(f".{k}") for k in _PER_IMAGE},
        **{k: _mask_tree(data, f".{k}", mask_paths, device, k == "mask_params") for k in _MASK},
    )


def train_state_from_arrays(arrays: dict, device: torch.device | str = "cuda", path: str = "") -> TrainState:
    """The port's TrainState from the leaves of one trainer state, keyed as
    `train_state_arrays` keys them (a block of a stacked block checkpoint)."""
    prefix = ".mask_params/"
    return _train_state(arrays, path, device, [k[len(prefix):] for k in arrays if k.startswith(prefix)])


def read_checkpoint(path: str) -> tuple[dict[str, np.ndarray], dict]:
    """(every leaf array, extra) of a checkpoint of either package."""
    with _open(path) as data:
        arrays = {key: data[key] for key in data.files if key != "__meta__"}
        return arrays, _meta(data).get("extra", {})


def load_jax_train_state(path: str, device: torch.device | str = "cuda") -> TrainState:
    """Load a `dogs_tpu` trainer checkpoint (a saved `TrainState`) as the
    port's `TrainState`: the model, the sparse-Adam moments, the step, the
    per-image exposure and pose state and, where it holds them, the
    appearance mask's parameters and moments."""
    with _open(path) as data:
        return train_state_from_arrays(data, device, path)


def leaf_shape(path: str, key: str) -> tuple[int, ...]:
    """The shape of leaf `key` of an npz checkpoint, from its .npy header:
    no array data is decompressed."""
    with zipfile.ZipFile(path) as zf, zf.open(f"{key}.npy") as f:
        major, _ = np.lib.format.read_magic(f)
        read = np.lib.format.read_array_header_1_0 if major == 1 else np.lib.format.read_array_header_2_0
        return tuple(read(f)[0])


def _load_like(path: str, shapes: dict[str, tuple[int, ...]]) -> tuple[dict[str, np.ndarray], dict]:
    """(the leaves named in `shapes` read from `path`, extra), as dogs_tpu's
    `load_pytree` reads them: every leaf must be there with its shape in
    `shapes`. Each leaf is read once; leaves not named are not read."""
    with _open(path) as data:
        extra = _meta(data).get("extra", {})
        arrays = {}
        for key in shapes:
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key}")
            arrays[key] = data[key]
    for key, shape in shapes.items():
        if tuple(arrays[key].shape) != tuple(shape):
            raise ValueError(
                f"checkpoint leaf {key} has shape {arrays[key].shape}, template expects "
                f"{tuple(shape)}; resize the template (capacity grow/shrink) before loading"
            )
    return arrays, extra


def load_train_state(path: str, template: TrainState) -> tuple[TrainState, dict]:
    """Load a trainer checkpoint of either package into the structure of
    `template` (`_load_like`). Returns (state on the template's device,
    extra)."""
    arrays, extra = _load_like(path, {k: tuple(v.shape) for k, v in _leaves(template).items()})
    state = _train_state(arrays, path, template.model.params.xyz.device, list(flatten(template.mask_params)))
    return state, extra


def load_scaffold_state(path: str, template: ScaffoldTrainState) -> tuple[ScaffoldTrainState, dict]:
    """Load a Scaffold-GS checkpoint of either package into the structure
    of `template` (`_load_like`: the template's MLP heads) at the file's
    anchor capacity: every leaf whose first dimension is the template's
    capacity takes the stored one, as dogs_tpu's resize before its load.
    Returns (state on the template's device, extra)."""
    cap, stored = template.capacity, leaf_shape(path, ".alive")[0]
    shapes = {k: (stored,) + tuple(v.shape[1:]) if len(v.shape) and v.shape[0] == cap else tuple(v.shape)
              for k, v in scaffold_state_leaves(template).items()}
    arrays, extra = _load_like(path, shapes)
    return scaffold_state_from_arrays(arrays, template.alive.device), extra


class CheckpointManager:
    """The port of dogs_tpu's CheckpointManager (the reference
    CheckPointManager): <dir>/model_{step:06d}.npz, a model.npz copy of the
    latest, a checkpoints.txt index, and `max_to_keep` retention."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = directory
        self.max_to_keep = max_to_keep
        os.makedirs(directory, exist_ok=True)

    @property
    def index_path(self) -> str:
        return os.path.join(self.directory, "checkpoints.txt")

    def _index(self) -> list[str]:
        if not os.path.exists(self.index_path):
            return []
        with open(self.index_path) as f:
            return [ln.strip() for ln in f if ln.strip()]

    def _write_index(self, names: list[str]) -> None:
        with open(self.index_path, "w") as f:
            f.write("\n".join(names) + ("\n" if names else ""))

    def save(self, step: int, ts: TrainState, extra: dict | None = None) -> str:
        return self.save_arrays(step, train_state_arrays(ts), extra)

    def save_arrays(self, step: int, arrays: dict[str, np.ndarray], extra: dict | None = None) -> str:
        """Save leaf arrays (a stacked block state, parallel/master.py) as
        `save` saves a TrainState; returns the path."""
        name = f"model_{step:06d}.npz"
        path = os.path.join(self.directory, name)
        extra = dict(extra or {})
        extra["step"] = int(step)
        save_arrays(path, arrays, extra)
        latest = os.path.join(self.directory, "model.npz")
        tmp = latest + ".tmp"
        with open(path, "rb") as src, open(tmp, "wb") as dst:
            dst.write(src.read())
        os.replace(tmp, latest)

        names = [n for n in self._index() if n != name] + [name]
        while len(names) > max(self.max_to_keep, 1):
            victim = names.pop(0)
            victim_path = os.path.join(self.directory, victim)
            if os.path.exists(victim_path):
                os.remove(victim_path)
        self._write_index(names)
        return path

    def latest_path(self) -> str | None:
        latest = os.path.join(self.directory, "model.npz")
        if os.path.exists(latest):
            return latest
        names = self._index()
        return os.path.join(self.directory, names[-1]) if names else None

    def load(self, template: TrainState, path: str | None = None) -> tuple[TrainState | None, dict]:
        """(state, extra) from `path` or the latest checkpoint, (None, {})
        when there is none."""
        path = path or self.latest_path()
        if path is None:
            return None, {}
        return load_train_state(path, template)
