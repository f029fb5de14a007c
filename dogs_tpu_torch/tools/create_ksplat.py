"""Convert a 3DGS .ply or .splat export to a compressed .ksplat.

    python -m dogs_tpu_torch.tools.create_ksplat <model.ply|model.splat> [out.ksplat]

The port of tools/create_ksplat.py (the counterpart of the reference's
webui/util/create-ksplat.js): .ksplat stores uint16 bucket-relative centres
and float16 scale and rotation at 24 bytes a splat, against the .splat's 32
and the .ply's full precision. The default output is the input's path with
the suffix .ksplat. Runs on the CPU; needs no JAX.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

from dogs_tpu_torch.core.gaussians import GaussianParams, inverse_sigmoid
from dogs_tpu_torch.core.sh import C0
from dogs_tpu_torch.fields.io import load_gaussian_ply, load_splat, save_ksplat


def splat_params(path: str) -> GaussianParams:
    """A .splat's splats as parameters whose activations give back the
    stored values (colour and alpha clipped into (0, 1) first)."""
    d = load_splat(path)
    n = d["xyz"].shape[0]
    rgb = np.clip(d["rgba"][:, :3], 1e-4, 1 - 1e-4)
    alpha = np.clip(d["rgba"][:, 3:4], 1e-4, 1 - 1e-4)
    arrays = dict(
        xyz=d["xyz"],
        feat_dc=((rgb - 0.5) / C0).astype(np.float32)[:, None, :],
        feat_rest=np.zeros((n, 0, 3), np.float32),
        log_scale=np.log(np.maximum(d["scale"], 1e-9)),
        quat=d["quat"].astype(np.float32),
        logit_opacity=inverse_sigmoid(torch.from_numpy(alpha.astype(np.float32))).numpy(),
    )
    return GaussianParams(**{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()})


def convert(src: Path, dst: Path) -> None:
    if src.suffix == ".ply":
        params = load_gaussian_ply(str(src), "cpu")
    elif src.suffix == ".splat":
        params = splat_params(str(src))
    else:
        raise SystemExit(f"unsupported input {src.suffix} (need .ply or .splat)")
    save_ksplat(str(dst), params)
    print(f"{src} -> {dst} ({dst.stat().st_size:,} bytes)")


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        raise SystemExit(1)
    src = Path(argv[0])
    convert(src, Path(argv[1]) if len(argv) > 1 else src.with_suffix(".ksplat"))


if __name__ == "__main__":
    main()
