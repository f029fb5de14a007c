"""How far bench.py's quality GT lies from its teacher's exact render.

bench.py's `_quality_scene` renders its teacher under a two-tier bin budget
(`RasterConfig(base_tiles=4, overflow_capacity=n_teacher)`): every Gaussian
owns 4 candidate tiles of its clamped tile rect, the rest of the rect (up
to max_tiles 12) takes slots of one shared pool of n_teacher entries,
allotted in Gaussian order, and the candidates past the pool are dropped.
The port's bench renders that GT as bench.py does (`bench.render_budgeted`).
This tool renders each view both ways, under the budget and exactly, and
prints one JSON line per view (the pool's need, the Gaussians and the
blended entries it drops, the PSNR of the budget's render against the
exact one) and a summary line:

    python -m dogs_tpu_torch.tools.quality_gt_budget [--device cpu] [--n-teacher N] [--width W]
        [--height H] [--views V] [--focal F]
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

from dogs_tpu_torch.bench import MAX_TILES, render_budgeted
from dogs_tpu_torch.core.gaussians import params_from_numpy
from dogs_tpu_torch.data import synthetic
from dogs_tpu_torch.raster.tiled import RasterConfig, render_tiled


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-teacher", type=int, default=200_000)
    ap.add_argument("--width", type=int, default=synthetic.BENCH_WIDTH)
    ap.add_argument("--height", type=int, default=synthetic.BENCH_HEIGHT)
    ap.add_argument("--views", type=int, default=40)
    ap.add_argument("--focal", type=float, default=900.0)
    args = ap.parse_args(argv)
    teacher = params_from_numpy(synthetic.quality_teacher_arrays(args.n_teacher), args.device)
    cams = synthetic.ring_cameras(args.views, radius=5.0, width=args.width, height=args.height, focal=args.focal,
                                  device=args.device)
    cfg = RasterConfig(max_tiles_per_gaussian=MAX_TILES)
    psnrs = []
    for i, cam in enumerate(cams):
        with torch.no_grad():
            exact = render_tiled(teacher, cam, cfg, active_sh_degree=0).image
        budgeted, stats = render_budgeted(teacher, cam, pool=args.n_teacher)
        mse = float(torch.mean((budgeted - exact) ** 2))
        psnr = -10.0 * math.log10(max(mse, 1e-20))
        psnrs.append(psnr)
        changed = float((torch.abs(budgeted - exact).amax(-1) > 1.0 / 255.0).float().mean())
        print(json.dumps(dict(view=i, pool=args.n_teacher, **stats, psnr_budget_vs_exact=psnr,
                              pixels_off_by_a_level=changed)), flush=True)
    print(json.dumps(dict(views=len(cams), psnr_budget_vs_exact_mean=float(np.mean(psnrs)),
                          psnr_budget_vs_exact_min=float(np.min(psnrs)))), flush=True)


if __name__ == "__main__":
    main()
