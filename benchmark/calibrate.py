"""Readings of a cell's control and of planted faults, for setting its
correctness limits.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 --seconds <s> [--mode <mode>]

Runs the cell as benchmark/run.py does, once per seed, with the timed path
replaced, and prints each run's result line (its `checks` hold the
readings; no limit applies, so `correct` is false). Modes:
- `control` (the default): a training cell runs the program with its own
  lower-precision path switched on, the K -> N gradient reduce in bfloat16
  (`reduce_dtype="bf16"`, dogs_tpu's default) where the configurations
  state float32; the serving cell puts the reference render in bfloat16 in
  the program's place;
- `half_batch` (training): each step sees the top half of its view only;
- `init_and_split` (the quality cell): the initial opacity's logit is 0.1
  too high, and a densify split keeps its parent's scale (the program's
  1 / 1.6 of a split child set to 1);
- `altered` (serving): every frame has a 16 x 16 block brightened by 0.25.
The benchmark's own runs never run this. A number's upper reading is the
smallest that these give (where it is three times its lower reading or
more); its lower reading is the largest that sound runs of the program
give over a dozen seeds (benchmark/run.py).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)

CONTROL = {"train_step": {"reduce_dtype": "bf16"}, "scaffold_train": {"reduce_dtype": "bf16"},
           "quality_run": {"reduce_dtype": "bf16"}, "serve_fixed_rate": {"control_dtype": "bfloat16"}}


def plant(mode: str) -> None:
    """Break the program's timed path underneath, for this process."""
    import dataclasses

    import torch

    if mode == "half_batch":
        from dogs_tpu_torch.fields import scaffold
        from dogs_tpu_torch.train import trainer

        def half(step):
            def broken(state, camera, gt, *args):
                return step(state, dataclasses.replace(camera, height=camera.height // 2),
                            gt[: camera.height // 2], *args)
            return broken

        for mod, name in ((trainer, "make_train_step"), (scaffold, "make_scaffold_step")):
            real = getattr(mod, name)
            setattr(mod, name, lambda *a, _real=real, **k: half(_real(*a, **k)))
    elif mode == "init_and_split":
        from dogs_tpu_torch.fields import model

        logit = model.inverse_sigmoid
        model.inverse_sigmoid = lambda x: logit(x) + 0.1
        model.LOG_1P6 = 0.0
    elif mode == "altered":
        from dogs_tpu_torch.eval.evaluator import GaussianSplatEvaluator

        real = GaussianSplatEvaluator.render

        def altered(self, camera):
            img = real(self, camera).clone()
            img[:16, :16] = torch.clamp(img[:16, :16] + 0.25, 0.0, 1.0)
            return img

        GaussianSplatEvaluator.render = altered


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--mode", default="control", choices=("control", "half_batch", "init_and_split", "altered"))
    args = ap.parse_args(argv)
    import torch

    from benchmark import harness
    from benchmark import run as run_mod

    if not torch.cuda.is_available():
        print("benchmark/calibrate.py: no CUDA device", file=sys.stderr)
        return 1
    spec = harness.spec(ROOT)
    wl = harness.cell(spec, args.workload)
    traffic = harness.traffic(wl["traffic"])
    cfg = harness.config(spec, wl["config"], ROOT)
    if args.mode == "control":
        cfg.update(CONTROL[traffic["driver"]])
    else:
        plant(args.mode)
    rc = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        rc |= run_mod.run_cell(spec, wl, seed, args.seconds, False, torch.device("cuda", 0), time.perf_counter(),
                               cfg=cfg, traffic=traffic, limits={})
        torch.cuda.empty_cache()
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
