"""Driver `scaffold_train`: Scaffold-GS training with its anchor events.

The program's `ScaffoldGSTrainer` from points drawn on the card from the
seed (voxelized into anchors by the program; its own seed, which draws the
MLPs and the camera order, is the configuration's), on the bench cameras at the
configuration's frame, against the benchmark's plain renders of a teacher
scene; statistics from step 1 and anchor events every
`densification_interval` steps inside the window. The window calls
`train(num_iterations=1)` step after step (the trainer's own loop, one
step a call) until the time is up.

Set-up: the teacher's renders (benchmark), the trainer (program), steps 1-3
(checked), then warm steps up to `warm_steps`.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import compare, program, scenes
from benchmark.reference import scaffold as ref_scaffold
from benchmark.traffic.train_step import reference_render

POINTS, TEACHER = 1, 2


def scaffold_config(cfg: dict, overrides: dict):
    from dogs_tpu_torch.fields.scaffold import ScaffoldConfig

    m = {**cfg, **overrides}
    keys = ("max_iterations", "lambda_dssim", "lambda_scale", "anchor_lr_init", "anchor_lr_final", "feat_lr",
            "offset_lr_init", "offset_lr_final", "scaling_lr", "mlp_lr_init", "mlp_lr_final", "stat_start_iter",
            "densify_start_iter", "densify_end_iter", "densification_interval", "densify_grad_threshold")
    return ScaffoldConfig(voxel_size=m["voxel_size"], k_offsets=m["n_offsets"], **{k: m[k] for k in keys})


def camera_order(seed: int, n: int, steps: int) -> list[int]:
    """The trainers' camera order: permutations from RandomState(seed),
    each consumed from its end."""
    rng, out, order = np.random.RandomState(seed), [], []
    while len(out) < steps:
        if not order:
            order = list(rng.permutation(n))
        out.append(int(order.pop()))
    return out




def leaves_by_name(sp) -> dict:
    """The program's Scaffold-GS parameters under the reference's names."""
    out = {}
    for path, t in sp.leaves().items():
        name, _, sub = path[1:].partition("/")
        if t.numel():
            out[f"{name}.{sub[2:-2]}" if sub else name] = t.detach()
    return out


class ScaffoldRun:
    def __init__(self, cfg, traffic, seed, device, meter):
        from dogs_tpu_torch.fields import scaffold
        from dogs_tpu_torch.raster.tiled import RasterConfig

        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, torch.device(device)
        self.poses = scenes.bench_poses(traffic["n_cameras"], cfg["width"], cfg["height"])
        teacher = scenes.box_scene(traffic["n_teacher"], seed, TEACHER, self.device, sh_rest=0.0)
        self.gts = [reference_render(teacher, p, self.device, 0, cfg["max_tiles_per_gaussian"]) for p in self.poses]
        del teacher
        self.points = program.as_numpy_points(
            scenes.box_scene(traffic["n_points"], seed, POINTS, self.device, sh_rest=0.0)["xyz"])
        program.free(self.device)

        meter.start()
        self.scfg = scaffold_config(cfg, traffic.get("overrides", {}))
        cams = [program.camera(p, self.device, i) for i, p in enumerate(self.poses)]
        self.trainer = scaffold.ScaffoldGSTrainer(
            cameras=cams, images=self.gts, points=self.points,
            raster_cfg=RasterConfig(max_tiles_per_gaussian=cfg["max_tiles_per_gaussian"],
                                    depth_threshold=cfg["depth_threshold"], reduce_dtype=cfg.get("reduce_dtype", "f32")),
            seed=cfg["seed"], scaffold_cfg=self.scfg, device=self.device)
        p0 = {k: v.clone() for k, v in leaves_by_name(self.trainer.state.params).items()}
        losses, grad = [], None
        for i in range(traffic["check_steps"]):
            m = self.trainer.train(num_iterations=1, log_every=0)
            losses.append(m["loss"])
            if i == 0:
                grad = compare.norms({k: v / 0.1 for k, v in leaves_by_name(self.trainer.state.mu).items()})
        meter.stop()
        change = compare.norms({k: v - p0[k] for k, v in leaves_by_name(self.trainer.state.params).items()})
        self.prog = dict(losses=[float(x) for x in losses], grad=grad, change=change)
        del p0
        program.free(self.device)
        meter.start()
        self.trainer.train(num_iterations=traffic["warm_steps"] - traffic["check_steps"], log_every=0)
        program.sync(self.device)

    def window(self, seconds: float, tracer=None) -> dict:
        every = self.scfg.densification_interval
        steps, traced_s, plain_s = 0, 0.0, None
        t0 = time.perf_counter()
        while time.perf_counter() - t0 - traced_s < seconds:
            step = self.trainer.state.step + 1
            if tracer is not None and not traced_s and time.perf_counter() - t0 >= seconds / 2 \
                    and (step + self.traffic["profile_steps"]) // every == step // every:
                k0 = time.perf_counter()
                with tracer.segment():
                    self.trainer.train(num_iterations=self.traffic["profile_steps"], log_every=0)
                traced_s = time.perf_counter() - k0
                steps += self.traffic["profile_steps"]
                continue
            event = step % every == 0 and self.scfg.densify_start_iter < step <= self.scfg.densify_end_iter
            timed = tracer is not None and (event or (step + 1) % every == 0)
            if timed:
                program.sync(self.device)
                k0 = time.perf_counter()
            self.trainer.train(num_iterations=1, log_every=0)
            if timed:
                program.sync(self.device)
                dt = time.perf_counter() - k0
                if event and plain_s is not None:
                    tracer.spans["anchor"].append((dt, plain_s))
                plain_s = None if event else dt
            steps += 1
        program.sync(self.device)
        t1 = time.perf_counter()
        self.steps = steps
        return dict(e2e=dict(train_step_ms=1e3 * (t1 - t0) / steps), attempted=steps, failed=0, t0=t0)

    def count(self, tracer) -> None:
        pass

    def verify(self) -> dict:
        n_check = self.traffic["check_steps"]
        del self.trainer
        program.free(self.device)
        arrays, alive = ref_scaffold.init_arrays(self.points, self.cfg["voxel_size"], self.cfg["n_offsets"],
                                                 self.cfg["seed"])
        p0 = {k: torch.as_tensor(v, device=self.device) for k, v in arrays.items()}
        order = camera_order(self.cfg["seed"], len(self.poses), n_check)
        cfg = {**self.cfg, **self.traffic.get("overrides", {})}
        r = ref_scaffold.follow(p0, torch.as_tensor(alive, device=self.device),
                                [scenes.view(self.poses[i], self.device) for i in order],
                                [self.gts[i] for i in order], cfg)
        ref = dict(losses=r["losses"], grad=compare.norms(r["first_grad"]),
                   change=compare.norms({k: r["params"][k] - p0[k] for k in p0}))
        return compare.training_readings(self.prog, ref)


def build(cfg: dict, traffic: dict, seed: int, device, meter) -> ScaffoldRun:
    return ScaffoldRun(cfg, traffic, seed, device, meter)
