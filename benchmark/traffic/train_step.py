"""Driver `train_step`: the 3DGS train step at a block's size.

The program's `make_train_step` on `train_state_from_model` of
`n_gaussians` alive Gaussians drawn from the seed, stepped over the bench
cameras in rotation against the benchmark's plain renders of a teacher
scene. No host events run: the step is the whole of the work.

Set-up: the teacher's renders (benchmark, not metered), the model, the
state and the step (program), then steps 1-3 on cameras 0, 1, 2 (the
checked steps) and a warm round over the remaining cameras. The window
steps on from there; `train_step_ms` is its length over the steps it
completed, the last one synchronized.
"""

from __future__ import annotations

import time

import torch

from benchmark import compare, counts, program, scenes
from benchmark.reference import gs3d, raster

MODEL, TEACHER = 1, 2  # streams of draws


def trainer_config(cfg: dict, overrides: dict):
    from dogs_tpu_torch.train.trainer import TrainerConfig

    keys = ("max_iterations", "lambda_dssim", "lambda_scale", "position_lr_init", "position_lr_final",
            "position_lr_delay_mult", "position_lr_max_steps", "feature_lr", "opacity_lr", "scaling_lr",
            "quaternion_lr", "percent_dense", "densify_start_iter", "densify_end_iter", "densification_interval",
            "opacity_reset_interval", "densify_grad_threshold", "min_opacity", "size_threshold",
            "max_sh_degree", "sh_increase_interval", "spatial_lr_scale")
    merged = {**cfg, **overrides}
    return TrainerConfig(**{k: merged[k] for k in keys if k in merged})


def raster_config(cfg: dict):
    from dogs_tpu_torch.raster.tiled import RasterConfig

    return RasterConfig(max_tiles_per_gaussian=cfg["max_tiles_per_gaussian"], depth_threshold=cfg["depth_threshold"],
                        antialiasing=cfg.get("antialiasing", False), reduce_dtype=cfg.get("reduce_dtype", "f32"))


@torch.no_grad()
def reference_render(leaves: dict, pose: dict, device, sh_degree: int, max_tiles: int) -> torch.Tensor:
    """The benchmark's plain render of `leaves` from `pose` on black."""
    g = dict(xyz=leaves["xyz"], log_scale=leaves["log_scale"], quat=leaves["quat"],
             logit_opacity=leaves["logit_opacity"], feat=torch.cat([leaves["feat_dc"], leaves["feat_rest"]], 1))
    view = scenes.view(pose, device, leaves["xyz"].dtype)
    proj = raster.project(g, view, sh_degree)
    color, _, _, _ = raster.blend(raster.entry_rows(proj), *raster.tile_lists(proj, view.width, view.height, max_tiles),
                                  view.width, view.height)
    return color


@torch.no_grad()
def count_view(leaves: dict, pose: dict, device, sh_degree: int, max_tiles: int) -> dict:
    """What one step or frame at `pose` needs: drawn Gaussians, entries,
    distinct rows, tiles, visited and contributing pairs, pixels."""
    g = dict(xyz=leaves["xyz"], log_scale=leaves["log_scale"], quat=leaves["quat"],
             logit_opacity=leaves["logit_opacity"], feat=torch.cat([leaves["feat_dc"], leaves["feat_rest"]], 1))
    view = scenes.view(pose, device)
    alive = leaves.get("alive")
    proj = raster.project(g, view, sh_degree, alive=alive)
    gid, starts, ntx, nty = raster.tile_lists(proj, view.width, view.height, max_tiles)
    _, _, visited, contributing = raster.blend(raster.entry_rows(proj), gid, starts, ntx, nty, view.width,
                                               view.height)
    return dict(drawn=int((proj["radius"] > 0).sum()), entries=int(gid.shape[0]),
                rows=int(torch.unique(gid).shape[0]), n_tiles=ntx * nty, visited=visited,
                contributing=contributing, pixels=view.width * view.height)


def bounds(c: dict) -> tuple[float, float]:
    return tuple(counts.blend_bound(kind, c["visited"], c["contributing"], c["rows"], c["entries"], c["n_tiles"])
                 for kind in ("forward", "backward"))


class StepRun:
    def __init__(self, cfg, traffic, seed, device, meter):
        from dogs_tpu_torch.fields.model import GaussianModelState, fresh_stats
        from dogs_tpu_torch.train import trainer as trainer_mod

        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, torch.device(device)
        w, h = cfg["width"], cfg["height"]
        self.poses = scenes.bench_poses(traffic["n_cameras"], w, h)
        teacher = scenes.box_scene(traffic["n_teacher"], seed, TEACHER, self.device, sh_rest=0.0)
        self.gts = [reference_render(teacher, p, self.device, 0, cfg["max_tiles_per_gaussian"]) for p in self.poses]
        del teacher
        program.free(self.device)

        meter.start()
        n = traffic["n_gaussians"]
        leaves = scenes.box_scene(n, seed, MODEL, self.device, sh_rest=traffic["sh_rest"])
        model = GaussianModelState(program.params(leaves), torch.ones((n,), dtype=torch.bool, device=self.device),
                                   *fresh_stats(n, self.device))
        del leaves
        self.tcfg = trainer_config(cfg, traffic.get("overrides", {}))
        self.ts = trainer_mod.train_state_from_model(model, n_images=len(self.poses), cfg=self.tcfg)
        self.step = trainer_mod.make_train_step(self.tcfg, raster_config(cfg), traffic["spatial_lr_scale"],
                                                active_sh_degree=cfg["max_sh_degree"], background=(0.0, 0.0, 0.0))
        self.cams = [program.camera(p, self.device, i) for i, p in enumerate(self.poses)]
        n_check = traffic["check_steps"]
        losses, grad = [], None
        for i in range(n_check):
            self.ts, m = self.step(self.ts, self.cams[i], self.gts[i])
            losses.append(m["loss"])
            if i == 0:
                grad = compare.norms({k: v / 0.1 for k, v in self.ts.opt.mu.items()})
        meter.stop()
        p0 = scenes.box_scene(n, seed, MODEL, self.device, sh_rest=traffic["sh_rest"])
        change = compare.norms({k: v - p0[k] for k, v in program.leaves_of(self.ts.model.params).items()})
        del p0
        self.prog = dict(losses=[float(x) for x in losses], grad=grad, change=change)
        program.free(self.device)
        meter.start()
        for i in range(n_check, len(self.cams)):  # the warm round
            self.ts, _ = self.step(self.ts, self.cams[i], self.gts[i])
        self.next = len(self.cams)
        program.sync(self.device)

    def window(self, seconds: float, tracer=None) -> dict:
        n_cams = len(self.cams)
        steps, profiled, traced_s = 0, [], 0.0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 - traced_s < seconds:
            if tracer is not None and not profiled and time.perf_counter() - t0 >= seconds / 2:
                k0 = time.perf_counter()
                with tracer.segment():
                    for _ in range(self.traffic["profile_steps"]):
                        c = self.next % n_cams
                        self.ts, _ = self.step(self.ts, self.cams[c], self.gts[c])
                        profiled.append(c)
                        self.next += 1
                traced_s = time.perf_counter() - k0
                continue
            c = self.next % n_cams
            self.ts, _ = self.step(self.ts, self.cams[c], self.gts[c])
            self.next += 1
            steps += 1
        program.sync(self.device)
        t1 = time.perf_counter()
        total = steps + len(profiled)
        self.profiled = profiled
        self.untraced_ms = 1e3 * (t1 - t0 - traced_s) / max(steps, 1)
        return dict(e2e=dict(train_step_ms=1e3 * (t1 - t0) / total), attempted=total, failed=0, t0=t0)

    def count(self, tracer) -> None:
        leaves = program.leaves_of(self.ts.model.params)
        per_cam = [count_view(leaves, p, self.device, self.cfg["max_sh_degree"], self.cfg["max_tiles_per_gaussian"])
                   for p in self.poses]
        b = [bounds(c) for c in per_cam]
        tracer.counts["blend_forward_bound_s"] = [b[c][0] for c in self.profiled]
        tracer.counts["blend_backward_bound_s"] = [b[c][1] for c in self.profiled]
        tracer.counts["step_flops"] = sum(
            counts.step_flops(c["drawn"], self.cfg["max_sh_degree"], c["visited"], c["contributing"], c["pixels"])
            for c in per_cam) / len(per_cam)
        tracer.counts["untraced_step_ms"] = self.untraced_ms

    def verify(self) -> dict:
        n, n_check = self.traffic["n_gaussians"], self.traffic["check_steps"]
        del self.ts, self.step
        program.free(self.device)
        p0 = scenes.box_scene(n, self.seed, MODEL, self.device, sh_rest=self.traffic["sh_rest"])
        views = [scenes.view(p, self.device) for p in self.poses[:n_check]]
        cfg = {**self.cfg, **self.traffic.get("overrides", {})}
        r = gs3d.follow(p0, torch.ones((n,), dtype=torch.bool, device=self.device), views, self.gts[:n_check], cfg,
                        self.cfg["max_sh_degree"], self.traffic["spatial_lr_scale"])
        ref = dict(losses=r["losses"], grad=compare.norms(r["first_grad"]),
                   change=compare.norms({k: r["params"][k] - p0[k] for k in p0}))
        return compare.training_readings(self.prog, ref)


def build(cfg: dict, traffic: dict, seed: int, device, meter) -> StepRun:
    return StepRun(cfg, traffic, seed, device, meter)
