"""Driver `quality_run`: a densifying 3DGS run and its held-out quality.

The program's `GaussianSplatTrainer` on bench.py's quality workload: a
surface teacher of `n_teacher` Gaussians (one scene for every run, drawn
from `scene_seed` as bench.py draws its teacher from a fixed seed), rendered
exactly by the benchmark's reference from `n_views` ring cameras (radius
5, f 900); views n_views / 4 and 3 n_views / 4 held out. The student starts
from every other teacher point with 0.01 noise drawn from the run's seed,
so that every seed trains the same scene from another start (the
trainer's own seed, of the camera order and the split draws, is the
configuration's). The
window calls `train(num_iterations=1)` step after step; densify events run
inside it. At step `val_step` (S) the clock stops while the benchmark
renders the held-out views through the program's evaluator and takes the
plain PSNR (no colour correction): `val_psnr_db`. S is reached well inside
the window; a window that ends before S is not correct (`val_step_missed`).

Checked: the program's initial state (the parts the initialisation fixes
exactly, and log-scales no smaller than the exact 3-NN rule gives), steps
1-3 from that state, and the window's first densify event from the
program's state just before it (with its split draw).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import compare, counts, program, scenes
from benchmark.reference import gs3d
from benchmark.reference.loss import psnr
from benchmark.traffic.scaffold_train import camera_order
from benchmark.traffic.train_step import count_view, raster_config, reference_render, trainer_config

TEACHER, NOISE = 2, 3
STATS = ("alive", "grad_accum", "denom", "max_radii2d")


def model_state(model, host: bool = False) -> dict:
    """Copies of the model's leaves and statistics; with `host`, into pinned
    host memory without waiting (stream-ordered, so they hold the values of
    this point of the stream)."""
    out = program.leaves_of(model.params)
    out.update({k: getattr(model, k).detach() for k in STATS})
    return {k: program.host_copy(v) if host else v.clone() for k, v in out.items()}


class QualityRun:
    def __init__(self, cfg, traffic, seed, device, meter):
        from dogs_tpu_torch.train.trainer import GaussianSplatTrainer

        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, torch.device(device)
        s = traffic["val_step"]
        self.merged = {**cfg, **traffic.get("overrides", {}), "max_iterations": s, "position_lr_max_steps": s,
                       "densify_end_iter": s // 2}
        w, h, nv = cfg["width"], cfg["height"], traffic["n_views"]
        poses = scenes.ring_poses(nv, traffic["radius"], w, h, traffic["focal"])
        teacher = scenes.surface_scene(traffic["n_teacher"], traffic["scene_seed"], TEACHER, self.device)
        gts = [reference_render(teacher, p, self.device, 0, cfg["max_tiles_per_gaussian"]) for p in poses]
        val = {nv // 4, 3 * nv // 4}
        self.train_poses = [p for i, p in enumerate(poses) if i not in val]
        self.train_gts = [g for i, g in enumerate(gts) if i not in val]
        self.val_poses = [p for i, p in enumerate(poses) if i in val]
        self.val_gts = [g for i, g in enumerate(gts) if i in val]
        gen = scenes.generator(seed, NOISE, self.device)
        pts = teacher["xyz"][::2]
        pts = pts + 0.01 * torch.randn(pts.shape, generator=gen, device=self.device)
        cols = torch.clamp(teacher["feat_dc"][::2, 0] * scenes.SH_C0 + 0.5, 0.0, 1.0)
        self.points, self.colors = program.as_numpy_points(pts), cols.cpu().numpy()
        del teacher, gts, pts, cols
        program.free(self.device)

        meter.start()
        self.tcfg = trainer_config(self.merged, {})
        self.rcfg = raster_config(cfg)
        cams = [program.camera(p, self.device, i) for i, p in enumerate(self.train_poses)]
        self.trainer = GaussianSplatTrainer(cameras=cams, images=self.train_gts, points=self.points,
                                            colors=self.colors, cfg=self.tcfg, raster_cfg=self.rcfg,
                                            seed=cfg["seed"], device=self.device)
        self.init = model_state(self.trainer.state.model)
        losses, grad = [], None
        for i in range(traffic["check_steps"]):
            m = self.trainer.train(num_iterations=1, log_every=0)
            losses.append(m["loss"])
            if i == 0:
                grad = compare.norms({k: v / 0.1 for k, v in self.trainer.state.opt.mu.items()})
        meter.stop()
        change = compare.norms({k: v - self.init[k]
                                for k, v in program.leaves_of(self.trainer.state.model.params).items()})
        self.prog = dict(losses=[float(x) for x in losses], grad=grad, change=change)
        self.init = {k: v.cpu() for k, v in self.init.items()}
        program.free(self.device)
        meter.start()
        self.trainer.train(num_iterations=traffic["warm_steps"] - traffic["check_steps"], log_every=0)
        self.event = None
        self._hook()
        program.sync(self.device)

    def _hook(self) -> None:
        """Keep the state before and after the window's first densify event,
        and its split draw (device copies, no synchronization)."""
        tr, cfg = self.trainer, self.tcfg
        densify, noise = tr._maybe_densify, tr._split_noise
        drawn = []

        def split_noise(capacity):
            z = noise(capacity)
            drawn.append(z)
            return z

        def maybe_densify(step):
            due = cfg.densify_start_iter < step < cfg.densify_end_iter and step % cfg.densification_interval == 0
            if not due or self.event is not None:
                return densify(step)
            before = model_state(tr.state.model, host=True)
            densify(step)
            self.event = dict(step=step, before=before, after=model_state(tr.state.model, host=True),
                              noise=program.host_copy(drawn[-1]))

        tr._split_noise, tr._maybe_densify = split_noise, maybe_densify

    def window(self, seconds: float, tracer=None) -> dict:
        cfg, s = self.tcfg, self.traffic["val_step"]
        every = cfg.densification_interval
        steps, paused, traced_s, plain_s, alive_seen = 0, 0.0, 0.0, None, []
        self.val_psnr = None
        t0 = time.perf_counter()
        while time.perf_counter() - t0 - paused - traced_s < seconds:
            step = self.trainer.state.step + 1
            if tracer is not None and not traced_s and time.perf_counter() - t0 >= seconds / 2 \
                    and (step + self.traffic["profile_steps"]) // every == step // every \
                    and not step <= s < step + self.traffic["profile_steps"]:
                k0 = time.perf_counter()
                with tracer.segment():
                    self.trainer.train(num_iterations=self.traffic["profile_steps"], log_every=0)
                traced_s = time.perf_counter() - k0
                steps += self.traffic["profile_steps"]
                continue
            event = step % every == 0 and cfg.densify_start_iter < step < cfg.densify_end_iter
            timed = tracer is not None and (event or (step + 1) % every == 0)
            if timed:
                program.sync(self.device)
                k0 = time.perf_counter()
            self.trainer.train(num_iterations=1, log_every=0)
            if timed:
                program.sync(self.device)
                dt = time.perf_counter() - k0
                if event and plain_s is not None:
                    tracer.spans["densify"].append((dt, plain_s))
                plain_s = None if event else dt
                alive_seen.append(int(self.trainer.state.model.num_alive))
            steps += 1
            if self.trainer.state.step == s:
                program.sync(self.device)
                k0 = time.perf_counter()
                self.val_psnr = self.validate()
                paused += time.perf_counter() - k0
        program.sync(self.device)
        t1 = time.perf_counter()
        self.missed = self.val_psnr is None  # then the held-out PSNR is the window's last state's
        if self.missed:
            self.val_psnr = self.validate()
        self.alive_seen = alive_seen + [int(self.trainer.state.model.num_alive)]
        self.untraced_ms = 1e3 * (t1 - t0 - paused - traced_s) / max(steps - self.traffic["profile_steps"]
                                                                      * bool(traced_s), 1)
        return dict(e2e=dict(train_step_ms=1e3 * (t1 - t0 - paused) / steps, val_psnr_db=self.val_psnr),
                    attempted=steps, failed=0, t0=t0)

    @torch.no_grad()
    def validate(self) -> float:
        from dogs_tpu_torch.eval.evaluator import EvalConfig, GaussianSplatEvaluator

        step = self.trainer.state.step
        ev = GaussianSplatEvaluator(self.trainer.state.model, self.rcfg,
                                    EvalConfig(active_sh_degree=self.trainer.active_sh_degree(step)))
        vals = [psnr(ev.render(program.camera(p, self.device)), torch.clamp(g, 0.0, 1.0))
                for p, g in zip(self.val_poses, self.val_gts)]
        return float(np.mean(vals))

    def count(self, tracer) -> None:
        m = self.trainer.state.model
        leaves = dict(program.leaves_of(m.params), alive=m.alive)
        deg = self.trainer.active_sh_degree(self.trainer.state.step)
        picks = self.train_poses[:: max(len(self.train_poses) // self.traffic["count_views"], 1)]
        per = [count_view(leaves, p, self.device, deg, self.cfg["max_tiles_per_gaussian"]) for p in picks]
        end_flops = sum(counts.step_flops(c["drawn"], deg, c["visited"], c["contributing"], c["pixels"])
                        for c in per) / len(per)
        tracer.counts["step_flops"] = end_flops * float(np.mean(self.alive_seen)) / self.alive_seen[-1]
        tracer.counts["untraced_step_ms"] = self.untraced_ms

    def verify(self) -> dict:
        readings = dict(val_step_missed=float(self.missed))
        event = self.event
        del self.trainer
        program.free(self.device)
        self.init = {k: v.to(self.device) for k, v in self.init.items()}
        if event is not None:
            event = {k: ({n: t.to(self.device) for n, t in v.items()} if isinstance(v, dict) else v)
                     for k, v in event.items()}
            event["noise"] = event["noise"].to(self.device)
        readings.update(self._verify_init())
        p0 = {k: self.init[k] for k in gs3d.LEAVES}
        order = camera_order(self.cfg["seed"], len(self.train_poses), self.traffic["check_steps"])
        r = gs3d.follow(p0, self.init["alive"], [scenes.view(self.train_poses[i], self.device) for i in order],
                        [self.train_gts[i] for i in order], self.merged, 0, self.merged["spatial_lr_scale"])
        ref = dict(losses=r["losses"], grad=compare.norms(r["first_grad"]),
                   change=compare.norms({k: r["params"][k] - p0[k] for k in p0}))
        readings.update(compare.training_readings(self.prog, ref))
        del r
        readings.update(self._verify_event(event))
        return readings

    @torch.no_grad()
    def _verify_init(self) -> dict:
        """init_gap: the largest difference of the exactly fixed leaves from
        the rule (positions, DC colour, identity rotation, opacity 0.1, zero
        rest coefficients, the alive mask); init_scale_below: sampled points
        whose log-scale is below log sqrt(the exact mean squared distance to
        their 3 nearest neighbours) by more than 1e-5."""
        n, dev = self.points.shape[0], self.device
        pts = torch.as_tensor(self.points, device=dev)
        init = self.init
        want_dc = (torch.as_tensor(self.colors, device=dev) - 0.5) / scenes.SH_C0
        quat = torch.zeros_like(init["quat"][:n])
        quat[:, 0] = 1
        gaps = [(init["xyz"][:n] - pts).abs().max(), (init["feat_dc"][:n, 0] - want_dc).abs().max(),
                (init["quat"][:n] - quat).abs().max(), init["feat_rest"][:n].abs().max(),
                (init["logit_opacity"][:n] - float(np.log(np.float32(0.1) / np.float32(0.9)))).abs().max(),
                (init["alive"] != (torch.arange(init["alive"].shape[0], device=dev) < n)).sum()]
        gen = scenes.generator(self.seed, NOISE + 1, dev)
        sample = torch.randperm(n, generator=gen, device=dev)[: self.traffic["init_sample"]]
        exact = []
        for chunk in sample.split(128):
            d = ((pts[chunk, None, :] - pts[None, :, :]) ** 2).sum(-1)
            d[torch.arange(chunk.shape[0], device=dev), chunk] = float("inf")
            exact.append(torch.clamp(d.topk(3, largest=False).values.mean(-1), min=1e-7))
        exact = torch.cat(exact)
        below = init["log_scale"][sample, 0] < torch.log(torch.sqrt(exact)) - 1e-5
        return dict(init_gap=float(max(float(g) for g in gaps)), init_scale_below=float(below.sum()))

    @torch.no_grad()
    def _verify_event(self, event) -> dict:
        """densify_alive_miss: slots alive on one side only after the event;
        densify_gap: the largest difference of an alive slot's parameter from
        the reference's, over that leaf's largest magnitude."""
        if event is None:
            return dict(densify_alive_miss=float("inf"), densify_gap=float("inf"))
        before, after = event["before"], event["after"]
        cap = after["alive"].shape[0]
        grown = {k: torch.cat([v, v.new_zeros((cap - v.shape[0],) + v.shape[1:])]) for k, v in before.items()}
        ref = gs3d.densify(grown, event["noise"], self.merged, self.merged["spatial_lr_scale"], None)
        alive = ref["alive"]
        gap = max(float(((after[k] - ref[k])[alive]).abs().max() / ref[k][alive].abs().max().clamp(min=1e-30))
                  for k in gs3d.LEAVES)
        return dict(densify_alive_miss=float((after["alive"] != alive).sum()), densify_gap=gap)


def build(cfg: dict, traffic: dict, seed: int, device, meter) -> QualityRun:
    return QualityRun(cfg, traffic, seed, device, meter)
