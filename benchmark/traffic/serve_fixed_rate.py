"""Driver `serve_fixed_rate`: one viewer requesting frames at a fixed rate.

The program's `GaussianSplatEvaluator` over `n_gaussians` Gaussians drawn
from the seed (the model of the training cell), serving `n_poses` poses
drawn from the seed around the bench cameras' origin, in order and round
again. Request i is due at i / `rate_hz` seconds into the window (an open
loop: a late frame does not delay the schedule, it makes the next requests
wait). A request is `evaluator.render(camera)` and the frame's copy to the
host, timed from its due time to the frame on the host, so a stall's wait
counts in the requests behind it. `render_p95_ms` is the 95th percentile of
every request due in the window. The rate is about four fifths of the
highest the card sustained in a sweep (PERF.md).

Checked: `check_requests` of the window's requests, drawn from the seed
over all of them (a reservoir), each frame against the reference's render
of its pose.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark import compare, counts, program, scenes
from benchmark.traffic.train_step import bounds, count_view, raster_config, reference_render

MODEL, POSES, SAMPLE = 1, 4, 5


class ServeRun:
    def __init__(self, cfg, traffic, seed, device, meter):
        from dogs_tpu_torch.eval.evaluator import EvalConfig, GaussianSplatEvaluator
        from dogs_tpu_torch.fields.model import GaussianModelState, fresh_stats

        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, torch.device(device)
        t = traffic
        self.poses = scenes.viewer_poses(t["n_poses"], seed, POSES, cfg["width"], cfg["height"], t["focal"],
                                         t["yaw_deg"], t["pitch_deg"], t["xy"], tuple(t["z_range"]))
        meter.start()
        n = t["n_gaussians"]
        leaves = scenes.box_scene(n, seed, MODEL, self.device, sh_rest=t["sh_rest"])
        model = GaussianModelState(program.params(leaves), torch.ones((n,), dtype=torch.bool, device=self.device),
                                   *fresh_stats(n, self.device))
        del leaves
        self.evaluator = GaussianSplatEvaluator(model, raster_config(cfg),
                                                EvalConfig(active_sh_degree=cfg["max_sh_degree"]))
        self.cams = [program.camera(p, self.device) for p in self.poses]
        for cam in self.cams[: t["warm_requests"]]:
            self.evaluator.render(cam).cpu()
        self.next = t["warm_requests"]

    def window(self, seconds: float, tracer=None) -> dict:
        k, n = self.traffic["check_requests"], len(self.cams)
        period = 1.0 / self.traffic["rate_hz"]
        rng = np.random.RandomState(scenes.stream_seed(self.seed, SAMPLE) % 2**32)
        self.kept: list[tuple[int, torch.Tensor]] = []
        lat, enq, svc, profiled, traced_s, late = [], [], [], [], 0.0, 0.0
        i = 0
        t0 = time.perf_counter()
        while True:
            due = t0 + traced_s + i * period
            if due - t0 - traced_s >= seconds:
                break
            if tracer is not None and not profiled and due - t0 >= seconds / 2:
                k0 = time.perf_counter()
                with tracer.segment():  # its requests run back to back, off the schedule
                    for _ in range(self.traffic["profile_requests"]):
                        self.evaluator.render(self.cams[self.next % n]).cpu()
                        profiled.append(self.next % n)
                        self.next += 1
                traced_s += time.perf_counter() - k0
                continue
            while time.perf_counter() < due:
                time.sleep(min(max(due - time.perf_counter() - 2e-4, 0.0), period))
            p = self.next % n
            r0 = time.perf_counter()
            late = max(late, r0 - due)
            img = self.evaluator.render(self.cams[p])
            r1 = time.perf_counter()
            frame = img.cpu()
            r2 = time.perf_counter()
            lat.append(r2 - due)
            enq.append(r1 - r0)
            svc.append(r2 - r0)
            if i < k:
                self.kept.append((p, frame))
            else:
                j = rng.randint(0, i + 1)
                if j < k:
                    self.kept[j] = (p, frame)
            i += 1
            self.next += 1
        self.profiled = profiled
        self.late_s = late
        self.frame_ms = 1e3 * float(np.mean(svc))
        print(f"serve: {len(lat)} requests at {self.traffic['rate_hz']} Hz, the generator at most "
              f"{1e3 * late:.3f} ms late", file=sys.stderr)
        if tracer is not None:
            tracer.spans["enqueue"] = enq
        p95 = float(np.percentile(np.asarray(lat) * 1e3, 95))
        return dict(e2e=dict(render_p95_ms=p95), attempted=len(lat), failed=0, t0=t0)

    def count(self, tracer) -> None:
        m = self.evaluator.model
        leaves = dict(program.leaves_of(m.params), alive=m.alive)
        deg = self.cfg["max_sh_degree"]
        per = {p: count_view(leaves, self.poses[p], self.device, deg, self.cfg["max_tiles_per_gaussian"])
               for p in set(self.profiled)}
        tracer.counts["blend_forward_bound_s"] = [bounds(per[p])[0] for p in self.profiled]
        tracer.counts["frame_flops"] = float(np.mean(
            [counts.frame_flops(per[p]["drawn"], deg, per[p]["visited"], per[p]["contributing"])
             for p in self.profiled]))
        tracer.counts["untraced_frame_ms"] = self.frame_ms

    def verify(self) -> dict:
        del self.evaluator, self.cams
        program.free(self.device)
        t = self.traffic
        leaves = scenes.box_scene(t["n_gaussians"], self.seed, MODEL, self.device, sh_rest=t["sh_rest"])
        control = self.cfg.get("control_dtype")
        gaps = []
        for p, frame in self.kept:
            ref = reference_render(leaves, self.poses[p], self.device, self.cfg["max_sh_degree"],
                                   self.cfg["max_tiles_per_gaussian"])
            if control:  # the reference in a lower precision in the program's place
                low = {k: v.to(getattr(torch, control)) for k, v in leaves.items()}
                frame = reference_render(low, self.poses[p], self.device, self.cfg["max_sh_degree"],
                                         self.cfg["max_tiles_per_gaussian"]).float()
            gaps.append(compare.rms(torch.clamp(frame.to(self.device), 0.0, 1.0), torch.clamp(ref, 0.0, 1.0)))
        return dict(rms_gap=max(gaps) if gaps else float("inf"))


def build(cfg: dict, traffic: dict, seed: int, device, meter) -> ServeRun:
    return ServeRun(cfg, traffic, seed, device, meter)
