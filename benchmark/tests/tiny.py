"""Tiny sizes of every cell, for running the drivers on the CPU in tests."""

from __future__ import annotations

import copy

from benchmark import harness

SIZES = {
    "train_step": dict(n_gaussians=3000, n_teacher=2000, profile_steps=2),
    "scaffold_train": dict(n_points=3000, n_teacher=2000, warm_steps=5, profile_steps=2),
    "quality_run": dict(n_teacher=4000, n_views=8, focal=60.0, val_step=40, warm_steps=5, profile_steps=2,
                        count_views=2, init_sample=64),
    "serve_fixed_rate": dict(n_gaussians=3000, n_poses=8, focal=55.0, warm_requests=2, check_requests=3,
                              profile_requests=2),
}
SECONDS = {"train_step": 1.0, "scaffold_train": 4.0, "quality_run": 15.0, "serve_fixed_rate": 1.0}


def cell(name: str) -> tuple[dict, dict, dict, dict]:
    """(spec, workload, config, traffic) of cell `name` at a 64 x 48 frame,
    with its events every 10 steps from step 5."""
    spec = harness.spec()
    wl = harness.cell(spec, name)
    cfg = dict(harness.config(spec, wl["config"]), width=64, height=48)
    traffic = copy.deepcopy(harness.traffic(wl["traffic"]))
    traffic.update(SIZES[traffic["driver"]])
    if traffic["driver"] in ("quality_run", "scaffold_train"):
        cfg.update(densify_start_iter=5, densification_interval=10)
        traffic["overrides"] = dict(traffic.get("overrides", {}), densify_start_iter=5, densification_interval=10)
    return spec, wl, cfg, traffic
