"""Step-indexed training schedules (reference:
conerf/trainers/gaussian_trainer.py:309-330).

The port's copy of the rules in dogs_tpu/train/schedule.py, which both
packages must apply alike (tests/test_torch_densify.py holds them against
each other over a grid of steps and configs). Step chaining is not ported,
so its chunk rule is not copied.
"""

from __future__ import annotations


def active_sh_degree(cfg, step: int) -> int:
    """SH-degree annealing: +1 every `sh_increase_interval` steps."""
    return min(step // cfg.sh_increase_interval, cfg.max_sh_degree)


def c2f_interval(cfg) -> int:
    """Steps per coarse-to-fine stage."""
    return max(min(20000, cfg.densify_end_iter) // 3, 1)


def training_resolution(cfg, step: int) -> int:
    """Coarse-to-fine downsample factor: 4 below c2f_interval, 2 below twice
    it, then 1 (dogs_tpu's docstring says 8 -> 4 -> 2 -> 1; its code, which
    both packages run, never gives 8)."""
    if not cfg.coarse_to_fine:
        return 1
    return 2 ** max(3 - step // c2f_interval(cfg) - 1, 0)
