"""blend_bwd_roofline_pct.train: K2's least time over its device time in
the profiled steps."""

from benchmark import profiling

MOVES = "train_step_ms"
PREFIXES = ("(anonymous namespace)::blend_backward_kernel(", "blend_backward_kernel(")


def read(obs):
    return profiling.roofline_pct(obs, PREFIXES, "blend_backward_bound_s")
