"""blend_fwd_roofline_pct.train: K1's least time (counts.blend_bound of
each profiled step's inputs) over its device time in the profiled steps."""

from benchmark import profiling

MOVES = "train_step_ms"
PREFIXES = ("(anonymous namespace)::blend_forward_kernel(", "blend_forward_kernel(")


def read(obs):
    return profiling.roofline_pct(obs, PREFIXES, "blend_forward_bound_s")
