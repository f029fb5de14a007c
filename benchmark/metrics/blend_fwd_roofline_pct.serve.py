"""blend_fwd_roofline_pct.serve: K1's least time over its device time in
the profiled frame requests."""

from benchmark import profiling

MOVES = "render_p95_ms"
PREFIXES = ("(anonymous namespace)::blend_forward_kernel(", "blend_forward_kernel(")


def read(obs):
    return profiling.roofline_pct(obs, PREFIXES, "blend_forward_bound_s")
