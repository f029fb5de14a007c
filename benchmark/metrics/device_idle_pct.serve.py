"""device_idle_pct.serve: the same, over steady frame requests."""

from benchmark import profiling

MOVES = "render_p95_ms"


def read(obs):
    return profiling.idle_pct(obs)
