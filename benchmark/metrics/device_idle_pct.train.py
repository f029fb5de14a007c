"""device_idle_pct.train: 100 (1 - the union of device intervals / the
profiled segment), over steady training steps."""

from benchmark import profiling

MOVES = "train_step_ms"


def read(obs):
    return profiling.idle_pct(obs)
