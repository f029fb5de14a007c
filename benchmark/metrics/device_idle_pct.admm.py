"""device_idle_pct.admm: 100 (1 - the union of device intervals / the
profiled segment) on rank 0's card, over one interval of ADMM steps and
its consensus round."""

from benchmark import profiling

MOVES = "train_step_ms"


def read(obs):
    return profiling.idle_pct(obs)
