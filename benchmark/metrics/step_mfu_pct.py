"""step_mfu_pct: the step's counted flops (benchmark/counts) over its time
(the traced run's window outside the profiled segment) times the H100's
67 TFLOP/s float32 peak."""

from benchmark import profiling

MOVES = "train_step_ms"


def read(obs):
    return profiling.mfu_pct(obs)
