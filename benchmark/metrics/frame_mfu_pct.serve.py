"""frame_mfu_pct.serve: a frame's counted flops (benchmark/counts: projection
and SH forward and K1's blend, over the profiled frames' poses) over the
mean untraced service time of the window's requests (render and copy,
from the call to the frame on the host) times the H100's 67 TFLOP/s
float32 peak."""

from benchmark import profiling

MOVES = "render_p95_ms"


def read(obs):
    return profiling.mfu_pct(obs, "frame_flops", "untraced_frame_ms")
