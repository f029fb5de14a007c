"""enqueue_ms.serve: host ms from `GaussianSplatEvaluator.render` to its
return, before the frame's copy waits for the device; mean over the
window's requests. Binning reads its entry count back, so this includes the
device's projection."""

MOVES = "render_p95_ms"


def read(obs):
    enq = obs.spans.get("enqueue") or []
    return 1e3 * sum(enq) / len(enq) if enq else None
