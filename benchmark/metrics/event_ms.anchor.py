"""event_ms.anchor: host ms that a Scaffold-GS anchor event (grow and
prune) adds to its step, measured as event_ms.densify is."""

from benchmark import profiling

MOVES = "train_step_ms"


def read(obs):
    return profiling.event_ms(obs, "anchor")
