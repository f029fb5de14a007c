"""event_ms.densify: host ms that a densify event adds to its step (the
trainer call that ran step and event, synchronized, less the plain call
before it), mean over the window's events; traced run only."""

from benchmark import profiling

MOVES = "train_step_ms"


def read(obs):
    return profiling.event_ms(obs, "densify")
