"""consensus_ms.admm: host ms of one consensus round over the ranks, from
every rank's device drained to the residuals read on rank 0's host, mean
over the traced run's timed rounds (benchmark span)."""

MOVES = "train_step_ms"


def read(obs):
    rounds = obs.spans.get("admm_round_s") or []
    if not rounds:
        return None
    return 1e3 * sum(rounds) / len(rounds)
