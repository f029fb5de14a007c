"""allreduce_busbw_pct.admm: the consensus rounds' all-reduce bus bandwidth
as a share of NVLink's 450 GB/s a direction: the bytes the profiled rounds
all-reduce (benchmark/counts/admm.py, from the shared rows the benchmark
built) x 2 (R - 1) / R, over the summed device time of the NCCL all-reduce
kernels in rank 0's profiled segment."""

from benchmark.counts import admm

MOVES = "train_step_ms"


def read(obs):
    nbytes, ranks = obs.counts.get("admm_round_bytes"), obs.counts.get("admm_ranks")
    rounds = obs.counts.get("admm_rounds_profiled")
    seconds = 1e-6 * sum(dur for name, _, dur in obs.kernels if "AllReduce" in name)
    if not nbytes or not ranks or not rounds or seconds <= 0:
        return None
    return 100.0 * admm.bus_bytes(nbytes * rounds, ranks) / seconds / admm.NVLINK_BYTES_PER_S
