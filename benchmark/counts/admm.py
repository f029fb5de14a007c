"""Bytes of one ADMM consensus round over ranks, and the link's peak, for
`allreduce_busbw_pct.admm`.

A round all-reduces one float32 buffer of the shared rows (the global rows
that two or more blocks hold): each row's parameters (59 floats at SH
degree 3) and its count, then the twelve residual sums. A ring all-reduce
over R ranks moves 2 (R - 1) / R of the buffer through each rank's link in
each direction (NCCL's bus bandwidth). The link: NVLink 4 between the
H100s of one HGX board, 450 GB/s in each direction (NVIDIA's data sheet,
900 GB/s both ways).
"""

from __future__ import annotations

import numpy as np

NVLINK_BYTES_PER_S = 450e9
RESIDUALS = 12


def row_floats(sh_degree: int) -> int:
    """A Gaussian's parameters: position 3, SH 3 (degree + 1)^2, scale 3,
    rotation 4, opacity 1."""
    return 3 + 3 * (sh_degree + 1) ** 2 + 3 + 4 + 1


def shared_row_count(block_ids: list) -> int:
    """Global rows held by two or more blocks."""
    held = np.bincount(np.concatenate([np.asarray(i, np.int64) for i in block_ids]))
    return int((held >= 2).sum())


def round_bytes(n_shared: int, row_floats: int) -> int:
    """Bytes one round all-reduces: the shared rows with their count, and
    the residual sums."""
    return 4 * (n_shared * (row_floats + 1) + RESIDUALS)


def bus_bytes(nbytes: float, ranks: int) -> float:
    return nbytes * 2.0 * (ranks - 1) / ranks
