"""Mean squared distance to the k nearest neighbours, for scale init.

Port of dogs_tpu/core/knn.py:mean_knn_dist_sq (the reference's
`simple_knn._C.distCUDA2`). Exact for every N: the query points go in chunks
against all points, the squared distances summed over the coordinates as
the JAX exact search sums them (no matmul expansion, which would cancel
digits), then a top-k. The JAX package is exact up to N = 2048 and switches
to a windowed Morton-order search above; this port keeps the exact search,
which is O(N^2) elementwise work in chunks of bounded memory. (`torch.cdist` is not used: its CUDA kernel runs
one thread block per distance.)
"""

from __future__ import annotations

import torch

_BIG = 1e30


def mean_knn_dist_sq(
    points: torch.Tensor,
    valid: torch.Tensor | None = None,
    k: int = 3,
    chunk: int = 4096,
) -> torch.Tensor:
    """(N, 3) points -> (N,) mean squared distance to the k nearest other
    valid points, `chunk` query points at a time. Invalid points are no
    one's neighbour and get 0; a point with fewer than k valid neighbours
    counts the missing ones as 0."""
    n = points.shape[0]
    # A chunk's distance matrix stays under 2^28 entries (1 GiB).
    chunk = max(1, min(chunk, (1 << 28) // max(n, 1)))
    points = points.to(torch.float32)
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=points.device)
    out = torch.zeros((n,), dtype=torch.float32, device=points.device)
    for i0 in range(0, n, chunk):
        q = points[i0 : i0 + chunk]
        d2 = (q[:, None, 0] - points[None, :, 0]) ** 2
        for c in range(1, points.shape[1]):
            d2 += (q[:, None, c] - points[None, :, c]) ** 2
        rows = torch.arange(i0, i0 + q.shape[0], device=points.device)
        d2[torch.arange(q.shape[0], device=points.device), rows] = _BIG  # not its own neighbour
        d2.masked_fill_(~valid[None, :], _BIG)
        knn = torch.topk(d2, min(k, n), dim=1, largest=False).values
        knn = torch.where(knn >= _BIG, 0.0, knn)
        if knn.shape[1] < k:  # fewer than k points in all: the rest count as 0
            knn = torch.cat([knn, torch.zeros((knn.shape[0], k - knn.shape[1]), device=knn.device)], 1)
        out[i0 : i0 + q.shape[0]] = knn.mean(dim=1)
    return torch.where(valid, out, 0.0)
