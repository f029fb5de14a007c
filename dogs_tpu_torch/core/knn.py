"""Mean squared distance to the k nearest neighbours, for scale init.

Port of dogs_tpu/core/knn.py:mean_knn_dist_sq (the reference's
`simple_knn._C.distCUDA2`), with the same two regimes:
- up to 2,048 points, an exact search: every pair's squared distance,
  summed over the coordinates as the JAX exact search sums them (no matmul
  expansion, which would cancel digits), then a top-k. (`torch.cdist` is
  not used: its CUDA kernel runs one thread block per distance.)
- above that, dogs_tpu's windowed search: points sorted by their Morton
  code on a 1024^3 grid (a stable sort, as `jnp.argsort` is), and each one
  compared with the 32 before and the 32 after it in that order, in chunks
  of 65,536 queries. It is approximate, as distCUDA2's box-pruned search
  is, and O(N): 64 candidates a point.
"""

from __future__ import annotations

import torch

_BIG = 1e30
EXACT_MAX_POINTS = 2048
WINDOW = 32
_CHUNK = 65536


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits to every 3rd bit position (Morton interleave helper)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_codes(points: torch.Tensor, valid: torch.Tensor | None = None) -> torch.Tensor:
    """(N, 3) float points -> (N,) int32 Morton codes on a 1024^3 grid over
    the bounding box of the (valid) points."""
    if valid is None:
        lo, hi = points.min(dim=0).values, points.max(dim=0).values
    else:
        v = valid[:, None]
        lo = torch.where(v, points, _BIG).min(dim=0).values
        hi = torch.where(v, points, -_BIG).max(dim=0).values
    q = (points - lo) / torch.clamp(hi - lo, min=1e-12)
    q = torch.clamp((q * 1023.0).to(torch.int32), 0, 1023)
    return _part1by2(q[:, 0]) | (_part1by2(q[:, 1]) << 1) | (_part1by2(q[:, 2]) << 2)


def _sq_dist(q: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """Squared distances of q[..., None, :] to cand, summed over the three
    coordinates in order."""
    d2 = (q[..., None, 0] - cand[..., 0]) ** 2
    for c in range(1, q.shape[-1]):
        d2 += (q[..., None, c] - cand[..., c]) ** 2
    return d2


def _top_k_mean(d2: torch.Tensor, k: int) -> torch.Tensor:
    """Mean of the k smallest entries of each row; entries at the sentinel
    (no neighbour) and missing ones count as 0."""
    knn = torch.topk(d2, min(k, d2.shape[1]), dim=1, largest=False).values
    knn = torch.where(knn >= _BIG, 0.0, knn)
    if knn.shape[1] < k:
        knn = torch.cat([knn, knn.new_zeros((knn.shape[0], k - knn.shape[1]))], 1)
    return knn.mean(dim=1)


def _exact(points: torch.Tensor, valid: torch.Tensor, k: int) -> torch.Tensor:
    n = points.shape[0]
    d2 = _sq_dist(points, points[None])
    d2.fill_diagonal_(_BIG)  # not its own neighbour
    d2.masked_fill_(~valid[None, :], _BIG)
    return _top_k_mean(d2, k) if n else d2.new_zeros((0,))


def _windowed(points: torch.Tensor, valid: torch.Tensor, k: int) -> torch.Tensor:
    n = points.shape[0]
    device = points.device
    codes = torch.where(valid, morton_codes(points, valid), 2**30)  # invalid points last
    order = torch.sort(codes, stable=True).indices
    sorted_pts, sorted_valid = points[order], valid[order]
    offsets = torch.cat([torch.arange(-WINDOW, 0, device=device), torch.arange(1, WINDOW + 1, device=device)])
    res = torch.empty((n,), dtype=torch.float32, device=device)
    for i0 in range(0, n, _CHUNK):
        pos = torch.arange(i0, min(i0 + _CHUNK, n), device=device)
        idx = pos[:, None] + offsets[None, :]
        in_range = (idx >= 0) & (idx < n)
        idx = idx.clamp(0, n - 1)
        d2 = _sq_dist(sorted_pts[pos], sorted_pts[idx])
        d2.masked_fill_(~(sorted_valid[idx] & in_range), _BIG)
        res[i0 : i0 + pos.shape[0]] = _top_k_mean(d2, k)
    out = torch.empty_like(res)
    out[order] = res
    return out


def mean_knn_dist_sq(
    points: torch.Tensor,
    valid: torch.Tensor | None = None,
    k: int = 3,
) -> torch.Tensor:
    """(N, 3) points -> (N,) mean squared distance to the k nearest other
    valid points: exact up to 2,048 points, else among the WINDOW points
    before and after each in Morton order. Invalid points are no one's
    neighbour and get 0; a point with fewer than k valid neighbours counts
    the missing ones as 0."""
    n = points.shape[0]
    points = points.to(torch.float32)
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=points.device)
    if n <= EXACT_MAX_POINTS:
        out = _exact(points, valid, k)
    else:
        out = _windowed(points, valid, k)
    return torch.where(valid, out, 0.0)
