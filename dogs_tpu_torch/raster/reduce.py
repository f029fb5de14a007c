"""K -> N reduction of per-entry blend gradients: the Hopper kernel and its
plain PyTorch version.

Port of dogs_tpu/raster/pallas_reduce.py:sorted_segment_sum_pallas (K3) and
of the id sort around it (dogs_tpu/raster/tiled.py:476-518). The blend
backward gives one gradient row per (Gaussian, tile) entry in tile order.
The JAX package sorts those rows by Gaussian id and sums each id's run; here
nothing is sorted. Binning expands the entries Gaussian-major, each
Gaussian's tiles in ascending order, and its key sort is stable, so the
inverse of that sort's permutation lists each Gaussian's tile-order
positions in one ascending run (`gaussian_runs`): the positions, in the
order, that a stable sort of the ids would give. `sorted_segment_sum`
(csrc/segment_sum.cu; its header says what bounds it) sums each run's rows,
gathered through that list, in list order, so the gradient is bit for bit
the one of a stable id sort, a row gather and an in-order sum.

`reduce_dtype="bf16"` rounds every per-entry gradient to bf16 (round to
nearest even, as `pack_bf16_pairs` does) before the f32 sum, which is the JAX
package's default reduce; the sum itself is f32 either way. The TPU's
pair-packed int32 payloads, PERM/INV_PERM column order and windowed one-hot
matmuls are MXU layout and are not carried.
"""

from __future__ import annotations

import ctypes

import torch

from dogs_tpu_torch import kernels
from dogs_tpu_torch.raster.blend import ENT_WIDTH, N_GRADS

_VP, _INT = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_VP, _VP, _VP, _VP, _INT, _INT, _VP)
REDUCE_DTYPES = ("f32", "bf16")


def _check_inputs(rows: torch.Tensor, src: torch.Tensor, starts: torch.Tensor, n_out: int,
                  reduce_dtype: str) -> None:
    if reduce_dtype not in REDUCE_DTYPES:
        raise ValueError(f"reduce_dtype must be one of {REDUCE_DTYPES}, got {reduce_dtype!r}")
    if rows.dtype != torch.float32 or rows.dim() != 2 or rows.shape[1] != ENT_WIDTH:
        raise ValueError(f"rows must be (K, {ENT_WIDTH}) float32, got {tuple(rows.shape)} {rows.dtype}")
    k = rows.shape[0]
    if src.dtype != torch.int32 or tuple(src.shape) != (k,):
        raise ValueError(f"src must be ({k},) int32, got {tuple(src.shape)} {src.dtype}")
    if starts.dtype != torch.int32 or tuple(starts.shape) != (n_out + 1,):
        raise ValueError(f"starts must be ({n_out + 1},) int32, got {tuple(starts.shape)} {starts.dtype}")
    if not (rows.is_contiguous() and src.is_contiguous() and starts.is_contiguous()):
        raise ValueError("rows, src and starts must be contiguous")


def sorted_segment_sum(
    rows: torch.Tensor, src: torch.Tensor, starts: torch.Tensor, n_out: int, reduce_dtype: str = "f32"
) -> torch.Tensor:
    """Launch the Hopper segment-sum kernel on the current stream (no sync).

    rows (K, 16) f32, src (K,) int32, starts (n_out + 1,) int32 -> (n_out,
    16) f32: row g is the sum, in i order from 0.0, of rows[src[i], :10]
    (bf16-rounded for "bf16") over i in [starts[g], starts[g + 1]); columns
    10-15 are zero. CUDA tensors only (`sorted_segment_sum_reference` is the
    plain version). `src` in [0, K) and `starts` nondecreasing up to K are
    not checked: reading them back would synchronize."""
    kernels.require_cuda("sorted_segment_sum", rows, src, starts)
    _check_inputs(rows, src, starts, n_out, reduce_dtype)
    if rows.data_ptr() % 16:
        raise ValueError("sorted_segment_sum: rows must be 16-byte aligned (the kernel reads float4s)")
    out = torch.empty((n_out, ENT_WIDTH), dtype=torch.float32, device=rows.device)
    kernels.launch("segment_sum", "dogs_segment_sum", _ARGTYPES, rows.data_ptr(), src.data_ptr(), starts.data_ptr(),
                   out.data_ptr(), n_out, int(reduce_dtype == "bf16"), device=rows.device)
    return out


def sorted_segment_sum_reference(
    rows: torch.Tensor, src: torch.Tensor, starts: torch.Tensor, n_out: int, reduce_dtype: str = "f32"
) -> torch.Tensor:
    """Plain PyTorch version of `sorted_segment_sum`, on any device: the
    gathered (and rounded) rows of every run are added one position of the
    run at a time, so each sum is taken in i order, as the kernel takes it."""
    _check_inputs(rows, src, starts, n_out, reduce_dtype)
    vals = rows[src.long(), :N_GRADS]
    if reduce_dtype == "bf16":
        vals = vals.to(torch.bfloat16).to(torch.float32)
    out = torch.zeros((n_out, ENT_WIDTH), dtype=torch.float32, device=rows.device)
    first = starts[:-1].long()
    length = starts[1:].long() - first
    g = torch.nonzero(length > 0).squeeze(1)
    t = 0
    while g.numel():
        out[g, :N_GRADS] += vals[first[g] + t]
        t += 1
        g = g[length[g] > t]
    return out


def runs_from_sorted_ids(ids: torch.Tensor, n_out: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(src, starts) for rows already sorted by id, the JAX K3 contract:
    ids (K,) ascending -> src = arange(K), starts[g] = first i with ids[i] >=
    g. Ids outside [0, n_out) fall outside every run and drop out."""
    src = torch.arange(ids.shape[0], dtype=torch.int32, device=ids.device)
    bounds = torch.arange(n_out + 1, dtype=ids.dtype, device=ids.device)
    return src, torch.searchsorted(ids, bounds).to(torch.int32)


def gaussian_runs(
    order: torch.Tensor, sorted_idx: torch.Tensor, n_out: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(src, starts) of the tile-order entries, from binning's key-sort
    permutation `order` (sorted position -> Gaussian-major position) and the
    entries' Gaussian ids `sorted_idx` (K,) in [0, n_out): src, the inverse
    permutation, lists each Gaussian's tile-order positions in ascending
    order, and starts is the exclusive cumsum of the per-Gaussian entry
    counts. No sort and no host sync."""
    k = order.shape[0]
    dev = order.device
    src = torch.empty(k, dtype=torch.int32, device=dev)
    src.scatter_(0, order, torch.arange(k, dtype=torch.int32, device=dev))
    starts = torch.zeros(n_out + 1, dtype=torch.int32, device=dev)
    starts[1:].index_add_(0, sorted_idx, torch.ones((), dtype=torch.int32, device=dev).expand(k))
    return src, starts.cumsum_(0)


def reduce_entries(
    d_ent: torch.Tensor,
    order: torch.Tensor,
    sorted_idx: torch.Tensor,
    n_out: int,
    reduce_dtype: str = "f32",
    use_kernel: bool = True,
) -> torch.Tensor:
    """Sum per-entry gradient rows (K, 16), in tile order, into per-Gaussian
    rows (n_out, 16).

    `order` is binning's key-sort permutation, `sorted_idx` (K,) each
    entry's Gaussian id. On CUDA tensors with `use_kernel` the sum is the
    kernel; otherwise the plain version."""
    src, starts = gaussian_runs(order, sorted_idx, n_out)
    if d_ent.is_cuda and use_kernel:
        return sorted_segment_sum(d_ent, src, starts, n_out, reduce_dtype)
    return sorted_segment_sum_reference(d_ent, src, starts, n_out, reduce_dtype)
