"""K -> N reduction of per-entry blend gradients: the Hopper kernel and its
plain PyTorch version.

Port of dogs_tpu/raster/pallas_reduce.py:sorted_segment_sum_pallas (K3) and
of the id sort around it (dogs_tpu/raster/tiled.py:476-518). The blend
backward gives one gradient row per (Gaussian, tile) entry in tile order;
`reduce_entries` sorts the rows by Gaussian id (a stable `torch.sort`,
outside any kernel, as `lax.sort` is in JAX) and sums each id's run into one
row per Gaussian with `sorted_segment_sum` (csrc/segment_sum.cu; its header
says what bounds it).

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
from dogs_tpu_torch.raster.blend import ENT_WIDTH, N_GRADS, require_cuda

_VP, _INT = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_VP, _VP, _VP, _INT, _INT, _VP)
REDUCE_DTYPES = ("f32", "bf16")


def _check_inputs(ids: torch.Tensor, vals: torch.Tensor) -> None:
    if ids.dtype != torch.int32 or ids.dim() != 1:
        raise ValueError(f"ids must be (K,) int32, got {tuple(ids.shape)} {ids.dtype}")
    if vals.dtype != torch.float32 or tuple(vals.shape) != (ids.shape[0], N_GRADS):
        raise ValueError(
            f"vals must be ({ids.shape[0]}, {N_GRADS}) float32, got {tuple(vals.shape)} {vals.dtype}"
        )
    if not (ids.is_contiguous() and vals.is_contiguous()):
        raise ValueError("ids and vals must be contiguous")


def sorted_segment_sum(ids: torch.Tensor, vals: torch.Tensor, n_out: int) -> torch.Tensor:
    """Launch the Hopper segment-sum kernel on the current stream (no sync).

    ids (K,) int32 in ascending order, vals (K, 10) f32 -> (n_out, 16) f32:
    row g is the sum of the rows with id g, columns 10-15 are zero, ids >=
    n_out are dropped. CUDA tensors only (`sorted_segment_sum_reference` is
    the plain version). The order of `ids` is not checked: reading it back
    would synchronize."""
    require_cuda("sorted_segment_sum", ids, vals)
    _check_inputs(ids, vals)
    launch = kernels.launcher("segment_sum", "dogs_segment_sum", _ARGTYPES)
    out = torch.empty((n_out, ENT_WIDTH), dtype=torch.float32, device=vals.device)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(ids.data_ptr(), vals.data_ptr(), out.data_ptr(), ids.shape[0], n_out, stream)
    if err != 0:
        raise RuntimeError(f"sorted_segment_sum kernel launch failed: CUDA error {err}")
    sorted_segment_sum.launches += 1
    return out


sorted_segment_sum.launches = 0  # kernel launches since the last reset


def sorted_segment_sum_reference(ids: torch.Tensor, vals: torch.Tensor, n_out: int) -> torch.Tensor:
    """Plain PyTorch version of `sorted_segment_sum`, on any device: an
    `index_add_` of the rows whose id is in [0, n_out)."""
    _check_inputs(ids, vals)
    out = torch.zeros((n_out, ENT_WIDTH), dtype=torch.float32, device=vals.device)
    keep = (ids >= 0) & (ids < n_out)
    out[:, :N_GRADS].index_add_(0, ids[keep].long(), vals[keep])
    return out


def sort_by_gaussian(
    d_ent: torch.Tensor, sorted_idx: torch.Tensor, reduce_dtype: str
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-entry gradient rows (K, 16) in tile order -> (ids (K,) int32
    ascending, vals (K, 10) f32) in Gaussian order, bf16-rounded for
    reduce_dtype "bf16"."""
    if reduce_dtype not in REDUCE_DTYPES:
        raise ValueError(f"reduce_dtype must be one of {REDUCE_DTYPES}, got {reduce_dtype!r}")
    ids, order = torch.sort(sorted_idx.to(torch.int32), stable=True)
    vals = d_ent[order, :N_GRADS]
    if reduce_dtype == "bf16":
        vals = vals.to(torch.bfloat16).to(torch.float32)
    return ids, vals.contiguous()


def reduce_entries(
    d_ent: torch.Tensor,
    sorted_idx: torch.Tensor,
    n_out: int,
    reduce_dtype: str = "f32",
    use_kernel: bool = True,
) -> torch.Tensor:
    """Sum per-entry gradient rows (K, 16) into per-Gaussian rows (n_out, 16).

    `sorted_idx` (K,) is each entry's Gaussian id. On CUDA tensors with
    `use_kernel` the sum is the kernel; otherwise the plain version."""
    ids, vals = sort_by_gaussian(d_ent, sorted_idx, reduce_dtype)
    if d_ent.is_cuda and use_kernel:
        return sorted_segment_sum(ids, vals, n_out)
    return sorted_segment_sum_reference(ids, vals, n_out)
