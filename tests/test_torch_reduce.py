"""The port's plain K -> N segment sum against the TPU kernel K3
(dogs_tpu/raster/pallas_reduce.py:sorted_segment_sum_pallas, interpret mode),
on the cases of tests/test_pallas_reduce.py, and against the id sort it
replaces.

K3 sums id-sorted bf16-packed payloads; the port's sum reads f32 rows
through a run list. K3's contract is the port's with src = arange(K) and
runs from the sorted ids (`runs_from_sorted_ids`). Where the point is the
sum, both sides are fed f32 values already quantized to bf16; where it is
the rounding, the port rounds unrounded rows itself. The CUDA kernel is held
against the plain version on the card (chip_smoke.py,
tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dogs_tpu.raster.pallas_reduce import pack_bf16_pairs, sorted_segment_sum_pallas
from dogs_tpu_torch.core import look_at_camera, params_from_numpy
from dogs_tpu_torch.data import synthetic
from dogs_tpu_torch.raster import reduce
from dogs_tpu_torch.raster.binning import build_tile_bins
from dogs_tpu_torch.raster.projection import project_gaussians

TOL = dict(rtol=1e-6, atol=1e-6)


def bf16_values(rng, k):
    """(k, 10) f32 values exactly representable in bf16."""
    v = rng.randn(k, 10).astype(np.float32)
    return np.asarray(jnp.asarray(v).astype(jnp.bfloat16).astype(jnp.float32))


def entry_rows(vals):
    """(K, 10) values -> (K, 16) gradient rows, columns 10-15 zero."""
    rows = np.zeros((vals.shape[0], 16), np.float32)
    rows[:, :10] = vals
    return torch.from_numpy(rows)


def both(ids, vals, n_out, reduce_dtype="f32"):
    order = np.argsort(ids, kind="stable")
    ids_s = ids[order].astype(np.int32)
    vals_s = vals[order]
    src, starts = reduce.runs_from_sorted_ids(torch.from_numpy(ids_s), n_out)
    got = reduce.sorted_segment_sum_reference(entry_rows(vals_s), src, starts, n_out, reduce_dtype).numpy()
    packed = tuple(
        pack_bf16_pairs(jnp.asarray(vals_s[:, 2 * i]), jnp.asarray(vals_s[:, 2 * i + 1]))
        for i in range(5)
    )
    want = np.asarray(sorted_segment_sum_pallas(jnp.asarray(ids_s), packed, n_out, interpret=True))
    assert got.shape == want.shape == (n_out, 16)
    np.testing.assert_array_equal(got[:, 10:], 0.0)
    return got, want


@pytest.mark.parametrize("seed", [0, 1])
def test_runs_cross_window_and_chunk_boundaries(seed):
    rng = np.random.RandomState(seed)
    k, n_out = 3001, 1000
    got, want = both(rng.randint(0, n_out, size=k), bf16_values(rng, k), n_out)
    np.testing.assert_allclose(got, want, **TOL)


def test_ids_past_n_out_are_dropped():
    rng = np.random.RandomState(2)
    n_out = 300
    ids = np.concatenate(
        [rng.randint(0, n_out, size=500), np.full(100, n_out + 17), np.full(50, 2**31 - 1)]
    )
    got, want = both(ids, bf16_values(rng, len(ids)), n_out)
    np.testing.assert_allclose(got, want, **TOL)


def test_sparse_ids_leave_absent_rows_zero():
    ids = np.array([0, 0, 5, 1023, 1023, 1023])
    vals = np.arange(60, dtype=np.float32).reshape(6, 10) - 30.0
    got, want = both(ids, vals, 1024)
    np.testing.assert_allclose(got, want, **TOL)
    present = np.zeros(1024, bool)
    present[[0, 5, 1023]] = True
    np.testing.assert_array_equal(got[~present], 0.0)


def test_single_id_long_run():
    rng = np.random.RandomState(3)
    k = 4096
    got, want = both(np.zeros(k, np.int64), bf16_values(rng, k), 64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_bf16_round_inside_the_sum_matches_jax_k3():
    """Unrounded f32 rows: the port rounds each to bf16 itself ("bf16"), JAX
    through pack_bf16_pairs; the sums agree."""
    rng = np.random.RandomState(7)
    k, n_out = 2001, 500
    got, want = both(rng.randint(0, n_out, size=k), rng.randn(k, 10).astype(np.float32), n_out, "bf16")
    np.testing.assert_allclose(got, want, **TOL)


def id_sort_reduce(d_ent, sorted_idx, n, reduce_dtype):
    """The id-sort form of the reduce, as the JAX package orders it: a stable
    id sort, a row gather, the bf16 round, and an in-order index_add_ on the
    CPU."""
    ids, order = torch.sort(sorted_idx.long(), stable=True)
    vals = d_ent[order, :10]
    if reduce_dtype == "bf16":
        vals = vals.to(torch.bfloat16).to(torch.float32)
    out = torch.zeros((n, 16))
    out[:, :10].index_add_(0, ids, vals)
    return out


@pytest.mark.parametrize("reduce_dtype", ["f32", "bf16"])
def test_reduce_entries_sorts_by_gaussian_and_rounds(reduce_dtype):
    """reduce_entries over any entry order whose runs a stable id sort would
    give: equal, bit for bit, to a per-id numpy sum of the (rounded) rows in
    entry order."""
    rng = np.random.RandomState(4)
    k, n = 777, 90
    sorted_idx = rng.randint(0, n, size=k).astype(np.int32)
    # Binning's permutation inverts to the stable id sort's.
    order = np.argsort(np.argsort(sorted_idx, kind="stable"), kind="stable")
    d_ent = np.zeros((k, 16), np.float32)
    d_ent[:, :10] = rng.randn(k, 10)
    got = reduce.reduce_entries(
        torch.from_numpy(d_ent), torch.from_numpy(order), torch.from_numpy(sorted_idx), n, reduce_dtype
    ).numpy()
    vals = d_ent[:, :10]
    if reduce_dtype == "bf16":
        # Round to nearest even on both sides: the rounded rows are exactly JAX's.
        vals = np.asarray(jnp.asarray(vals).astype(jnp.bfloat16).astype(jnp.float32))
    want = np.zeros((n, 16), np.float32)
    np.add.at(want[:, :10], sorted_idx, vals)  # unbuffered: in entry order, in f32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("reduce_dtype", ["f32", "bf16"])
def test_reduce_is_bit_identical_to_the_id_sort_path(reduce_dtype):
    """Runs read through binning's permutation sum the rows a stable id sort
    would gather, in its order: the gradient has the same bits."""
    params = params_from_numpy(synthetic.random_scene_arrays(seed=0), "cpu")
    view = synthetic.RANDOM_SCENE_VIEW
    proj = project_gaussians(params, look_at_camera(**view, device="cpu"), active_sh_degree=2)
    bins = build_tile_bins(proj, view["height"], view["width"], max_tiles_per_gaussian=36)
    n, k = params.capacity, bins.num_valid
    assert k > n
    rng = np.random.RandomState(8)
    d_ent = torch.from_numpy((rng.randn(k, 16) * 10.0 ** rng.uniform(-4, 2, (k, 1))).astype(np.float32))
    got = reduce.reduce_entries(d_ent, bins.order, bins.sorted_idx, n, reduce_dtype)
    want = id_sort_reduce(d_ent, bins.sorted_idx, n, reduce_dtype)
    assert torch.equal(got, want)


def test_reduce_checks_inputs():
    src = torch.zeros(4, dtype=torch.int32)
    starts = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="rows"):
        reduce.sorted_segment_sum_reference(torch.zeros(4, 10), src, starts, 3)
    with pytest.raises(ValueError, match="starts"):
        reduce.sorted_segment_sum_reference(torch.zeros(4, 16), src, starts, 4)
    with pytest.raises(ValueError, match="reduce_dtype"):
        reduce.sorted_segment_sum_reference(torch.zeros(4, 16), src, starts, 3, "f16")
