"""The port's plain K -> N segment sum against the TPU kernel K3
(dogs_tpu/raster/pallas_reduce.py:sorted_segment_sum_pallas, interpret mode),
on the cases of tests/test_pallas_reduce.py, and the id sort around it.

K3 sums bf16-packed payloads. The port's sum takes f32 rows, so both sides
are fed the same numbers: f32 values already quantized to bf16. The CUDA
kernel is held against the plain version on the card (chip_smoke.py,
tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dogs_tpu.raster.pallas_reduce import pack_bf16_pairs, sorted_segment_sum_pallas
from dogs_tpu_torch.raster import reduce

TOL = dict(rtol=1e-6, atol=1e-6)


def bf16_values(rng, k):
    """(k, 10) f32 values exactly representable in bf16."""
    v = rng.randn(k, 10).astype(np.float32)
    return np.asarray(jnp.asarray(v).astype(jnp.bfloat16).astype(jnp.float32))


def both(ids, vals, n_out):
    order = np.argsort(ids, kind="stable")
    ids_s = ids[order].astype(np.int32)
    vals_s = vals[order]
    got = reduce.sorted_segment_sum_reference(
        torch.from_numpy(ids_s), torch.from_numpy(np.ascontiguousarray(vals_s)), n_out
    ).numpy()
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


@pytest.mark.parametrize("reduce_dtype", ["f32", "bf16"])
def test_reduce_entries_sorts_by_gaussian_and_rounds(reduce_dtype):
    """reduce_entries = stable id sort + (bf16 rounding) + segment sum: equal
    to a per-id numpy sum of the (rounded) rows in entry order."""
    rng = np.random.RandomState(4)
    k, n = 777, 90
    sorted_idx = rng.randint(0, n, size=k)
    d_ent = np.zeros((k, 16), np.float32)
    d_ent[:, :10] = rng.randn(k, 10)
    got = reduce.reduce_entries(
        torch.from_numpy(d_ent), torch.from_numpy(sorted_idx), n, reduce_dtype
    ).numpy()
    vals = d_ent[:, :10]
    if reduce_dtype == "bf16":
        vals = np.asarray(jnp.asarray(vals).astype(jnp.bfloat16).astype(jnp.float32))
    want = np.zeros((n, 16), np.float32)
    np.add.at(want[:, :10], sorted_idx, vals)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if reduce_dtype == "bf16":
        # Round to nearest even on both sides: the rounded rows are exactly JAX's.
        q = reduce.sort_by_gaussian(torch.from_numpy(d_ent), torch.from_numpy(sorted_idx), "bf16")[1]
        order = np.argsort(sorted_idx, kind="stable")
        np.testing.assert_array_equal(q.numpy(), vals[order])


def test_reduce_checks_inputs():
    ids = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="vals"):
        reduce.sorted_segment_sum_reference(ids, torch.zeros(4, 16), 3)
    with pytest.raises(ValueError, match="reduce_dtype"):
        reduce.reduce_entries(torch.zeros(4, 16), ids, 3, "f16")
