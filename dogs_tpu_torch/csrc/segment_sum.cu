// Dense per-id sum of id-sorted gradient rows for Hopper (sm_90a).
//
// Replaces the TPU kernel dogs_tpu/raster/pallas_reduce.py:sorted_segment_sum_pallas
// (K3, kernel _make_kernel): the K -> N step of the rasterizer backward, which
// turns per-entry gradients (one row per (Gaussian, tile) entry, sorted by
// Gaussian id) into one row per Gaussian. The TPU kernel does this with
// windowed one-hot bf16 matmuls on the MXU over bf16 pair-packed int32
// payloads; those are MXU layout, not semantics, and are not carried. Here:
//
//   out[g, 0:10] = sum of vals[i, 0:10] over the rows i with ids[i] == g
//   out[g, 10:16] = 0;  rows of ids that never occur are zero;
//   ids >= n_out are dropped (no output row reads them).
//
// One thread per output id: two binary searches over the ascending ids give
// its run [lo, hi), which it sums in order. No float atomics, so the result
// is deterministic, and a run may be any length (a real Gaussian's run is at
// most max_tiles_per_gaussian rows, but nothing here assumes that).
//
// Bound: memory. Each value row is read once (40 bytes) by the one thread
// that owns its id, each output row written once (64 bytes); neighbouring
// threads own neighbouring runs, so reads stay close to coalesced. The binary
// searches (~log2 K steps over the 4-byte ids, which stay in L2) add
// latency that the ~n_out / 256 blocks in flight hide.
//
// Layout: ids (K,) int32 ascending; vals (K, 10) f32 row-major; out (n_out, 16)
// f32 row-major, every element written.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 10;
constexpr int kOutWidth = 16;

// First index i in [0, k) with ids[i] >= key (k if none).
__device__ __forceinline__ int lower_bound(const int32_t* __restrict__ ids, int k, long long key) {
  int lo = 0, hi = k;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (static_cast<long long>(ids[mid]) < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const int32_t* __restrict__ ids, const float* __restrict__ vals,
                   float* __restrict__ out, int k, int n_out) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= n_out) return;
  const int lo = lower_bound(ids, k, g);
  const int hi = lower_bound(ids, k, static_cast<long long>(g) + 1);
  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.0f;
  for (int i = lo; i < hi; ++i) {
    const float* row = vals + static_cast<size_t>(i) * kCols;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] += row[c];
  }
  float4* o = reinterpret_cast<float4*>(out + static_cast<size_t>(g) * kOutWidth);
  o[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  o[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  o[2] = make_float4(acc[8], acc[9], 0.0f, 0.0f);
  o[3] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int dogs_segment_sum(const void* ids, const void* vals, void* out, int k, int n_out,
                                void* stream) {
  if (n_out <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (n_out + kThreads - 1) / kThreads;
  segment_sum_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<const float*>(vals),
      static_cast<float*>(out), k, n_out);
  return static_cast<int>(cudaGetLastError());
}
