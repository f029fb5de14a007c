// Per-Gaussian sum of per-entry gradient rows, read straight from tile order,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel dogs_tpu/raster/pallas_reduce.py:sorted_segment_sum_pallas
// (K3, kernel _make_kernel): the K -> N step of the rasterizer backward, which
// turns per-entry gradients (one row per (Gaussian, tile) entry) into one row
// per Gaussian. The TPU kernel sums rows already sorted by Gaussian id, with
// windowed one-hot bf16 matmuls on the MXU over bf16 pair-packed int32
// payloads; the sort and the packing are MXU layout, not semantics, and are
// not carried. Here the rows stay where the blend backward wrote them, in
// tile order, and each Gaussian's rows are gathered through `src`:
//
//   out[g, 0:10] = sum over i in [starts[g], starts[g+1]), in i order and
//                  starting from 0.0f, of r(rows[src[i], 0:10])
//   out[g, 10:16] = 0
//
// r is the identity, or (kBf16) a round to nearest even to bf16 and back
// (`__float2bfloat16_rn`, the bits of PyTorch's `.to(torch.bfloat16)`).
// Float adds only, in `i` order, no atomics: the result is bit-identical to
// the plain version (raster/reduce.py:sorted_segment_sum_reference) and
// from launch to launch.
//
// Bound: memory. The work is a row gather plus a short in-order sum (at the
// bench camera a Gaussian with entries has ~4 of them, at most
// max_tiles_per_gaussian), and most of the bytes are the gathered rows. So:
//   - four lanes per Gaussian, each owning one float4 column group of the
//     16-wide row: lanes 0-2 read columns 0-11 of each gathered row as one
//     16-byte read-only load each (columns 10-11 are read and dropped; a row
//     is 64-byte aligned, so its first 48 bytes are two 32-byte sectors
//     either way), lane 3 only writes zeros. A warp covers 8 Gaussians,
//     whose `src` slices are contiguous, and stores their 8 output rows as
//     512 contiguous bytes;
//   - up to kAhead = 8 rows of a run are loaded before any of them is added,
//     so almost every run costs one round trip to memory, and the adds still
//     go in `i` order;
//   - the bf16 round happens in registers.
// What is left is the gather itself: rows of one Gaussian lie in different
// tiles, so the reads are random 64-byte pieces. The alternative layout, one
// thread per Gaussian with three float4 loads a row, was slower on the card
// (PERF.md).
//
// Layout: rows (K, 16) f32 row-major, 16-byte aligned; src (K,) int32 in
// [0, K); starts (n_out + 1,) int32 nondecreasing, starts[n_out] <= K;
// out (n_out, 16) f32 row-major, every element written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kLanes = 4;   // lanes per Gaussian: one float4 column group each
constexpr int kAhead = 8;   // rows of a run in flight before they are added

template <bool kBf16>
__device__ __forceinline__ float rounded(float x) {
  if constexpr (kBf16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float4* __restrict__ rows, const int32_t* __restrict__ src,
                   const int32_t* __restrict__ starts, float4* __restrict__ out, int n_out) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long g = t / kLanes;
  const int c = static_cast<int>(t % kLanes);
  if (g >= n_out) return;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (c < 3) {
    const int lo = __ldg(starts + g);
    const int hi = __ldg(starts + g + 1);
    for (int base = lo; base < hi; base += kAhead) {
      int s[kAhead];
#pragma unroll
      for (int j = 0; j < kAhead; ++j) s[j] = base + j < hi ? __ldg(src + base + j) : 0;
      float4 v[kAhead];
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        v[j] = base + j < hi ? __ldg(rows + static_cast<size_t>(s[j]) * kLanes + c)
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        if (base + j < hi) {
          acc.x += rounded<kBf16>(v[j].x);
          acc.y += rounded<kBf16>(v[j].y);
          acc.z += rounded<kBf16>(v[j].z);
          acc.w += rounded<kBf16>(v[j].w);
        }
      }
    }
    if (c == 2) acc.z = acc.w = 0.0f;  // columns 10-11
  }
  out[t] = acc;
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int dogs_segment_sum(const void* rows, const void* src, const void* starts, void* out,
                                int n_out, int bf16, void* stream) {
  if (n_out <= 0) return static_cast<int>(cudaSuccess);
  const long long threads = static_cast<long long>(n_out) * kLanes;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  const auto* r = static_cast<const float4*>(rows);
  const auto* s = static_cast<const int32_t*>(src);
  const auto* st = static_cast<const int32_t*>(starts);
  auto* o = static_cast<float4*>(out);
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (bf16) {
    segment_sum_kernel<true><<<blocks, kThreads, 0, cs>>>(r, s, st, o, n_out);
  } else {
    segment_sum_kernel<false><<<blocks, kThreads, 0, cs>>>(r, s, st, o, n_out);
  }
  return static_cast<int>(cudaGetLastError());
}
