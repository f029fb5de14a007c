// Per-Gaussian rasterization preprocess, forward and backward, for Hopper
// (sm_90a): projection, EWA, conic, radius, SH -> RGB and the blend's (N, 16)
// entry matrix in one kernel, and that map's vector-Jacobian product in one
// more.
//
// Replaces no TPU kernel: dogs_tpu computes this preprocess in plain JAX
// (dogs_tpu/raster/projection.py:project_gaussians, the entry matrix of
// dogs_tpu/raster/tiled.py) and leaves it to XLA, which fuses the elementwise
// chain into a few loops. PyTorch runs the same code eagerly as hundreds of
// separate elementwise kernels over every slot, forward and backward, with a
// (N, K, 3) copy of the SH coefficients and one zero-filled (N, K, 3) tensor
// a coefficient in the backward; that chain was the larger part of a
// training step at 4M Gaussians (PERF.md). What each thread computes is in
// preprocess.cuh (shared with the host build the CPU tests run).
//
// Bound: memory. A slot costs a few hundred flops (the SH bases, the 3x3
// covariance, the EWA Jacobian) against ~313 bytes forward at SH 3 (xyz,
// log-scale, quaternion, opacity logit, 16 x 3 SH coefficients, alive and the
// screen offset read; one 64-byte entry row and the radius written) and
// ~550 bytes backward (the same leaves, the entry row's cotangent and the
// radius read; every leaf's gradient written). At 4M slots that is
// ~1.25 GB (~0.37 ms at 3.35 TB/s) and ~2.2 GB (~0.66 ms). So:
//   - one thread a slot, 128 slots a block; nothing intermediate leaves
//     registers: the backward recomputes the forward from the leaves and
//     the saved radius (its visibility), and a slot with radius 0 skips the
//     arithmetic and writes zeros;
//   - the ragged per-slot arrays whose rows one thread cannot read
//     coalesced go through shared memory in block-wide coalesced copies:
//     the SH rows (180 bytes a slot at SH 3), the entry rows written (64
//     bytes) and the cotangent rows read. Rows sit at an odd pitch in
//     shared memory, so the 32 threads of a warp reading their own rows hit
//     32 different banks;
//   - the SH degree (0-4) and the colour override are template parameters,
//     so each variant reads only the coefficients it uses;
//   - the camera's gradient (pose refinement) is summed without atomics:
//     each block sums its 128 slots' terms in order into one row of
//     partials, and a second kernel sums the rows in a fixed order (one warp
//     a column, then a fixed shuffle tree), so two runs are bitwise equal.
// Everything is IEEE f32 with no fast math; this file is built with
// -fmad=false (kernels.py), so no multiply and add are contracted into one
// rounding: each rounds on its own, as in the plain PyTorch version's
// separate operations (the forward's columns agree with it to ~2e-6 of
// their largest values on the card; the radii exactly at 500k slots).
//
// Layout: every array row-major and contiguous; Args and Grads in
// preprocess.cuh.

#include <cuda_runtime.h>

#include "preprocess.cuh"

namespace {

using namespace dogs_pre;

constexpr int kThreads = 128;
constexpr int kRowPitch = kEntWidth + 1;

template <int kDeg, bool kOverride>
struct Shape {
  static constexpr int kRest = kOverride ? 0 : num_bases<kDeg>() - 1;
  static constexpr int kW = 3 * kRest;   // floats of a slot's active SH rows
  static constexpr int kPitch = kW | 1;  // odd
};

// The block's active SH rows into shared memory, block-wide: contiguous
// reads when the active degree is the stored one.
template <int kW, int kPitch>
__device__ __forceinline__ void stage_rest(const float* __restrict__ feat_rest, int rest_rows, long long g0,
                                           int cnt, float* rest) {
  if constexpr (kW > 0) {
    const long long stride = 3LL * rest_rows;
    const float* src = feat_rest + g0 * stride;
    for (int e = threadIdx.x; e < cnt * kW; e += kThreads) {
      const int r = e / kW, c = e - r * kW;
      rest[r * kPitch + c] = src[r * stride + c];
    }
  }
}

template <int kDeg, bool kOverride>
__global__ void __launch_bounds__(kThreads)
preprocess_forward_kernel(const Args a, float* __restrict__ ent, float* __restrict__ radius) {
  using S = Shape<kDeg, kOverride>;
  __shared__ float rest[kThreads * S::kPitch];
  __shared__ float rows[kThreads * kRowPitch];
  const long long g0 = static_cast<long long>(blockIdx.x) * kThreads;
  const int cnt = static_cast<int>(min(static_cast<long long>(kThreads), a.n - g0));
  stage_rest<S::kW, S::kPitch>(a.feat_rest, a.rest_rows, g0, cnt, rest);
  __syncthreads();
  const int j = threadIdx.x;
  if (j < cnt) {
    const Cam cam = load_camera(a);
    float row[kEntWidth];
    forward_one<kDeg, kOverride>(a, cam, g0 + j, rest + j * S::kPitch, row, radius + g0 + j);
#pragma unroll
    for (int k = 0; k < kEntWidth; ++k) rows[j * kRowPitch + k] = row[k];
  }
  __syncthreads();
  float* dst = ent + g0 * kEntWidth;
  for (int e = threadIdx.x; e < cnt * kEntWidth; e += kThreads) dst[e] = rows[(e >> 4) * kRowPitch + (e & 15)];
}

template <int kDeg, bool kOverride>
__global__ void __launch_bounds__(kThreads)
preprocess_backward_kernel(const Args a, const Grads g, float* __restrict__ cam_partials) {
  using S = Shape<kDeg, kOverride>;
  __shared__ float rest[kThreads * S::kPitch];
  __shared__ float rows[kThreads * kRowPitch];
  const long long g0 = static_cast<long long>(blockIdx.x) * kThreads;
  const int cnt = static_cast<int>(min(static_cast<long long>(kThreads), a.n - g0));
  stage_rest<S::kW, S::kPitch>(a.feat_rest, a.rest_rows, g0, cnt, rest);
  const float* src = g.d_ent + g0 * kEntWidth;
  for (int e = threadIdx.x; e < cnt * kEntWidth; e += kThreads) rows[(e >> 4) * kRowPitch + (e & 15)] = src[e];
  __syncthreads();
  const int j = threadIdx.x;
  float cam_g[kCamGrads];
  if (j < cnt) {
    const Cam cam = load_camera(a);
    float* mine = rest + j * S::kPitch;  // its SH rows, then their gradients
    backward_one<kDeg, kOverride>(a, cam, g0 + j, mine, rows + j * kRowPitch, g.radius[g0 + j], g, mine, cam_g);
  } else {
#pragma unroll
    for (int k = 0; k < kCamGrads; ++k) cam_g[k] = 0.0f;
  }
  __syncthreads();
  if (cam_partials != nullptr) {  // the block's camera term, summed in slot order
#pragma unroll
    for (int k = 0; k < kCamGrads; ++k) rows[k * kThreads + j] = cam_g[k];
    __syncthreads();
    if (j < kCamGrads) {
      float s = 0.0f;
      for (int r = 0; r < kThreads; ++r) s += rows[j * kThreads + r];
      cam_partials[static_cast<long long>(blockIdx.x) * kCamGrads + j] = s;
    }
  }
  if (g.feat_rest != nullptr) {  // every stored SH row: zeros past the active degree
    const int stride = 3 * a.rest_rows;
    float* dst = g.feat_rest + g0 * stride;
    for (int e = threadIdx.x; e < cnt * stride; e += kThreads) {
      const int r = e / stride, c = e - r * stride;
      dst[e] = c < S::kW ? rest[r * S::kPitch + c] : 0.0f;
    }
  }
}

// out[c] = sum over blocks of partials[b, c]: one warp a column, lanes over
// blocks in order, then a fixed shuffle tree.
__global__ void camera_reduce_kernel(const float* __restrict__ partials, int n_blocks, float* __restrict__ out) {
  const int col = threadIdx.x / 32, lane = threadIdx.x % 32;
  float s = 0.0f;
  for (int b = lane; b < n_blocks; b += 32) s += partials[static_cast<long long>(b) * kCamGrads + col];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane == 0) out[col] = s;
}

template <int kDeg, bool kOverride>
void launch_forward(const Args& a, float* ent, float* radius, int blocks, cudaStream_t s) {
  preprocess_forward_kernel<kDeg, kOverride><<<blocks, kThreads, 0, s>>>(a, ent, radius);
}

template <int kDeg, bool kOverride>
void launch_backward(const Args& a, const Grads& g, float* partials, int blocks, cudaStream_t s) {
  preprocess_backward_kernel<kDeg, kOverride><<<blocks, kThreads, 0, s>>>(a, g, partials);
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError(), or
// cudaErrorInvalidValue for an SH degree outside 0-4.
extern "C" int dogs_preprocess_forward(const dogs_pre::Args* args, void* ent, void* radius, void* stream) {
  const dogs_pre::Args a = *args;
  if (a.n <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (a.n + kThreads - 1) / kThreads;
  auto* e = static_cast<float*>(ent);
  auto* r = static_cast<float*>(radius);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.color != nullptr) {
    launch_forward<0, true>(a, e, r, blocks, s);
  } else {
    switch (a.degree) {
      case 0: launch_forward<0, false>(a, e, r, blocks, s); break;
      case 1: launch_forward<1, false>(a, e, r, blocks, s); break;
      case 2: launch_forward<2, false>(a, e, r, blocks, s); break;
      case 3: launch_forward<3, false>(a, e, r, blocks, s); break;
      case 4: launch_forward<4, false>(a, e, r, blocks, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// `partials` holds ceil(n / 128) x 12 floats when grads->camera is set (then
// the camera's gradient, d R row-major and d t, lands in grads->camera[0:12]).
extern "C" int dogs_preprocess_backward(const dogs_pre::Args* args, const dogs_pre::Grads* grads, void* partials,
                                        void* stream) {
  const dogs_pre::Args a = *args;
  const dogs_pre::Grads g = *grads;
  if (a.n <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (a.n + kThreads - 1) / kThreads;
  auto* p = g.camera != nullptr ? static_cast<float*>(partials) : nullptr;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.color != nullptr) {
    launch_backward<0, true>(a, g, p, blocks, s);
  } else {
    switch (a.degree) {
      case 0: launch_backward<0, false>(a, g, p, blocks, s); break;
      case 1: launch_backward<1, false>(a, g, p, blocks, s); break;
      case 2: launch_backward<2, false>(a, g, p, blocks, s); break;
      case 3: launch_backward<3, false>(a, g, p, blocks, s); break;
      case 4: launch_backward<4, false>(a, g, p, blocks, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (p != nullptr) camera_reduce_kernel<<<1, 32 * kCamGrads, 0, s>>>(p, blocks, g.camera);
  return static_cast<int>(cudaGetLastError());
}
