// The D-SSIM term of the training loss, forward and backward, for Hopper
// (sm_90a): the mean SSIM of a render against its target with the 11-tap
// Gaussian window in one launch (a tile kernel and a one-CTA mean), and its
// gradient in the render in one more.
//
// Replaces no TPU kernel: dogs_tpu (dogs_tpu/raster/ssim.py) writes the
// separable blur as eleven shifted weighted sums a pass and leaves the chain
// to XLA, which fuses it into a few loops. PyTorch runs the same code eagerly:
// ~240 elementwise kernels forward and ~230 in autograd's backward (a pad, a
// multiply and an add a tap, a zero fill and a copy a tap's slice backward),
// each over the whole image, ~4.5 ms of device time and as many host launches
// a 1152x864x3 step (PERF.md). The arithmetic and the walk over a tile are in
// ssim.cuh (shared with the host build the CPU tests run).
//
// Bound: memory, at ~130 MB a step at 1152x864x3 (~40 us at 3.35 TB/s): the
// forward reads x and y and writes three derivative maps, the backward reads
// them back with x and y and writes the gradient; ~1,100 flops a pixel. So:
//   - one CTA a 16x32 tile of pixels, looping over the channels; it stages
//     each channel of the tile and its 5-pixel halo in shared memory, zero
//     outside the image, and blurs there, H then W, so no intermediate image
//     of the plain chain reaches device memory;
//   - the forward keeps at each pixel m's derivatives in blur(x), blur(x x)
//     and blur(x y) (the one buffer the backward reads: its blur of each is
//     the transposed blur), and nothing when no gradient is asked for;
//   - the mean is a sum a thread, a fixed tree a CTA, and one CTA's fixed
//     tree in double over the CTAs' sums: no atomics, so two runs give the
//     same loss and gradient bit for bit.
// Everything is IEEE f32 with no fast math, and this file is built with
// -fmad=false (kernels.py), so each multiply and add rounds on its own, as
// the plain PyTorch version's separate operations do: the map equals
// raster/ssim.py:ssim_map's bit for bit.
//
// Layout: Args in ssim.cuh; every tensor (B, H, W, C) and contiguous.

#include <cuda_runtime.h>

#include "ssim.cuh"

namespace {

using namespace dogs_ssim;

__device__ __forceinline__ Tile tile_of() {
  return Tile{static_cast<long long>(blockIdx.z), static_cast<int>(blockIdx.y) * kTileH,
              static_cast<int>(blockIdx.x) * kTileW};
}

__global__ void __launch_bounds__(kThreads) ssim_forward_kernel(const Args a) {
  __shared__ Smem s;
  const Tile T = tile_of();
  const int t = threadIdx.x;
  const float* src[2] = {a.x, a.y};
  float sum = 0.0f;
  for (int c = 0; c < a.channels; ++c) {
    stage(a, src, 2, T, c, s.in, t);
    __syncthreads();
    h_pass_forward(a, s.in, s.mid, t);
    __syncthreads();
    sum = w_pass_forward(a, T, c, s.mid, t, sum);
    __syncthreads();
  }
  s.sum[t] = sum;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (t < stride) s.sum[t] = s.sum[t] + s.sum[t + stride];
    __syncthreads();
  }
  if (t == 0) a.partial[(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = s.sum[0];
}

__global__ void __launch_bounds__(kThreads) ssim_mean_kernel(const Args a, long long ctas) {
  __shared__ double v[kThreads];
  const int t = threadIdx.x;
  v[t] = mean_run(a, ctas, t);
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (t < stride) v[t] = v[t] + v[t + stride];
    __syncthreads();
  }
  if (t == 0) *a.loss = static_cast<float>(v[0] / static_cast<double>(numel(a)));
}

__global__ void __launch_bounds__(kThreads) ssim_backward_kernel(const Args a) {
  __shared__ Smem s;
  const Tile T = tile_of();
  const int t = threadIdx.x;
  const long long plane = numel(a);
  const float* src[3] = {a.dmap, a.dmap + plane, a.dmap + 2 * plane};
  const float scale = grad_scale(a);
  for (int c = 0; c < a.channels; ++c) {
    stage(a, src, 3, T, c, s.in, t);
    __syncthreads();
    h_pass_backward(a, s.in, s.mid, t);
    __syncthreads();
    w_pass_backward(a, T, c, s.mid, scale, t);
    __syncthreads();
  }
}

dim3 grid_of(const Args& a) {
  return dim3(static_cast<unsigned>(tiles_w(a)), static_cast<unsigned>(tiles_h(a)),
              static_cast<unsigned>(a.batch));
}

}  // namespace

// Launch on `stream` without synchronising; return cudaGetLastError().
extern "C" int dogs_ssim_forward(const dogs_ssim::Args* args, void* stream) {
  const dogs_ssim::Args a = *args;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_of(a);
  const long long ctas = static_cast<long long>(grid.x) * grid.y * grid.z;
  if (ctas > 0) ssim_forward_kernel<<<grid, dogs_ssim::kThreads, 0, s>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssim_mean_kernel<<<1, dogs_ssim::kThreads, 0, s>>>(a, ctas);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dogs_ssim_backward(const dogs_ssim::Args* args, void* stream) {
  const dogs_ssim::Args a = *args;
  const dim3 grid = grid_of(a);
  if (static_cast<long long>(grid.x) * grid.y * grid.z == 0) return static_cast<int>(cudaSuccess);
  ssim_backward_kernel<<<grid, dogs_ssim::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
