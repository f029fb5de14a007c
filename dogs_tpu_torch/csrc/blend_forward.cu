// Tile alpha-blend forward for Hopper (sm_90a).
//
// Replaces the TPU kernel dogs_tpu/raster/pallas_stream.py:blend_forward_stream
// (K1, kernel _make_fwd_kernel) and its per-tile twin
// dogs_tpu/raster/pallas_blend.py:blend_forward_pallas (K4): both compute the
// same contract on two TPU schedules. Here the schedule is the original CUDA
// renderCUDA one: one 256-thread CTA per 16x16 tile, one pixel per thread.
//
// What it computes, per pixel, over the tile's depth-sorted entries
// [starts[t], starts[t+1]), front to back:
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy      (dx, dy from the pixel centre)
//   alpha = min(0.99, opa * exp(min(power, 0)));  skipped when alpha < 1/255
//   log T_incl = log T + log1p(-alpha);  the pixel is done at the first entry
//     whose log T_incl < log(1e-4), and that entry does not contribute
//   w = alpha * exp(log T);  R,G,B += w * rgb;  A += w;  invD += w * invd
// Transmittance stays in log space as the JAX package keeps it: a linear
// T *= (1 - alpha) rounds differently and flips the stop decision at some
// pixels. Accumulation is plain f32 FMA (the TPU needed Precision.HIGHEST
// matmuls to get the same). alpha comes from blend_common.cuh, which the
// backward (blend_backward.cu) shares, so both take the same stop decision.
//
// Bound: per entry each pixel spends ~20 flops and up to three
// transcendental calls (expf of the Gaussian; log1pf and expf for the
// transmittance) on 48 bytes staged once per CTA in shared memory, so the
// kernel is bound by the issue rate of the FMA/SFU pipes, not by device
// memory: each entry row is read from HBM once, by its one tile. The design keeps it
// simple: chunks of 256 entries staged cooperatively (one row per thread),
// a block-wide early exit once every pixel is done (__syncthreads_and), and
// no wgmma or TMA.
//
// Layout: entries are a row-major (K, 16) f32 matrix in sorted order,
// columns mux, muy, ca, cb, cc, r, g, b, opa, invd (depth and padding unread).
// Output: (n_tiles, 5, 256) f32, rows R, G, B, A, invD, no background.
// Empty tiles and pixels past the image edge are written as zeros.

#include "blend_common.cuh"

namespace {

using namespace dogs;

constexpr int kChunk = kPix;  // entries staged per round, one per thread
constexpr int kOutRows = 5;

__global__ void __launch_bounds__(kPix)
blend_forward_kernel(const float* __restrict__ ent, const int32_t* __restrict__ starts,
                     float* __restrict__ out, int n_tiles_x, int width, int height) {
  __shared__ Entry s_ent[kChunk];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int ix = (t % n_tiles_x) * kTile + (p % kTile);
  const int iy = (t / n_tiles_x) * kTile + (p / kTile);
  const float px = static_cast<float>(ix) + 0.5f;
  const float py = static_cast<float>(iy) + 0.5f;
  const int start = starts[t];
  const int stop = starts[t + 1];

  bool done = ix >= width || iy >= height;
  float log_t = 0.0f;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_a = 0.0f, acc_d = 0.0f;

  for (int base = start; base < stop; base += kChunk) {
    // Barrier before refilling shared memory; exit once every pixel is done.
    if (__syncthreads_and(done)) break;
    if (base + p < stop) s_ent[p] = load_entry(ent, base + p);
    __syncthreads();
    const int n = min(kChunk, stop - base);
    for (int j = 0; j < n && !done; ++j) {
      const Entry& s = s_ent[j];
      float expp;
      const float alpha = entry_alpha(s, px - s.mux, py - s.muy, &expp);
      if (alpha < kAlphaMin) continue;
      const float log_t_incl = log_t + log1pf(-alpha);
      if (log_t_incl < kLogTMin) {
        done = true;
        break;
      }
      const float w = alpha * expf(log_t);
      acc_r = fmaf(w, s.r, acc_r);
      acc_g = fmaf(w, s.g, acc_g);
      acc_b = fmaf(w, s.b, acc_b);
      acc_a += w;
      acc_d = fmaf(w, s.invd, acc_d);
      log_t = log_t_incl;
    }
  }

  float* o = out + static_cast<size_t>(t) * kOutRows * kPix + p;
  o[0 * kPix] = acc_r;
  o[1 * kPix] = acc_g;
  o[2 * kPix] = acc_b;
  o[3 * kPix] = acc_a;
  o[4 * kPix] = acc_d;
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int dogs_blend_forward(const void* ent, const void* starts, void* out,
                                  int n_tiles_x, int n_tiles, int width, int height,
                                  void* stream) {
  if (n_tiles <= 0) return static_cast<int>(cudaSuccess);
  blend_forward_kernel<<<n_tiles, dogs::kPix, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ent), static_cast<const int32_t*>(starts),
      static_cast<float*>(out), n_tiles_x, width, height);
  return static_cast<int>(cudaGetLastError());
}
