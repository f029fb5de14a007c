// Tile alpha-blend backward for Hopper (sm_90a).
//
// Replaces the TPU kernel dogs_tpu/raster/pallas_stream.py:blend_backward_stream
// (K2, kernel _make_bwd_kernel) and its per-tile twin
// dogs_tpu/raster/pallas_blend.py:blend_backward_pallas (K5): one contract on
// two TPU schedules. K5's read-modify-write of boundary chunks shared by two
// tiles exists only because TPU grid programs write whole 128-entry chunks;
// here each thread block writes exactly its own tile's rows.
//
// Schedule: as the forward (blend_forward.cu), one 256-thread CTA per 16x16
// tile and one pixel per thread. Each thread replays its pixel front to back
// from the forward totals (no per-entry residuals are saved): it keeps log T
// and the running prefix G_<=i = sum_{j<=i} G_j, G_j = direct_j * w_j with
// direct_j = gC . c_j + gA + gD d_j, and gets the suffix over later entries as
// Gtot - G_<=i (the gradient identity of dogs_tpu/raster/tiled.py:34-37):
//   dL/dalpha_i = direct_i T_i - (Gtot - G_<=i) / (1 - alpha_i)
// zero where alpha is clamped at 0.99, dropped below 1/255, or past the stop.
// Then, with d = pixel - mu:
//   d_opa  = sum dL/dalpha exp(min(power, 0))     (the XLA form, tiled.py:280)
//   d_power = dL/dalpha alpha
//   d_ca = sum d_power (-dx^2/2), d_cb = sum d_power (-dx dy), d_cc = sum d_power (-dy^2/2)
//   d_mux = sum d_power (a dx + b dy), d_muy = sum d_power (c dy + b dx)
//   d_rgb = sum w gC, d_invd = sum w gD
// with d_mux, d_muy scaled by min(1, (depth / depth_threshold)^2) when the
// threshold is > 0. The stop decision is the forward's, bit for bit: alpha
// comes from blend_common.cuh and the gate is the same log1pf sequence.
//
// Each entry belongs to one tile, so its 10 gradients are a sum over that
// tile's 256 pixels only: a warp-shuffle tree inside each warp, then the 8
// warp partials summed in warp order. No atomics, and the same inputs give
// bit-identical outputs on every launch.
//
// Bound: per entry and pixel ~60 flops and three transcendental calls, plus
// 10 five-step shuffle reductions per warp for every entry that touches the
// warp (skipped when no pixel of the warp has the entry above 1/255). HBM
// traffic is one 48-byte read and one 40-byte write per entry and 24 bytes of
// cotangent per pixel, so the kernel is bound by instruction issue (shuffles
// and FMA/SFU), not memory. The design stays simple: 64 entries staged per
// round, 20 KB of shared memory for the warp partials, a block-wide exit
// once every pixel is done. No wgmma or TMA.
//
// Layout: entries (K, 16) f32 row-major in sorted order (blend_common.cuh);
// cot (n_tiles, 8, 256) f32, rows gC r, g, b, gA_eff, gD, Gtot, 0, 0;
// d_ent (K, 16) f32, columns d_mux, d_muy, d_ca, d_cb, d_cc, d_r, d_g, d_b,
// d_opa, d_invd. The caller allocates d_ent zeroed: columns 10-15 and the
// rows of entries after a tile's last pixel stopped are never written.

#include "blend_common.cuh"

namespace {

using namespace dogs;

constexpr int kChunk = 64;  // entries staged per round
constexpr int kWarps = kPix / 32;
constexpr int kGrads = 10;
constexpr int kCotRows = 8;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kPix)
blend_backward_kernel(const float* __restrict__ ent, const int32_t* __restrict__ starts,
                      const float* __restrict__ cot, float* __restrict__ d_ent,
                      int n_tiles_x, int width, int height, float depth_threshold) {
  __shared__ Entry s_ent[kChunk];
  __shared__ float s_part[kWarps][kChunk][kGrads];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int ix = (t % n_tiles_x) * kTile + (p % kTile);
  const int iy = (t / n_tiles_x) * kTile + (p / kTile);
  const float px = static_cast<float>(ix) + 0.5f;
  const float py = static_cast<float>(iy) + 0.5f;
  const int start = starts[t];
  const int stop = starts[t + 1];

  const float* c = cot + static_cast<size_t>(t) * kCotRows * kPix + p;
  const float g_r = c[0 * kPix], g_g = c[1 * kPix], g_b = c[2 * kPix];
  const float g_a = c[3 * kPix], g_d = c[4 * kPix], g_tot = c[5 * kPix];

  // Pixels past the image edge never blend (the forward starts them done).
  bool done = ix >= width || iy >= height;
  float log_t = 0.0f;
  float prefix = 0.0f;

  for (int base = start; base < stop; base += kChunk) {
    // Barrier before refilling shared memory (it also orders the previous
    // round's reads of s_part); exit once every pixel is done.
    if (__syncthreads_and(done)) break;
    if (p < kChunk && base + p < stop) s_ent[p] = load_entry(ent, base + p);
    __syncthreads();
    const int n = min(kChunk, stop - base);
    for (int j = 0; j < n; ++j) {
      float g[kGrads];
#pragma unroll
      for (int k = 0; k < kGrads; ++k) g[k] = 0.0f;
      bool hit = false;
      if (!done) {
        const Entry& s = s_ent[j];
        const float dx = px - s.mux;
        const float dy = py - s.muy;
        float expp;
        const float alpha = entry_alpha(s, dx, dy, &expp);
        if (alpha >= kAlphaMin) {
          const float log_t_incl = log_t + log1pf(-alpha);
          if (log_t_incl < kLogTMin) {
            done = true;  // this entry and all later ones get nothing here
          } else {
            const float t_excl = expf(log_t);
            const float w = alpha * t_excl;
            const float direct = s.r * g_r + s.g * g_g + s.b * g_b + g_a + s.invd * g_d;
            prefix += direct * w;
            const float d_alpha =
                alpha < kAlphaMax ? direct * t_excl - (g_tot - prefix) / (1.0f - alpha) : 0.0f;
            const float d_power = d_alpha * alpha;
            g[0] = d_power * (s.ca * dx + s.cb * dy);
            g[1] = d_power * (s.cc * dy + s.cb * dx);
            g[2] = d_power * (-0.5f * dx * dx);
            g[3] = d_power * (-dx * dy);
            g[4] = d_power * (-0.5f * dy * dy);
            g[5] = w * g_r;
            g[6] = w * g_g;
            g[7] = w * g_b;
            g[8] = d_alpha * expp;
            g[9] = w * g_d;
            log_t = log_t_incl;
            hit = true;
          }
        }
      }
      if (__any_sync(kFull, hit)) {
#pragma unroll
        for (int k = 0; k < kGrads; ++k) {
          float v = g[k];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
          if (lane == 0) s_part[warp][j][k] = v;
        }
      } else if (lane == 0) {
#pragma unroll
        for (int k = 0; k < kGrads; ++k) s_part[warp][j][k] = 0.0f;
      }
    }
    __syncthreads();
    // Sum the warp partials in warp order and write this round's rows.
    for (int i = p; i < n * kGrads; i += kPix) {
      const int j = i / kGrads;
      const int k = i - j * kGrads;
      float v = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += s_part[w][j][k];
      if (k < 2 && depth_threshold > 0.0f) {
        const float r = s_ent[j].depth / depth_threshold;
        v *= fminf(1.0f, r * r);
      }
      d_ent[static_cast<size_t>(base + j) * kEntWidth + k] = v;
    }
  }
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int dogs_blend_backward(const void* ent, const void* starts, const void* cot,
                                   void* d_ent, int n_tiles_x, int n_tiles, int width,
                                   int height, float depth_threshold, void* stream) {
  if (n_tiles <= 0) return static_cast<int>(cudaSuccess);
  blend_backward_kernel<<<n_tiles, dogs::kPix, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ent), static_cast<const int32_t*>(starts),
      static_cast<const float*>(cot), static_cast<float*>(d_ent), n_tiles_x, width, height,
      depth_threshold);
  return static_cast<int>(cudaGetLastError());
}
