// Tile alpha-blend backward for Hopper (sm_90a).
//
// Replaces the TPU kernel dogs_tpu/raster/pallas_stream.py:blend_backward_stream
// (K2, kernel _make_bwd_kernel) and its per-tile twin
// dogs_tpu/raster/pallas_blend.py:blend_backward_pallas (K5): one contract on
// two TPU schedules. K5's read-modify-write of boundary chunks shared by two
// tiles exists only because TPU grid programs write whole 128-entry chunks;
// here each thread block writes exactly its own tile's rows.
//
// Schedule: as the forward (blend_forward.cu), one CTA per 16x16 tile, each
// thread owning a horizontal pair of pixels. Each pixel is replayed front to back from the
// forward totals (no per-entry residuals are saved): it keeps log T (the
// stop test), the linearly carried T (the weight) and the running prefix G_<=i = sum_{j<=i} G_j, G_j = direct_j * w_j with
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
// threshold is > 0. The stop decision and w are the forward's, bit for bit:
// alpha, log T, T and the power cut come from blend_common.cuh, in the same
// per-pixel order as the forward.
//
// Bound on this card: instruction issue. Per contributing (pixel, entry) pair
// the replay is ~55 flops plus a log1pf and a division; per visited pair
// ~16 flops plus an expf. A warp runs a pixel's contributing path whenever
// any of its lanes needs it, and that replay takes most of the time
// (PERF.md). On top come the 10 per-entry sums over the tile's pixels: a
// five-step shuffle tree per gradient would be 50 shuffles per warp and
// entry, at one shuffle per clock per SM. The design:
// - each thread sums its two pixels' 10 gradients in registers first, which
//   halves the warps that reduce each entry; of 1, 2 and 4 pixels per
//   thread, two was the fastest on an H100 (PERF.md);
// - a warp reduces its 10 values with a transposed (reduce-scatter)
//   butterfly: at each step a lane keeps half of its values and sends the
//   other half, 5 + 3 + 2 + 1 + 1 = 12 shuffles for all 10 in place of 50;
//   a warp where no pixel has the entry above 1/255 skips it (__any_sync);
// - the per-warp partials are summed in shared memory in warp order, so no
//   float atomics: the same inputs give bit-identical outputs on every launch;
// - the rows are gathered from ent_n through sorted_idx and staged with
//   cp.async into a two-chunk ring, as in the forward;
// - the kernel writes every column of every row of its tile's range (zeros
//   in columns 10-15 and in the rows past the tile's stop), CTA 0 also the
//   rows before starts[0] and the last CTA those from starts[n_tiles] to K,
//   so the caller allocates d_ent without zeroing it.
//
// Layout: ent_n, sorted_idx, starts as the forward; cot (n_tiles, 8, 256) f32,
// rows gC r, g, b, gA_eff, gD, Gtot, 0, 0; d_ent (K, 16) f32 in sorted order,
// columns d_mux, d_muy, d_ca, d_cb, d_cc, d_r, d_g, d_b, d_opa, d_invd, then
// six zeros.

#include "blend_common.cuh"

namespace {

using namespace dogs;

constexpr int kChunk = 64;  // entries per ring slot
constexpr int kGrads = 10;
constexpr int kCotRows = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPPT = 2;  // pixels per thread
constexpr int kThreads = kPix / kPPT;
constexpr int kWarps = kThreads / 32;

// Sums g[0..9] over the 32 lanes of a warp: a reduce-scatter butterfly of 12
// shuffles. Every lane returns one sum; the lane's column is *col, or -1 for
// the lanes that hold a pad or the duplicate of lane ^ 1. Each column is
// written by exactly one lane, and the summation order depends only on the
// lane numbers.
__device__ __forceinline__ float warp_reduce_scatter10(const float (&g)[kGrads], int lane, int* col) {
  // xor 16: keep columns 0-4 (bit 4 clear) or 5-9 (set).
  const bool h4 = lane & 16;
  float a[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const float keep = h4 ? g[i + 5] : g[i];
    const float send = h4 ? g[i] : g[i + 5];
    a[i] = keep + __shfl_xor_sync(kFull, send, 16);
  }
  // xor 8: keep a[0..2] (bit 3 clear) or a[3], a[4] and a zero pad (set).
  const bool h3 = lane & 8;
  const float a_hi[3] = {a[3], a[4], 0.0f};
  float b[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    b[i] = (h3 ? a_hi[i] : a[i]) + __shfl_xor_sync(kFull, h3 ? a[i] : a_hi[i], 8);
  }
  // xor 4: keep b[0..1] (bit 2 clear) or b[2] and a pad (set).
  const bool h2 = lane & 4;
  const float b_hi[2] = {b[2], 0.0f};
  float c[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    c[i] = (h2 ? b_hi[i] : b[i]) + __shfl_xor_sync(kFull, h2 ? b[i] : b_hi[i], 4);
  }
  // xor 2: keep c[0] or c[1]; xor 1: the two lanes of a pair sum to the same.
  const bool h1 = lane & 2;
  float d = (h1 ? c[1] : c[0]) + __shfl_xor_sync(kFull, h1 ? c[0] : c[1], 2);
  d += __shfl_xor_sync(kFull, d, 1);
  const int pos3 = (h2 ? 2 : 0) + (h1 ? 1 : 0);  // position in b
  const bool real = pos3 < (h3 ? 2 : 3);
  *col = (real && !(lane & 1)) ? (h4 ? 5 : 0) + (h3 ? 3 : 0) + pos3 : -1;
  return d;
}

// Zero rows [r0, r1) of d_ent with the CTA's threads.
__device__ __forceinline__ void zero_rows(float* __restrict__ d_ent, int r0, int r1, int tid, int n_threads) {
  float4* p = reinterpret_cast<float4*>(d_ent + static_cast<size_t>(r0) * kEntWidth);
  const int n = (r1 - r0) * (kEntWidth / 4);
  for (int i = tid; i < n; i += n_threads) p[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

__global__ void __launch_bounds__(kThreads)
blend_backward_kernel(const float* __restrict__ ent_n, const int32_t* __restrict__ sorted_idx,
                      const int32_t* __restrict__ starts, const float* __restrict__ cot,
                      float* __restrict__ d_ent, int n_tiles_x, int n_tiles, int k_total,
                      int width, int height, float depth_threshold) {
  __shared__ Entry s_ent[2][kChunk];
  __shared__ float s_part[kWarps][kChunk][kGrads];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int start = starts[t];
  const int stop = starts[t + 1];
  if (t == 0) zero_rows(d_ent, 0, start, tid, kThreads);
  if (t == n_tiles - 1) zero_rows(d_ent, stop, k_total, tid, kThreads);

  float px[kPPT], py[kPPT], log_t[kPPT], trans[kPPT], prefix[kPPT];
  float g_r[kPPT], g_g[kPPT], g_b[kPPT], g_a[kPPT], g_d[kPPT], g_tot[kPPT];
  bool done[kPPT];
  int live = 0;
  const float* c_t = cot + static_cast<size_t>(t) * kCotRows * kPix;
#pragma unroll
  for (int k = 0; k < kPPT; ++k) {
    const int p = pixel_of<kPPT>(tid, k);
    const int ix = (t % n_tiles_x) * kTile + (p % kTile);
    const int iy = (t / n_tiles_x) * kTile + (p / kTile);
    px[k] = static_cast<float>(ix) + 0.5f;
    py[k] = static_cast<float>(iy) + 0.5f;
    log_t[k] = 0.0f;
    trans[k] = 1.0f;
    prefix[k] = 0.0f;
    g_r[k] = c_t[0 * kPix + p];
    g_g[k] = c_t[1 * kPix + p];
    g_b[k] = c_t[2 * kPix + p];
    g_a[k] = c_t[3 * kPix + p];
    g_d[k] = c_t[4 * kPix + p];
    g_tot[k] = c_t[5 * kPix + p];
    done[k] = ix >= width || iy >= height;  // never blends, as in the forward
    live += done[k] ? 0 : 1;
  }

  int zero_from = stop;  // rows from here to stop are past every pixel's stop
  if (start < stop) stage_rows(s_ent[0], ent_n, sorted_idx, start, min(kChunk, stop - start), tid, kThreads);
  for (int base = start, c = 0; base < stop; base += kChunk, ++c) {
    const int n = min(kChunk, stop - base);
    Entry* buf = s_ent[c & 1];
    finish_rows(buf, n, tid, kThreads);
    // Rows visible to all; the previous round's reads of s_part and of the
    // slot refilled below are done. Exit once every pixel is done.
    if (__syncthreads_and(live == 0)) {
      zero_from = base;
      break;
    }
    if (base + kChunk < stop) {
      stage_rows(s_ent[(c + 1) & 1], ent_n, sorted_idx, base + kChunk,
                 min(kChunk, stop - base - kChunk), tid, kThreads);
    }
    for (int j = 0; j < n; ++j) {
      float g[kGrads];
#pragma unroll
      for (int i = 0; i < kGrads; ++i) g[i] = 0.0f;
      bool hit = false;
      if (live > 0) {
        const Entry s = buf[j];
#pragma unroll
        for (int k = 0; k < kPPT; ++k) {
          if (done[k]) continue;
          const float dx = px[k] - s.mux;
          const float dy = py[k] - s.muy;
          const float power = entry_power(s, dx, dy);
          if (power < s.cut) continue;
          float expp;
          const float alpha = entry_alpha(s, power, &expp);
          if (alpha < kAlphaMin) continue;
          const float log_t_incl = next_log_t(log_t[k], alpha);
          if (log_t_incl < kLogTMin) {
            done[k] = true;  // this entry and all later ones get nothing here
            --live;
            continue;
          }
          const float t_excl = trans[k];
          const float w = blend_weight(alpha, &trans[k]);
          const float direct = s.r * g_r[k] + s.g * g_g[k] + s.b * g_b[k] + g_a[k] + s.invd * g_d[k];
          prefix[k] += direct * w;
          // An approximate division (2 ulp) is far inside the gradient bar
          // and takes no part in the stop decision.
          const float d_alpha =
              alpha < kAlphaMax ? direct * t_excl - __fdividef(g_tot[k] - prefix[k], 1.0f - alpha) : 0.0f;
          const float d_power = d_alpha * alpha;
          g[0] += d_power * (s.ca * dx + s.cb * dy);
          g[1] += d_power * (s.cc * dy + s.cb * dx);
          g[2] += d_power * (-0.5f * dx * dx);
          g[3] += d_power * (-dx * dy);
          g[4] += d_power * (-0.5f * dy * dy);
          g[5] += w * g_r[k];
          g[6] += w * g_g[k];
          g[7] += w * g_b[k];
          g[8] += d_alpha * expp;
          g[9] += w * g_d[k];
          log_t[k] = log_t_incl;
          hit = true;
        }
      }
      if (__any_sync(kFull, hit)) {
        int col;
        const float v = warp_reduce_scatter10(g, lane, &col);
        if (col >= 0) s_part[warp][j][col] = v;
      } else if (lane < kGrads) {
        s_part[warp][j][lane] = 0.0f;
      }
    }
    __syncthreads();
    // Sum the warp partials in warp order and write this round's rows, all
    // 16 columns (coalesced: the rows are consecutive).
    float* rows = d_ent + static_cast<size_t>(base) * kEntWidth;
    for (int i = tid; i < n * kEntWidth; i += kThreads) {
      const int j = i / kEntWidth;
      const int k = i - j * kEntWidth;
      float v = 0.0f;
      if (k < kGrads) {
#pragma unroll
        for (int w = 0; w < kWarps; ++w) v += s_part[w][j][k];
        if (k < 2 && depth_threshold > 0.0f) {
          const float r = buf[j].depth / depth_threshold;
          v *= fminf(1.0f, r * r);
        }
      }
      rows[i] = v;
    }
  }
  zero_rows(d_ent, zero_from, stop, tid, kThreads);
}

}  // namespace

// Launches on `stream` without synchronising. `k_total` is K, the rows of
// d_ent. Returns cudaGetLastError().
extern "C" int dogs_blend_backward(const void* ent_n, const void* sorted_idx, const void* starts,
                                   const void* cot, void* d_ent, int n_tiles_x, int n_tiles,
                                   int k_total, int width, int height, float depth_threshold,
                                   void* stream) {
  if (n_tiles <= 0) return static_cast<int>(cudaSuccess);
  blend_backward_kernel<<<n_tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ent_n), static_cast<const int32_t*>(sorted_idx),
      static_cast<const int32_t*>(starts), static_cast<const float*>(cot),
      static_cast<float*>(d_ent), n_tiles_x, n_tiles, k_total, width, height, depth_threshold);
  return static_cast<int>(cudaGetLastError());
}
