// Tile alpha-blend forward for Hopper (sm_90a).
//
// Replaces the TPU kernel dogs_tpu/raster/pallas_stream.py:blend_forward_stream
// (K1, kernel _make_fwd_kernel) and its per-tile twin
// dogs_tpu/raster/pallas_blend.py:blend_forward_pallas (K4): both compute the
// same contract on two TPU schedules. Here one CTA blends one 16x16 tile.
//
// What it computes, per pixel, over the tile's depth-sorted entries
// e in [starts[t], starts[t+1]), whose rows are ent_n[sorted_idx[e]], front
// to back:
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy      (dx, dy from the pixel centre)
//   alpha = min(0.99, opa * exp(min(power, 0)));  skipped when alpha < 1/255
//   log T_incl = log T + log1p(-alpha);  the pixel is done at the first entry
//     whose log T_incl < log(1e-4), and that entry does not contribute
//   w = alpha * T, T *= 1 - alpha;  R,G,B += w * rgb;  A += w;  invD += w * invd
// The stop test stays in log space as the JAX package keeps it: a test on
// the linear T rounds differently and flips the decision at some pixels.
// The weight uses the linearly carried T, which saves an expf per
// contributing pair. alpha, log T, T and the power cut come from
// blend_common.cuh, which the backward (blend_backward.cu) shares, so both
// take the same stop decision and the same w. expf and log1pf stay at full
// precision: moving alpha across the 1/255 cut changes a pixel by up to ~4e-3.
//
// Bound on this card: instruction issue, not memory. Each entry row (48 of
// its 64 bytes) is read once from the N-space matrix, which (32 MB at 500k
// Gaussians) stays in the 50 MB L2, and a visited (pixel, entry) pair costs
// ~16 flops plus an expf, a contributing one ~15 more plus a log1pf.
// The design:
// - the gather is fused: rows are staged straight from ent_n through
//   sorted_idx, so no sorted (K, 16) matrix is written and read back;
// - staging is cp.async into a two-chunk ring in shared memory, every thread
//   copying, so the next chunk's gather is in flight while the current one
//   is blended; one barrier per chunk, which is also the CTA's early exit
//   once every pixel is done;
// - one pixel per thread, at 6 CTAs an SM: of 1, 2 and 4 pixels per thread
//   (one shared-memory read of an entry serving them all), one was the
//   fastest on an H100 (PERF.md), since the wider variants need more
//   registers than 6 CTAs an SM leave;
// - a pair whose power is below the entry's cut skips its expf: the cut is
//   conservative, so the decision is the one the full test takes;
// - no tensor cores: the only product-shaped part is the 6-term quadratic
//   form, and TF32/fp16 rounding of it flips the 1/255 cut.
//
// Layout: ent_n (N, 16) f32 row-major (columns mux, muy, ca, cb, cc, r, g, b,
// opa, invd, depth; the rest unread), 16-byte aligned; sorted_idx (K,) int32
// in [0, N); starts (n_tiles + 1,) int32. Output: (n_tiles, 5, 256) f32, rows
// R, G, B, A, invD, no background; empty tiles and pixels past the image edge
// are zeros.

#include "blend_common.cuh"

namespace {

using namespace dogs;

constexpr int kChunk = 128;  // entries per ring slot
constexpr int kOutRows = 5;
constexpr int kPPT = 1;  // pixels per thread
constexpr int kThreads = kPix / kPPT;

// Asking for 6 CTAs an SM (1536 threads) made the kernel 7.6% faster on an
// H100 at the same 40 registers (PERF.md).
__global__ void __launch_bounds__(kThreads, 6)
blend_forward_kernel(const float* __restrict__ ent_n, const int32_t* __restrict__ sorted_idx,
                     const int32_t* __restrict__ starts, float* __restrict__ out, int n_tiles_x,
                     int width, int height) {
  __shared__ Entry s_ent[2][kChunk];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int start = starts[t];
  const int stop = starts[t + 1];

  float px[kPPT], py[kPPT], log_t[kPPT], trans[kPPT];
  float acc[kPPT][kOutRows];
  bool done[kPPT];
  int live = 0;
#pragma unroll
  for (int k = 0; k < kPPT; ++k) {
    const int p = pixel_of<kPPT>(tid, k);
    const int ix = (t % n_tiles_x) * kTile + (p % kTile);
    const int iy = (t / n_tiles_x) * kTile + (p / kTile);
    px[k] = static_cast<float>(ix) + 0.5f;
    py[k] = static_cast<float>(iy) + 0.5f;
    log_t[k] = 0.0f;
    trans[k] = 1.0f;
    done[k] = ix >= width || iy >= height;  // never blends
    live += done[k] ? 0 : 1;
#pragma unroll
    for (int r = 0; r < kOutRows; ++r) acc[k][r] = 0.0f;
  }

  if (start < stop) stage_rows(s_ent[0], ent_n, sorted_idx, start, min(kChunk, stop - start), tid, kThreads);
  for (int base = start, c = 0; base < stop; base += kChunk, ++c) {
    const int n = min(kChunk, stop - base);
    Entry* buf = s_ent[c & 1];
    finish_rows(buf, n, tid, kThreads);
    // Rows visible to all; the slot refilled below was last read before this
    // barrier. Exit once every pixel of the tile is done.
    if (__syncthreads_and(live == 0)) break;
    if (base + kChunk < stop) {
      stage_rows(s_ent[(c + 1) & 1], ent_n, sorted_idx, base + kChunk,
                 min(kChunk, stop - base - kChunk), tid, kThreads);
    }
    for (int j = 0; j < n && live > 0; ++j) {
      const Entry s = buf[j];
#pragma unroll
      for (int k = 0; k < kPPT; ++k) {
        if (done[k]) continue;
        const float power = entry_power(s, px[k] - s.mux, py[k] - s.muy);
        if (power < s.cut) continue;
        float expp;
        const float alpha = entry_alpha(s, power, &expp);
        if (alpha < kAlphaMin) continue;
        const float log_t_incl = next_log_t(log_t[k], alpha);
        if (log_t_incl < kLogTMin) {
          done[k] = true;
          --live;
          continue;
        }
        const float w = blend_weight(alpha, &trans[k]);
        acc[k][0] = fmaf(w, s.r, acc[k][0]);
        acc[k][1] = fmaf(w, s.g, acc[k][1]);
        acc[k][2] = fmaf(w, s.b, acc[k][2]);
        acc[k][3] += w;
        acc[k][4] = fmaf(w, s.invd, acc[k][4]);
        log_t[k] = log_t_incl;
      }
    }
  }
  cp_async_wait_all();  // nothing is in flight past the loop; kept for safety on exit

  float* o = out + static_cast<size_t>(t) * kOutRows * kPix;
#pragma unroll
  for (int k = 0; k < kPPT; ++k) {
    const int p = pixel_of<kPPT>(tid, k);
#pragma unroll
    for (int r = 0; r < kOutRows; ++r) o[r * kPix + p] = acc[k][r];
  }
}

}  // namespace

// Launches on `stream` without synchronising. Returns cudaGetLastError().
extern "C" int dogs_blend_forward(const void* ent_n, const void* sorted_idx, const void* starts,
                                  void* out, int n_tiles_x, int n_tiles, int width, int height,
                                  void* stream) {
  if (n_tiles <= 0) return static_cast<int>(cudaSuccess);
  blend_forward_kernel<<<n_tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ent_n), static_cast<const int32_t*>(sorted_idx),
      static_cast<const int32_t*>(starts), static_cast<float*>(out), n_tiles_x, width, height);
  return static_cast<int>(cudaGetLastError());
}
