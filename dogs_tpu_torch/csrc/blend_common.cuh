// Shared by the blend forward (blend_forward.cu) and backward
// (blend_backward.cu): the tile geometry, the pixels a thread owns, the
// entry-row staging (a gather through sorted_idx with cp.async), and the
// per-pixel alpha and transmittance step of one entry.
//
// The backward replays the forward's stop decision (a pixel stops at the
// first entry whose log T would fall below log(1e-4)). If the two kernels
// rounded alpha or log T differently, that decision could flip at a pixel
// and the backward would give gradients for a contribution the forward
// never made. So both compute them here, with explicitly rounded f32
// operations (__fmul_rn / __fadd_rn: no FMA contraction that could differ
// between the two compilation contexts), and both call the same expf/log1pf
// at full precision.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dogs {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;  // pixels per tile (one CTA per tile)
constexpr int kEntWidth = 16;        // f32 columns per entry row
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kLogTMin = -9.210340371976182f;  // log(1e-4)
// Relative margin of the power cut (see power_cut): far above the few-ulp
// error of expf, logf and the products, so a cut entry always has alpha
// below kAlphaMin.
constexpr float kCutMargin = 1e-3f;

// The first 12 columns of an entry row, in column order, staged as three
// 16-byte copies. Column 11 of the row is not read: the stager overwrites it
// in shared memory with the entry's power cut.
struct __align__(16) Entry {
  float mux, muy, ca, cb;   // columns 0-3: screen mean, conic a, b
  float cc, r, g, b;        // columns 4-7: conic c, colour
  float opa, invd, depth;   // columns 8-10: opacity, inverse depth, depth
  float cut;                // power below which alpha < kAlphaMin (power_cut)
};

// Pixel (0..255, row-major in the tile) of the k-th pixel of thread `tid`
// when each thread owns kPPT pixels: 1 = one pixel (the forward), 2 = a
// horizontal pair (the backward). Neighbouring pixels tend to stop at similar
// entries, so a thread's pixels diverge little.
template <int kPPT>
__device__ __forceinline__ int pixel_of(int tid, int k) {
  static_assert(kPPT == 1 || kPPT == 2, "1 or 2 pixels per thread");
  return kPPT == 1 ? tid : 2 * tid + k;
}

// power = -0.5 (a dx^2 + c dy^2) - b dx dy.
__device__ __forceinline__ float entry_power(const Entry& s, float dx, float dy) {
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(s.ca, dx), dx), __fmul_rn(__fmul_rn(s.cc, dy), dy));
  return __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(__fmul_rn(s.cb, dx), dy));
}

// alpha = min(0.99, opa * exp(min(power, 0))); also returns exp(min(power, 0)).
// Callers drop the entry at this pixel when alpha < kAlphaMin.
__device__ __forceinline__ float entry_alpha(const Entry& s, float power, float* expp) {
  *expp = expf(fminf(power, 0.0f));
  return fminf(kAlphaMax, __fmul_rn(s.opa, *expp));
}

// A power below which opa * exp(power) < kAlphaMin whatever the rounding:
// -log(255 opa) less a relative margin. An entry with power < cut at a pixel
// is dropped there without its expf; every other pair goes through
// entry_alpha and its own kAlphaMin test, so the decision is the one
// entry_alpha alone would take. opa == 0 gives NaN (never cut): its alpha,
// 0, fails entry_alpha's own test.
__device__ __forceinline__ float power_cut(float opa) {
  const float c = -logf(255.0f * opa);
  return c - kCutMargin * fmaxf(1.0f, fabsf(c));
}

// log T after an entry of this alpha: log T + log1p(-alpha).
__device__ __forceinline__ float next_log_t(float log_t, float alpha) {
  return __fadd_rn(log_t, log1pf(-alpha));
}

// The weight of a contributing entry, w = alpha T, and the transmittance
// after it, T *= 1 - alpha. T is carried linearly (no expf per entry); the
// stop test stays on log T (next_log_t). Both kernels call this, so the
// backward replays the forward's w bit for bit.
__device__ __forceinline__ float blend_weight(float alpha, float* trans) {
  const float w = __fmul_rn(alpha, *trans);
  *trans = __fmul_rn(*trans, __fsub_rn(1.0f, alpha));
  return w;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Issue the copies of rows ent_n[sorted_idx[base + r]], r < n, into buf[r]
// (columns 0-11, three 16-byte cp.async each), every thread of the CTA
// taking part; then commit them as one group. Part 2 of row r (opa, invd,
// depth, column 11) is copied by thread r % n_threads, which then finishes
// the row (finish_rows) after its own copies have landed.
__device__ __forceinline__ void stage_rows(Entry* buf, const float* __restrict__ ent_n,
                                           const int32_t* __restrict__ sorted_idx, int base,
                                           int n, int tid, int n_threads) {
  for (int i = tid; i < 2 * n; i += n_threads) {
    const int r = i >> 1;
    const int part = i & 1;
    const float* row = ent_n + static_cast<size_t>(sorted_idx[base + r]) * kEntWidth;
    cp_async16(reinterpret_cast<float4*>(buf + r) + part, row + 4 * part);
  }
  for (int r = tid; r < n; r += n_threads) {
    const float* row = ent_n + static_cast<size_t>(sorted_idx[base + r]) * kEntWidth;
    cp_async16(reinterpret_cast<float4*>(buf + r) + 2, row + 8);
  }
  cp_async_commit();
}

// Wait for this thread's copies and write the power cut of the rows whose
// part 2 it copied. A __syncthreads() must follow before any thread reads buf.
__device__ __forceinline__ void finish_rows(Entry* buf, int n, int tid, int n_threads) {
  cp_async_wait_all();
  for (int r = tid; r < n; r += n_threads) buf[r].cut = power_cut(buf[r].opa);
}

}  // namespace dogs
