// Shared by the blend forward (blend_forward.cu) and backward
// (blend_backward.cu): the tile geometry, the entry-matrix layout and the
// per-pixel alpha of one entry.
//
// The backward replays the forward's stop decision (a pixel stops at the
// first entry whose log T would fall below log(1e-4)). If the two kernels
// rounded alpha differently, that decision could flip at a pixel and the
// backward would give gradients for a contribution the forward never made.
// So both compute alpha here, with explicitly rounded f32 operations
// (__fmul_rn / __fadd_rn: no FMA contraction that could differ between the
// two compilation contexts), and both call the same expf/log1pf.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dogs {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;  // threads per CTA, one per pixel
constexpr int kEntWidth = 16;        // f32 columns per entry row
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kLogTMin = -9.210340371976182f;  // log(1e-4)

// The first 12 columns of an entry row, in column order, so that staging
// one row into shared memory is three 16-byte copies.
struct __align__(16) Entry {
  float mux, muy, ca, cb;   // columns 0-3: screen mean, conic a, b
  float cc, r, g, b;        // columns 4-7: conic c, colour
  float opa, invd, depth;   // columns 8-10: opacity, inverse depth, depth
  float pad;                // column 11: unread
};

__device__ __forceinline__ Entry load_entry(const float* __restrict__ ent, int e) {
  const float4* row = reinterpret_cast<const float4*>(ent + static_cast<size_t>(e) * kEntWidth);
  Entry s;
  reinterpret_cast<float4*>(&s)[0] = row[0];
  reinterpret_cast<float4*>(&s)[1] = row[1];
  reinterpret_cast<float4*>(&s)[2] = row[2];
  return s;
}

// alpha = min(0.99, opa * exp(min(power, 0))) with
// power = -0.5 (a dx^2 + c dy^2) - b dx dy; also returns exp(min(power, 0)).
// Callers drop the entry at this pixel when alpha < kAlphaMin.
__device__ __forceinline__ float entry_alpha(const Entry& s, float dx, float dy, float* expp) {
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(s.ca, dx), dx), __fmul_rn(__fmul_rn(s.cc, dy), dy));
  const float power = __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(__fmul_rn(s.cb, dx), dy));
  *expp = expf(fminf(power, 0.0f));
  return fminf(kAlphaMax, __fmul_rn(s.opa, *expp));
}

}  // namespace dogs
