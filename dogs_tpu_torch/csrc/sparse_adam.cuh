// The visibility-masked sparse Adam: what one thread of sparse_adam.cu's
// kernel does with its CTA's tile of rows, shared by the Hopper kernel and by
// a host build (-DDOGS_SPARSE_ADAM_HOST, compiled as C++ with g++ by the CPU
// tests), so the CPU tests hold the kernel's own walk and arithmetic against
// the plain loop of train/optim.py.
//
// Per element of a visible row, the plain loop's operations in its order,
// each rounded on its own (no bias correction; eps 1e-15 in the trainer):
//   m' = b1 m + (1 - b1) g
//   v' = b2 v + ((1 - b2) g) g
//   p' = p + (-lr m') / (sqrt(v') + eps)
// where b1, 1 - b1, b2, 1 - b2, eps and -lr are the float32 roundings of the
// Python doubles the plain loop multiplies by. Rows that are not visible keep
// p, m and v untouched.

#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define DOGS_ADAM_HD __device__ __forceinline__
#else
#include <string.h>
#define DOGS_ADAM_HD inline
#endif

namespace dogs_adam {

constexpr int kLeaves = 6;  // xyz, feat_dc, feat_rest, log_scale, quat, logit_opacity
// Rows a CTA: a multiple of 4, so that each leaf's span of a tile starts on a
// 16-byte boundary whatever the leaf's row width.
constexpr int kRows = 128;
constexpr int kThreads = 256;

// One leaf: (N, width) f32, row-major and contiguous, 16-byte aligned; g is
// the gradient. width 0 (no SH rest rows) is skipped.
struct Leaf {
  float* p;
  const float* g;
  float* m;
  float* v;
  long long width;
  float neg_lr;  // float32(-lr)
};

struct Args {
  Leaf leaf[kLeaves];
  const uint8_t* visible;  // (N,) bool
  long long n;
  float b1, c1, b2, c2, eps;  // float32 of b1, 1 - b1, b2, 1 - b2, eps
};

#ifdef __CUDACC__
using Vec = float4;
DOGS_ADAM_HD Vec load4(const float* p) { return __ldcs(reinterpret_cast<const float4*>(p)); }
DOGS_ADAM_HD void store4(float* p, const Vec& x) { __stcs(reinterpret_cast<float4*>(p), x); }
#else
struct alignas(16) Vec {
  float x, y, z, w;
};
DOGS_ADAM_HD Vec load4(const float* p) {
  Vec x;
  memcpy(&x, p, sizeof x);
  return x;
}
DOGS_ADAM_HD void store4(float* p, const Vec& x) { memcpy(p, &x, sizeof x); }
#endif

DOGS_ADAM_HD void update(const Args& a, float neg_lr, float g, float& p, float& m, float& v) {
  const float m2 = a.b1 * m + a.c1 * g;
  const float v2 = a.b2 * v + a.c2 * g * g;
  const float step = neg_lr * m2 / (sqrtf(v2) + a.eps);
  p = p + step;
  m = m2;
  v = v2;
}

// One float4 of a leaf: its four elements' rows' visibility in `on`.
DOGS_ADAM_HD void update4(const Args& a, const Leaf& L, long long at, const bool on[4]) {
  Vec g = load4(L.g + at), p = load4(L.p + at), m = load4(L.m + at), v = load4(L.v + at);
  if (on[0]) update(a, L.neg_lr, g.x, p.x, m.x, v.x);
  if (on[1]) update(a, L.neg_lr, g.y, p.y, m.y, v.y);
  if (on[2]) update(a, L.neg_lr, g.z, p.z, m.z, v.z);
  if (on[3]) update(a, L.neg_lr, g.w, p.w, m.w, v.w);
  store4(L.p + at, p);
  store4(L.m + at, m);
  store4(L.v + at, v);
}

// Thread t's share of the tile of `rows` rows from row r0, whose visibility
// is vis[0:rows]. The six leaves' spans [r0 w, (r0 + rows) w) are taken as
// one run of float4s, dealt round-robin over the CTA's threads, so every
// thread gets the same share whatever the widths. A float4 whose four rows
// are all invisible is neither read nor written; in a partly visible one the
// invisible elements are written back as read. The span's last count % 4
// floats (the last tile only) go one a thread.
DOGS_ADAM_HD void tile_thread(const Args& a, long long r0, int rows, const bool* vis, int t) {
  int off = 0;  // float4s of the leaves before this one, mod kThreads
#ifdef __CUDACC__
#pragma unroll
#endif
  for (int k = 0; k < kLeaves; ++k) {
    const Leaf L = a.leaf[k];
    const int w = static_cast<int>(L.width);
    const long long base = r0 * L.width;
    const int count = rows * w;
    const int vecs = count / 4;
    for (int i = (t - off + kThreads) % kThreads; i < vecs; i += kThreads) {
      int r = 4 * i / w, c = 4 * i - r * w;
      bool on[4];
      for (int j = 0; j < 4; ++j) {
        on[j] = vis[r];
        if (++c == w) {
          c = 0;
          ++r;
        }
      }
      if (on[0] || on[1] || on[2] || on[3]) update4(a, L, base + 4 * i, on);
    }
    const int e = 4 * vecs + t;
    if (e < count && vis[e / w]) update(a, L.neg_lr, L.g[base + e], L.p[base + e], L.m[base + e], L.v[base + e]);
    off = (off + vecs) % kThreads;
  }
}

}  // namespace dogs_adam

#ifdef DOGS_SPARSE_ADAM_HOST
// The kernel's grid on the host, CTA by CTA and thread by thread, for the
// CPU tests.
extern "C" int dogs_sparse_adam_host(const dogs_adam::Args* args) {
  using namespace dogs_adam;
  const Args a = *args;
  bool vis[kRows];
  for (long long r0 = 0; r0 < a.n; r0 += kRows) {
    const int rows = static_cast<int>(a.n - r0 < kRows ? a.n - r0 : kRows);
    bool any = false;
    for (int i = 0; i < rows; ++i) any |= (vis[i] = a.visible[r0 + i] != 0);
    if (!any) continue;
    for (int t = 0; t < kThreads; ++t) tile_thread(a, r0, rows, vis, t);
  }
  return 0;
}
#endif  // DOGS_SPARSE_ADAM_HOST
