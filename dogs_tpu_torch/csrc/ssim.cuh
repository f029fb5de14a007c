// The D-SSIM loss and its gradient: what one thread of ssim.cu's kernels does
// with its CTA's tile, shared by the Hopper kernels and by a host build
// (-DDOGS_SSIM_HOST, compiled as C++ with g++ by the CPU tests), so the CPU
// tests hold the kernels' own walk and arithmetic against raster/ssim.py.
//
// Forward, per channel of a (B, H, W, C) pair x (the render), y (the target),
// in raster/ssim.py:ssim_map's order, each multiply and add rounded on its own:
//   blur(v): the 11-tap window w (sigma 1.5, float32, from the wrapper) with
//     zero "same" padding, taps k = 0..10 summed left to right from w0 v0,
//     over H first, then over W;
//   mu1 = blur(x), mu2 = blur(y), mu1_sq = mu1 mu1, mu2_sq = mu2 mu2,
//   mu12 = mu1 mu2, s11 = blur(x x) - mu1_sq, s22 = blur(y y) - mu2_sq,
//   s12 = blur(x y) - mu12,
//   a = 2 mu12 + C1, b = 2 s12 + C2, cc = (mu1_sq + mu2_sq) + C1,
//   dd = (s11 + s22) + C2, m = (a b) / (cc dd).
// So the map equals ssim_map's bit for bit. The loss is the mean of m: a sum
// a thread, a fixed tree a CTA, and a fixed double tree over the CTAs' sums.
// For the backward the forward keeps, at each pixel, m's derivatives in
// blur(x), blur(x x) and blur(x y):
//   P1 = dm/dmu1, with mu1's share of s11 and s12 folded in,
//   P2 = dm/ds11, P3 = dm/ds12.
// Backward: with a symmetric window and zero padding the blur's transpose is
// the blur, so the gradient of the mean in x is
//   dx = (g / numel) ((blur(P1) + (2 x) blur(P2)) + y blur(P3)).
// y is a constant: the loss has no gradient in the target.

#pragma once

#ifdef __CUDACC__
#define DOGS_SSIM_HD __host__ __device__ __forceinline__
#else
#define DOGS_SSIM_HD inline
#endif

namespace dogs_ssim {

constexpr int kTaps = 11;
constexpr int kHalo = kTaps / 2;
constexpr int kTileH = 16;  // output rows a CTA
constexpr int kTileW = 32;  // output columns a CTA: one warp a row
constexpr int kThreads = 256;
constexpr int kInW = kTileW + 2 * kHalo;            // staged columns
constexpr int kIn = (kTileH + 2 * kHalo) * kInW;    // staged pixels of one plane
constexpr int kMid = kTileH * kInW;                 // H-pass sums of one quantity
constexpr int kOut = kTileH * kTileW;

// One call. Pointers are f32 on one device, contiguous; the three planes of
// dmap are each laid out as x.
struct Args {
  const float* x;      // (B, H, W, C) the render
  const float* y;      // (B, H, W, C) the target
  float* dmap;         // (3, B, H, W, C): P1, P2, P3; forward: null = not kept; backward: read
  float* map;          // (B, H, W, C) the SSIM map; null = not written (forward)
  float* partial;      // (CTAs,) the map's sum over each CTA's tile (forward)
  float* loss;         // () the mean of the map (forward)
  const float* grad;   // () the loss's cotangent (backward)
  float* dx;           // (B, H, W, C) the gradient in x (backward)
  long long batch;
  int height, width, channels;
  float window[kTaps];
  float c1, c2;        // float32 of 0.01^2 and 0.03^2
};

// A CTA's shared memory: the staged planes of one channel and their H-pass
// sums (forward: x, y, then mu1, mu2, x x, y y, x y; backward: P1-P3 twice),
// and a sum a thread.
struct Smem {
  float in[3][kIn];
  float mid[5][kMid];
  float sum[kThreads];
};

struct Tile {
  long long b;
  int h0, w0;
};

DOGS_SSIM_HD long long at(const Args& a, long long b, int h, int w, int c) {
  return ((b * a.height + h) * a.width + w) * a.channels + c;
}

DOGS_SSIM_HD long long numel(const Args& a) {
  return a.batch * a.height * a.width * a.channels;
}

DOGS_SSIM_HD int tiles_w(const Args& a) { return (a.width + kTileW - 1) / kTileW; }
DOGS_SSIM_HD int tiles_h(const Args& a) { return (a.height + kTileH - 1) / kTileH; }

// Stage channel c of `n` planes over the tile and its 5-pixel halo; zero
// outside the image, as the plain path's padding.
DOGS_SSIM_HD void stage(const Args& a, const float* const* src, int n, const Tile& T, int c, float (*in)[kIn],
                        int t) {
  for (int i = t; i < kIn; i += kThreads) {
    const int r = i / kInW, col = i - r * kInW;
    const int h = T.h0 + r - kHalo, w = T.w0 + col - kHalo;
    const bool inside = h >= 0 && h < a.height && w >= 0 && w < a.width;
    const long long k = inside ? at(a, T.b, h, w, c) : 0;
    for (int q = 0; q < n; ++q) in[q][i] = inside ? src[q][k] : 0.0f;
  }
}

// sum_k w_k v[k stride], left to right from w_0 v_0.
DOGS_SSIM_HD float taps(const float* w, const float* v, int stride) {
  float total = w[0] * v[0];
  for (int k = 1; k < kTaps; ++k) total = total + w[k] * v[k * stride];
  return total;
}

// Forward H pass: mid[0..4] = blur_H of x, y, x x, y y, x y at every staged
// column (zero where the column lies outside the image, as the W pass's
// padding wants).
DOGS_SSIM_HD void h_pass_forward(const Args& a, float (*in)[kIn], float (*mid)[kMid], int t) {
  const float* w = a.window;
  for (int i = t; i < kMid; i += kThreads) {
    const float* x = in[0] + i;
    const float* y = in[1] + i;
    float mx = w[0] * x[0], my = w[0] * y[0];
    float mxx = w[0] * (x[0] * x[0]), myy = w[0] * (y[0] * y[0]), mxy = w[0] * (x[0] * y[0]);
    for (int k = 1; k < kTaps; ++k) {
      const float xv = x[k * kInW], yv = y[k * kInW];
      mx = mx + w[k] * xv;
      my = my + w[k] * yv;
      mxx = mxx + w[k] * (xv * xv);
      myy = myy + w[k] * (yv * yv);
      mxy = mxy + w[k] * (xv * yv);
    }
    mid[0][i] = mx;
    mid[1][i] = my;
    mid[2][i] = mxx;
    mid[3][i] = myy;
    mid[4][i] = mxy;
  }
}

// Backward H pass: mid[q] = blur_H of the staged P_q.
DOGS_SSIM_HD void h_pass_backward(const Args& a, float (*in)[kIn], float (*mid)[kMid], int t) {
  for (int i = t; i < kMid; i += kThreads)
    for (int q = 0; q < 3; ++q) mid[q][i] = taps(a.window, in[q] + i, kInW);
}

// One pixel's map from its blurs; its derivatives P1-P3 in d when d is set.
DOGS_SSIM_HD float pixel(const Args& a, float mu1, float mu2, float bxx, float byy, float bxy, float* d) {
  const float mu1_sq = mu1 * mu1, mu2_sq = mu2 * mu2, mu12 = mu1 * mu2;
  const float s11 = bxx - mu1_sq, s22 = byy - mu2_sq, s12 = bxy - mu12;
  const float ta = 2.0f * mu12 + a.c1, tb = 2.0f * s12 + a.c2;
  const float cc = mu1_sq + mu2_sq + a.c1, dd = s11 + s22 + a.c2;
  const float den = cc * dd;
  const float m = ta * tb / den;
  if (d) {
    // m = ta tb / (cc dd): its partials in ta, tb, cc and dd, then the chain
    // through mu1 (ta, tb by mu12; cc, dd by mu1_sq), s11 and s12.
    const float r = 1.0f / den;
    const float ga = tb * r, gb = ta * r;
    const float gden = -m * r;
    const float gcc = gden * dd, gdd = gden * cc;
    d[0] = 2.0f * (mu1 * (gcc - gdd) + mu2 * (ga - gb));
    d[1] = gdd;
    d[2] = 2.0f * gb;
  }
  return m;
}

// Forward W pass and the map at the CTA's pixels of channel c: writes the
// map and P1-P3 where asked for; returns `sum` plus the thread's map values.
DOGS_SSIM_HD float w_pass_forward(const Args& a, const Tile& T, int c, float (*mid)[kMid], int t, float sum) {
  const long long plane = numel(a);
  for (int i = t; i < kOut; i += kThreads) {
    const int r = i / kTileW, col = i - r * kTileW;
    const int h = T.h0 + r, w = T.w0 + col;
    if (h >= a.height || w >= a.width) continue;
    const int j = r * kInW + col;
    float d[3];
    const float m = pixel(a, taps(a.window, mid[0] + j, 1), taps(a.window, mid[1] + j, 1),
                          taps(a.window, mid[2] + j, 1), taps(a.window, mid[3] + j, 1),
                          taps(a.window, mid[4] + j, 1), a.dmap ? d : nullptr);
    const long long k = at(a, T.b, h, w, c);
    if (a.map) a.map[k] = m;
    if (a.dmap)
      for (int q = 0; q < 3; ++q) a.dmap[q * plane + k] = d[q];
    sum = sum + m;
  }
  return sum;
}

// Backward W pass and the gradient at the CTA's pixels of channel c.
DOGS_SSIM_HD void w_pass_backward(const Args& a, const Tile& T, int c, float (*mid)[kMid], float scale, int t) {
  for (int i = t; i < kOut; i += kThreads) {
    const int r = i / kTileW, col = i - r * kTileW;
    const int h = T.h0 + r, w = T.w0 + col;
    if (h >= a.height || w >= a.width) continue;
    const int j = r * kInW + col;
    const long long k = at(a, T.b, h, w, c);
    const float b1 = taps(a.window, mid[0] + j, 1), b2 = taps(a.window, mid[1] + j, 1);
    const float b3 = taps(a.window, mid[2] + j, 1);
    a.dx[k] = scale * (b1 + 2.0f * a.x[k] * b2 + a.y[k] * b3);
  }
}

// g / numel, the cotangent of each map value.
DOGS_SSIM_HD float grad_scale(const Args& a) {
  return static_cast<float>(static_cast<double>(*a.grad) / static_cast<double>(numel(a)));
}

// Thread t's share of the CTAs' sums, in double, before the tree.
DOGS_SSIM_HD double mean_run(const Args& a, long long ctas, int t) {
  double v = 0.0;
  for (long long i = t; i < ctas; i += kThreads) v += a.partial[i];
  return v;
}

}  // namespace dogs_ssim

#ifdef DOGS_SSIM_HOST
// The kernels' grids on the host, CTA by CTA and thread by thread with each
// phase between two barriers run for every thread in turn, for the CPU tests.
#include <vector>

namespace dogs_ssim {

template <typename Phase>
void each_thread(Phase phase) {
  for (int t = 0; t < kThreads; ++t) phase(t);
}

template <typename V>
void tree(V* v) {
  for (int s = kThreads / 2; s > 0; s >>= 1)
    for (int t = 0; t < s; ++t) v[t] = v[t] + v[t + s];
}

template <typename Body>
void each_tile(const Args& a, Body body) {
  for (long long b = 0; b < a.batch; ++b)
    for (int by = 0; by < tiles_h(a); ++by)
      for (int bx = 0; bx < tiles_w(a); ++bx)
        body(Tile{b, by * kTileH, bx * kTileW}, (b * tiles_h(a) + by) * tiles_w(a) + bx);
}

}  // namespace dogs_ssim

extern "C" int dogs_ssim_forward_host(const dogs_ssim::Args* args) {
  using namespace dogs_ssim;
  const Args a = *args;
  std::vector<Smem> smem(1);
  Smem& s = smem[0];
  const float* src[2] = {a.x, a.y};
  long long ctas = 0;
  each_tile(a, [&](const Tile& T, long long cta) {
    each_thread([&](int t) { s.sum[t] = 0.0f; });
    for (int c = 0; c < a.channels; ++c) {
      each_thread([&](int t) { stage(a, src, 2, T, c, s.in, t); });
      each_thread([&](int t) { h_pass_forward(a, s.in, s.mid, t); });
      each_thread([&](int t) { s.sum[t] = w_pass_forward(a, T, c, s.mid, t, s.sum[t]); });
    }
    tree(s.sum);
    a.partial[cta] = s.sum[0];
    ctas = cta + 1;
  });
  double v[kThreads];
  each_thread([&](int t) { v[t] = mean_run(a, ctas, t); });
  tree(v);
  *a.loss = static_cast<float>(v[0] / static_cast<double>(numel(a)));
  return 0;
}

extern "C" int dogs_ssim_backward_host(const dogs_ssim::Args* args) {
  using namespace dogs_ssim;
  const Args a = *args;
  std::vector<Smem> smem(1);
  Smem& s = smem[0];
  const long long plane = numel(a);
  const float* src[3] = {a.dmap, a.dmap + plane, a.dmap + 2 * plane};
  const float scale = grad_scale(a);
  each_tile(a, [&](const Tile& T, long long) {
    for (int c = 0; c < a.channels; ++c) {
      each_thread([&](int t) { stage(a, src, 3, T, c, s.in, t); });
      each_thread([&](int t) { h_pass_backward(a, s.in, s.mid, t); });
      each_thread([&](int t) { w_pass_backward(a, T, c, s.mid, scale, t); });
    }
  });
  return 0;
}
#endif  // DOGS_SSIM_HOST
