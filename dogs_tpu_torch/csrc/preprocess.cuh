// Per-Gaussian rasterization preprocess, forward and backward: the arithmetic
// one thread does for one Gaussian slot, shared by the Hopper kernels of
// preprocess.cu and by a host build (-DDOGS_PREPROCESS_HOST, compiled as C++
// with g++ by the CPU tests), so the CPU tests hold the kernels' own
// arithmetic against autograd through raster/projection.py.
//
// Forward (raster/projection.py:project_gaussians, then
// projection.py:entry_matrix), in the plain version's order of operations:
//   p = R x + t; near-plane test z > 0.2; u = fx p0 / z + cx (+ offset)
//   Sigma = M M^T, M = rot(q / |q|) diag(exp(log_scale) * modifier)
//   EWA with the 1.3 tan(fov/2) clamp, + 0.3 px low-pass, conic, the
//   optional antialiasing rescale sqrt(det / det_blurred) of the opacity,
//   3-sigma radius, visibility (in front, det > 0, opacity > 1/255, alive)
//   colour: SH of degree kDeg at the unit view direction + 0.5, clamped at 0,
//   or the override clamped at 0
//   entry row: mux, muy, conic a b c, r g b, opacity and inverse depth
//   (zero where not visible; the inverse depth plus its offset), the depth
//   (1 where not visible), five zeros.
// Backward: the vector-Jacobian product of that map for the entry row's
// columns 0-9 (the depth column is a constant to autograd), with autograd's
// rules: a clamp passes the gradient inside its closed range, a `where`
// routes it to the branch taken, a slot with radius 0 gets zeros (its entry
// row reaches no pixel) except the two offsets, whose gradients are the
// row's own columns on every slot.

#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define DOGS_HD __host__ __device__ __forceinline__
#else
#define DOGS_HD inline
#endif

namespace dogs_pre {

// The inputs of one call; pointers are f32 (alive: bool) on one device,
// row-major and contiguous, null where absent.
struct Args {
  const float* xyz;            // (N, 3)
  const float* log_scale;      // (N, 3)
  const float* quat;           // (N, 4) wxyz, unnormalized
  const float* logit_opacity;  // (N,)
  const float* feat_dc;        // (N, 3)
  const float* feat_rest;      // (N, rest_rows, 3)
  const float* color;          // (N, 3) colour override
  const float* means2d_offset; // (N, 2)
  const float* invd_offset;    // (N,)
  const uint8_t* alive;        // (N,)
  const float* R;              // (3, 3) world to camera
  const float* t;              // (3,)
  const float* fx;             // ()
  const float* fy;
  const float* cx;
  const float* cy;
  int n;
  int rest_rows;  // rows of feat_rest per Gaussian: (max degree + 1)^2 - 1
  int width;
  int height;
  int degree;
  int antialiasing;
  float scale_modifier;
};

// The backward's inputs beyond Args and its outputs (null: not asked for).
struct Grads {
  const float* d_ent;   // (N, 16) the entry matrix's cotangent
  const float* radius;  // (N,) the forward's radius: 0 = not visible
  float* xyz;
  float* log_scale;
  float* quat;
  float* logit_opacity;
  float* feat_dc;
  float* feat_rest;     // (N, rest_rows, 3), zeros past the active degree
  float* color;
  float* means2d_offset;
  float* invd_offset;
  float* camera;        // 12 floats a Gaussian (host) or a block (device):
                        // d R row-major, then d t
};

constexpr int kEntWidth = 16;
constexpr int kCamGrads = 12;
constexpr float kNear = 0.2f;
constexpr float kLowPass = 0.3f;
constexpr float kAlphaMin = static_cast<float>(1.0 / 255.0);
constexpr float kEps = 1e-12f;

// core/sh.py's constants, as PyTorch casts a Python float to f32.
constexpr float kC0 = static_cast<float>(0.28209479177387814);
constexpr float kC1 = static_cast<float>(0.4886025119029199);
// Scalars, not arrays: nvcc lets device code read a constexpr scalar only.
constexpr float kC2_0 = static_cast<float>(1.0925484305920792);
constexpr float kC2_1 = static_cast<float>(-1.0925484305920792);
constexpr float kC2_2 = static_cast<float>(0.31539156525252005);
constexpr float kC2_3 = static_cast<float>(-1.0925484305920792);
constexpr float kC2_4 = static_cast<float>(0.5462742152960396);
constexpr float kC3_0 = static_cast<float>(-0.5900435899266435);
constexpr float kC3_1 = static_cast<float>(2.890611442640554);
constexpr float kC3_2 = static_cast<float>(-0.4570457994644658);
constexpr float kC3_3 = static_cast<float>(0.3731763325901154);
constexpr float kC3_4 = static_cast<float>(-0.4570457994644658);
constexpr float kC3_5 = static_cast<float>(1.445305721320277);
constexpr float kC3_6 = static_cast<float>(-0.5900435899266435);
constexpr float kC4_0 = static_cast<float>(2.5033429417967046);
constexpr float kC4_1 = static_cast<float>(-1.7701307697799304);
constexpr float kC4_2 = static_cast<float>(0.9461746957575601);
constexpr float kC4_3 = static_cast<float>(-0.6690465435572892);
constexpr float kC4_4 = static_cast<float>(0.10578554691520431);
constexpr float kC4_5 = static_cast<float>(-0.6690465435572892);
constexpr float kC4_6 = static_cast<float>(0.47308734787878004);
constexpr float kC4_7 = static_cast<float>(-1.7701307697799304);
constexpr float kC4_8 = static_cast<float>(0.6258357354491761);

template <int kDeg>
constexpr int num_bases() {
  return (kDeg + 1) * (kDeg + 1);
}

// torch.clamp's forward (a NaN stays NaN) and the closed range its backward
// passes.
DOGS_HD float clamp_min(float x, float lo) { return x < lo ? lo : x; }
DOGS_HD float clamp_range(float x, float lo, float hi) { return x < lo ? lo : (x > hi ? hi : x); }
DOGS_HD bool in_range(float x, float lo, float hi) { return x >= lo && x <= hi; }

struct Cam {
  float R[9], t[3], fx, fy, cx, cy, limx, limy, campos[3];
};

DOGS_HD Cam load_camera(const Args& a) {
  Cam c;
  for (int k = 0; k < 9; ++k) c.R[k] = a.R[k];
  for (int k = 0; k < 3; ++k) c.t[k] = a.t[k];
  c.fx = *a.fx;
  c.fy = *a.fy;
  c.cx = *a.cx;
  c.cy = *a.cy;
  // tan_half_fov = 0.5 * width / fx, as Tensor.__rtruediv__: reciprocal, times.
  c.limx = static_cast<float>(1.3) * ((1.0f / c.fx) * static_cast<float>(0.5 * a.width));
  c.limy = static_cast<float>(1.3) * ((1.0f / c.fy) * static_cast<float>(0.5 * a.height));
  // camera_center = -(R * t[:, None]).sum(0)
  for (int j = 0; j < 3; ++j) {
    c.campos[j] = -((c.R[j] * c.t[0] + c.R[3 + j] * c.t[1]) + c.R[6 + j] * c.t[2]);
  }
  return c;
}

// Everything of the forward but the colour, kept for the backward.
struct Geo {
  float x[3], p[3], z, zs, u_num, v_num;
  bool in_front;
  float e[3], s[3], q[4], qn[4], qnorm, qnc, r[9], m[9], cov[6];
  float qx, qy, txtz, tytz, inv_z, j00, j02, j11, j12, t0[3], t1[3];
  float ra, rb, rc, a, b, c, det, ds, inv_det;
  float sig, det_raw, ratio, h, opa;
  float mux, muy, conic[3], radius;
};

// u . Sigma . v for the symmetric Sigma in (s11, s12, s13, s22, s23, s33).
DOGS_HD float quad(const float* u, const float* v, const float* s) {
  return ((((u[0] * v[0] * s[0] + u[1] * v[1] * s[3]) + u[2] * v[2] * s[5]) +
           (u[0] * v[1] + u[1] * v[0]) * s[1]) +
          (u[0] * v[2] + u[2] * v[0]) * s[2]) +
         (u[1] * v[2] + u[2] * v[1]) * s[4];
}

DOGS_HD void sym_times(const float* s, const float* v, float* out) {
  out[0] = s[0] * v[0] + s[1] * v[1] + s[2] * v[2];
  out[1] = s[1] * v[0] + s[3] * v[1] + s[4] * v[2];
  out[2] = s[2] * v[0] + s[4] * v[1] + s[5] * v[2];
}

DOGS_HD void geometry(const Args& a, const Cam& cam, long long i, Geo& g) {
  for (int k = 0; k < 3; ++k) g.x[k] = a.xyz[3 * i + k];
  for (int j = 0; j < 3; ++j) {
    g.p[j] = ((g.x[0] * cam.R[3 * j] + g.x[1] * cam.R[3 * j + 1]) + g.x[2] * cam.R[3 * j + 2]) + cam.t[j];
  }
  g.z = g.p[2];
  g.in_front = g.z > kNear;
  g.zs = g.in_front ? g.z : 1.0f;
  g.u_num = cam.fx * g.p[0];
  g.v_num = cam.fy * g.p[1];
  g.mux = g.u_num / g.zs + cam.cx;
  g.muy = g.v_num / g.zs + cam.cy;
  if (a.means2d_offset != nullptr) {
    g.mux = g.mux + a.means2d_offset[2 * i];
    g.muy = g.muy + a.means2d_offset[2 * i + 1];
  }

  // covariance_sym6(exp(log_scale) * modifier, quat / |quat|)
  for (int k = 0; k < 3; ++k) {
    g.e[k] = expf(a.log_scale[3 * i + k]);
    g.s[k] = g.e[k] * a.scale_modifier;
  }
  for (int k = 0; k < 4; ++k) g.q[k] = a.quat[4 * i + k];
  g.qnorm = sqrtf(((g.q[0] * g.q[0] + g.q[1] * g.q[1]) + g.q[2] * g.q[2]) + g.q[3] * g.q[3]);
  g.qnc = clamp_min(g.qnorm, kEps);
  for (int k = 0; k < 4; ++k) g.qn[k] = g.q[k] / g.qnc;
  const float w = g.qn[0], x = g.qn[1], y = g.qn[2], z = g.qn[3];
  g.r[0] = 1.0f - 2.0f * (y * y + z * z);
  g.r[1] = 2.0f * (x * y - w * z);
  g.r[2] = 2.0f * (x * z + w * y);
  g.r[3] = 2.0f * (x * y + w * z);
  g.r[4] = 1.0f - 2.0f * (x * x + z * z);
  g.r[5] = 2.0f * (y * z - w * x);
  g.r[6] = 2.0f * (x * z - w * y);
  g.r[7] = 2.0f * (y * z + w * x);
  g.r[8] = 1.0f - 2.0f * (x * x + y * y);
  for (int k = 0; k < 9; ++k) g.m[k] = g.r[k] * g.s[k % 3];
  const float* m = g.m;
  g.cov[0] = (m[0] * m[0] + m[1] * m[1]) + m[2] * m[2];
  g.cov[1] = (m[0] * m[3] + m[1] * m[4]) + m[2] * m[5];
  g.cov[2] = (m[0] * m[6] + m[1] * m[7]) + m[2] * m[8];
  g.cov[3] = (m[3] * m[3] + m[4] * m[4]) + m[5] * m[5];
  g.cov[4] = (m[3] * m[6] + m[4] * m[7]) + m[5] * m[8];
  g.cov[5] = (m[6] * m[6] + m[7] * m[7]) + m[8] * m[8];

  // compute_cov2d on p_cam_safe (1, 1, 1 behind the near plane)
  const float pc0 = g.in_front ? g.p[0] : 1.0f;
  const float pc1 = g.in_front ? g.p[1] : 1.0f;
  const float zc = g.in_front ? g.p[2] : 1.0f;
  g.qx = pc0 / zc;
  g.qy = pc1 / zc;
  g.txtz = clamp_range(g.qx, -cam.limx, cam.limx);
  g.tytz = clamp_range(g.qy, -cam.limy, cam.limy);
  g.inv_z = 1.0f / zc;
  g.j00 = cam.fx * g.inv_z;
  g.j02 = (-cam.fx * g.txtz) * g.inv_z;
  g.j11 = cam.fy * g.inv_z;
  g.j12 = (-cam.fy * g.tytz) * g.inv_z;
  for (int k = 0; k < 3; ++k) {
    g.t0[k] = g.j00 * cam.R[k] + g.j02 * cam.R[6 + k];
    g.t1[k] = g.j11 * cam.R[3 + k] + g.j12 * cam.R[6 + k];
  }
  g.ra = quad(g.t0, g.t0, g.cov);
  g.rb = quad(g.t0, g.t1, g.cov);
  g.rc = quad(g.t1, g.t1, g.cov);
  g.a = g.ra + kLowPass;
  g.b = g.rb;
  g.c = g.rc + kLowPass;
  g.det = g.a * g.c - g.b * g.b;
  g.ds = g.det > 0.0f ? g.det : 1.0f;
  g.inv_det = 1.0f / g.ds;
  g.conic[0] = g.c * g.inv_det;
  g.conic[1] = -g.b * g.inv_det;
  g.conic[2] = g.a * g.inv_det;

  g.sig = 1.0f / (1.0f + expf(-a.logit_opacity[i]));
  g.opa = g.sig;
  if (a.antialiasing) {
    g.det_raw = g.ra * g.rc - g.rb * g.rb;
    g.ratio = g.det_raw / g.ds;
    g.h = sqrtf(clamp_min(g.ratio, 0.0f) + kEps);
    g.opa = g.sig * g.h;
  }

  const float mid = 0.5f * (g.a + g.c);
  const float lam = mid + sqrtf(clamp_min(mid * mid - g.det, 0.1f));
  g.radius = ceilf(3.0f * sqrtf(lam));
  bool visible = g.in_front && g.det > 0.0f && g.opa > kAlphaMin;
  if (a.alive != nullptr) visible = visible && a.alive[i] != 0;
  if (!visible) g.radius = 0.0f;
}

// The SH bases b_k of eval_sh at a unit direction, in its order and grouping.
template <int kDeg>
DOGS_HD void sh_bases(float x, float y, float z, float* b) {
  b[0] = kC0;
  if (kDeg < 1) return;
  b[1] = -(kC1 * y);
  b[2] = kC1 * z;
  b[3] = -(kC1 * x);
  if (kDeg < 2) return;
  const float xx = x * x, yy = y * y, zz = z * z, xy = x * y, yz = y * z, xz = x * z;
  b[4] = kC2_0 * xy;
  b[5] = kC2_1 * yz;
  b[6] = kC2_2 * ((2.0f * zz - xx) - yy);
  b[7] = kC2_3 * xz;
  b[8] = kC2_4 * (xx - yy);
  if (kDeg < 3) return;
  b[9] = (kC3_0 * y) * (3.0f * xx - yy);
  b[10] = (kC3_1 * xy) * z;
  b[11] = (kC3_2 * y) * ((4.0f * zz - xx) - yy);
  b[12] = (kC3_3 * z) * ((2.0f * zz - 3.0f * xx) - 3.0f * yy);
  b[13] = (kC3_4 * x) * ((4.0f * zz - xx) - yy);
  b[14] = (kC3_5 * z) * (xx - yy);
  b[15] = (kC3_6 * x) * (xx - 3.0f * yy);
  if (kDeg < 4) return;
  b[16] = (kC4_0 * xy) * (xx - yy);
  b[17] = (kC4_1 * yz) * (3.0f * xx - yy);
  b[18] = (kC4_2 * xy) * (7.0f * zz - 1.0f);
  b[19] = (kC4_3 * yz) * (7.0f * zz - 3.0f);
  b[20] = kC4_4 * (zz * (35.0f * zz - 30.0f) + 3.0f);
  b[21] = (kC4_5 * xz) * (7.0f * zz - 3.0f);
  b[22] = (kC4_6 * (xx - yy)) * (7.0f * zz - 1.0f);
  b[23] = (kC4_7 * xz) * (xx - 3.0f * yy);
  b[24] = kC4_8 * (xx * (xx - 3.0f * yy) - yy * (3.0f * xx - yy));
}

// d/d(x, y, z) of sum_k db[k] b_k(x, y, z).
template <int kDeg>
DOGS_HD void sh_bases_vjp(float x, float y, float z, const float* db, float* d) {
  d[0] = d[1] = d[2] = 0.0f;
  if (kDeg < 1) return;
  d[0] += -kC1 * db[3];
  d[1] += -kC1 * db[1];
  d[2] += kC1 * db[2];
  if (kDeg < 2) return;
  const float xx = x * x, yy = y * y, zz = z * z, xy = x * y, yz = y * z, xz = x * z;
  d[0] += kC2_0 * y * db[4] - 2.0f * kC2_2 * x * db[6] + kC2_3 * z * db[7] + 2.0f * kC2_4 * x * db[8];
  d[1] += kC2_0 * x * db[4] + kC2_1 * z * db[5] - 2.0f * kC2_2 * y * db[6] - 2.0f * kC2_4 * y * db[8];
  d[2] += kC2_1 * y * db[5] + 4.0f * kC2_2 * z * db[6] + kC2_3 * x * db[7];
  if (kDeg < 3) return;
  d[0] += kC3_0 * 6.0f * xy * db[9] + kC3_1 * yz * db[10] - kC3_2 * 2.0f * xy * db[11] -
          kC3_3 * 6.0f * xz * db[12] + kC3_4 * ((4.0f * zz - 3.0f * xx) - yy) * db[13] +
          kC3_5 * 2.0f * xz * db[14] + kC3_6 * (3.0f * xx - 3.0f * yy) * db[15];
  d[1] += kC3_0 * (3.0f * xx - 3.0f * yy) * db[9] + kC3_1 * xz * db[10] +
          kC3_2 * ((4.0f * zz - xx) - 3.0f * yy) * db[11] - kC3_3 * 6.0f * yz * db[12] -
          kC3_4 * 2.0f * xy * db[13] - kC3_5 * 2.0f * yz * db[14] - kC3_6 * 6.0f * xy * db[15];
  d[2] += kC3_1 * xy * db[10] + kC3_2 * 8.0f * yz * db[11] +
          kC3_3 * ((6.0f * zz - 3.0f * xx) - 3.0f * yy) * db[12] + kC3_4 * 8.0f * xz * db[13] +
          kC3_5 * (xx - yy) * db[14];
  if (kDeg < 4) return;
  const float xyz = xy * z;
  d[0] += kC4_0 * y * (3.0f * xx - yy) * db[16] + kC4_1 * 6.0f * xyz * db[17] +
          kC4_2 * y * (7.0f * zz - 1.0f) * db[18] + kC4_5 * z * (7.0f * zz - 3.0f) * db[21] +
          kC4_6 * 2.0f * x * (7.0f * zz - 1.0f) * db[22] + kC4_7 * z * (3.0f * xx - 3.0f * yy) * db[23] +
          kC4_8 * 4.0f * x * (xx - 3.0f * yy) * db[24];
  d[1] += kC4_0 * x * (xx - 3.0f * yy) * db[16] + kC4_1 * z * (3.0f * xx - 3.0f * yy) * db[17] +
          kC4_2 * x * (7.0f * zz - 1.0f) * db[18] + kC4_3 * z * (7.0f * zz - 3.0f) * db[19] -
          kC4_6 * 2.0f * y * (7.0f * zz - 1.0f) * db[22] - kC4_7 * 6.0f * xyz * db[23] +
          kC4_8 * 4.0f * y * (yy - 3.0f * xx) * db[24];
  d[2] += kC4_1 * y * (3.0f * xx - yy) * db[17] + kC4_2 * 14.0f * xyz * db[18] +
          kC4_3 * y * (21.0f * zz - 3.0f) * db[19] + kC4_4 * z * (140.0f * zz - 60.0f) * db[20] +
          kC4_5 * x * (21.0f * zz - 3.0f) * db[21] + kC4_6 * 14.0f * z * (xx - yy) * db[22] +
          kC4_7 * x * (xx - 3.0f * yy) * db[23];
}

// The unit view direction (xyz - camera centre) / max(|.|, 1e-12).
struct Dir {
  float d[3], norm, nc, u[3];
};

DOGS_HD Dir view_dir(const float* x, const Cam& cam) {
  Dir v;
  for (int k = 0; k < 3; ++k) v.d[k] = x[k] - cam.campos[k];
  v.norm = sqrtf((v.d[0] * v.d[0] + v.d[1] * v.d[1]) + v.d[2] * v.d[2]);
  v.nc = clamp_min(v.norm, kEps);
  for (int k = 0; k < 3; ++k) v.u[k] = v.d[k] / v.nc;
  return v;
}

// d of v / max(|v|, eps) back to v, for K components.
template <int K>
DOGS_HD void normalize_vjp(const float* v, float norm, float nc, const float* dn, float* dv) {
  float dot = 0.0f;
  for (int k = 0; k < K; ++k) dot += dn[k] * v[k];
  const float d_nc = -dot / (nc * nc);
  const float d_norm = (norm >= kEps && norm != 0.0f) ? d_nc / norm : 0.0f;
  for (int k = 0; k < K; ++k) dv[k] = dn[k] / nc + d_norm * v[k];
}

// One slot's entry row and radius. `rest` holds this Gaussian's first
// (kDeg+1)^2 - 1 SH rows (3 floats each), unread with kOverride.
template <int kDeg, bool kOverride>
DOGS_HD void forward_one(const Args& a, const Cam& cam, long long i, const float* rest, float* row,
                         float* radius) {
  Geo g;
  geometry(a, cam, i, g);
  float rgb[3];
  if constexpr (kOverride) {
    for (int c = 0; c < 3; ++c) rgb[c] = clamp_min(a.color[3 * i + c], 0.0f);
  } else {
    const Dir v = view_dir(g.x, cam);
    float b[num_bases<kDeg>()];
    sh_bases<kDeg>(v.u[0], v.u[1], v.u[2], b);
    for (int c = 0; c < 3; ++c) {
      float acc = b[0] * a.feat_dc[3 * i + c];
      for (int k = 1; k < num_bases<kDeg>(); ++k) acc = acc + b[k] * rest[3 * (k - 1) + c];
      rgb[c] = clamp_min(acc + 0.5f, 0.0f);
    }
  }
  const bool vis = g.radius > 0.0f;
  float invd = vis ? 1.0f / g.z : 0.0f;
  if (a.invd_offset != nullptr) invd = invd + a.invd_offset[i];
  row[0] = g.mux;
  row[1] = g.muy;
  row[2] = g.conic[0];
  row[3] = g.conic[1];
  row[4] = g.conic[2];
  row[5] = rgb[0];
  row[6] = rgb[1];
  row[7] = rgb[2];
  row[8] = vis ? g.opa : 0.0f;
  row[9] = invd;
  row[10] = vis ? g.z : 1.0f;
  for (int k = 11; k < kEntWidth; ++k) row[k] = 0.0f;
  *radius = g.radius;
}

// One slot's gradients from its entry row's cotangent G. Writes every output
// that `out` asks for at slot i; `d_rest` gets this Gaussian's active SH rows'
// gradients (it may alias `rest`: each row is read before it is written);
// `cam` gets this slot's camera term (zeros when not asked for).
template <int kDeg, bool kOverride>
DOGS_HD void backward_one(const Args& a, const Cam& cam, long long i, const float* rest, const float* G,
                          float radius, const Grads& out, float* d_rest, float* cam_g) {
  constexpr int kRest = kOverride ? 0 : num_bases<kDeg>() - 1;
  if (out.means2d_offset != nullptr) {
    out.means2d_offset[2 * i] = G[0];
    out.means2d_offset[2 * i + 1] = G[1];
  }
  if (out.invd_offset != nullptr) out.invd_offset[i] = G[9];
  for (int k = 0; k < kCamGrads; ++k) cam_g[k] = 0.0f;
  const bool chain = out.xyz != nullptr || out.log_scale != nullptr || out.quat != nullptr ||
                     out.logit_opacity != nullptr || out.feat_dc != nullptr || out.feat_rest != nullptr ||
                     out.color != nullptr || out.camera != nullptr;
  if (!(radius > 0.0f) || !chain) {
    for (int k = 0; k < 3; ++k) {
      if (out.xyz != nullptr) out.xyz[3 * i + k] = 0.0f;
      if (out.log_scale != nullptr) out.log_scale[3 * i + k] = 0.0f;
      if (out.feat_dc != nullptr) out.feat_dc[3 * i + k] = 0.0f;
      if (out.color != nullptr) out.color[3 * i + k] = 0.0f;
    }
    if (out.quat != nullptr) {
      for (int k = 0; k < 4; ++k) out.quat[4 * i + k] = 0.0f;
    }
    if (out.logit_opacity != nullptr) out.logit_opacity[i] = 0.0f;
    for (int k = 0; k < 3 * kRest; ++k) d_rest[k] = 0.0f;
    return;
  }
  Geo g;
  geometry(a, cam, i, g);
  float dx[3] = {0.0f, 0.0f, 0.0f};  // d xyz
  float dR[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float dt[3] = {0.0f, 0.0f, 0.0f};

  // Colour.
  if constexpr (kOverride) {
    if (out.color != nullptr) {
      for (int c = 0; c < 3; ++c) out.color[3 * i + c] = a.color[3 * i + c] >= 0.0f ? G[5 + c] : 0.0f;
    }
  } else {
    const Dir v = view_dir(g.x, cam);
    float b[num_bases<kDeg>()];
    sh_bases<kDeg>(v.u[0], v.u[1], v.u[2], b);
    float gc[3];
    float db[num_bases<kDeg>()];
    for (int c = 0; c < 3; ++c) {
      float acc = b[0] * a.feat_dc[3 * i + c];
      for (int k = 1; k < num_bases<kDeg>(); ++k) acc = acc + b[k] * rest[3 * (k - 1) + c];
      gc[c] = acc + 0.5f >= 0.0f ? G[5 + c] : 0.0f;
    }
    db[0] = (gc[0] * a.feat_dc[3 * i] + gc[1] * a.feat_dc[3 * i + 1]) + gc[2] * a.feat_dc[3 * i + 2];
    if (out.feat_dc != nullptr) {
      for (int c = 0; c < 3; ++c) out.feat_dc[3 * i + c] = gc[c] * b[0];
    }
    for (int k = 1; k < num_bases<kDeg>(); ++k) {
      const float f0 = rest[3 * (k - 1)], f1 = rest[3 * (k - 1) + 1], f2 = rest[3 * (k - 1) + 2];
      db[k] = (gc[0] * f0 + gc[1] * f1) + gc[2] * f2;
      for (int c = 0; c < 3; ++c) d_rest[3 * (k - 1) + c] = gc[c] * b[k];
    }
    float du[3], dd[3];
    sh_bases_vjp<kDeg>(v.u[0], v.u[1], v.u[2], db, du);
    normalize_vjp<3>(v.d, v.norm, v.nc, du, dd);
    // d = x - campos, campos = -R^T t.
    for (int k = 0; k < 3; ++k) dx[k] += dd[k];
    for (int r = 0; r < 3; ++r) {
      for (int k = 0; k < 3; ++k) {
        dR[3 * r + k] += dd[k] * cam.t[r];
        dt[r] += cam.R[3 * r + k] * dd[k];
      }
    }
  }

  // Opacity (with the antialiasing factor) and inverse depth.
  float d_ra = 0.0f, d_rb = 0.0f, d_rc = 0.0f, d_ds = 0.0f;
  float d_sig = G[8];
  if (a.antialiasing) {
    d_sig = G[8] * g.h;
    const float d_h = G[8] * g.sig;
    const float d_ratio = g.ratio >= 0.0f ? d_h / (2.0f * g.h) : 0.0f;
    const float d_det_raw = d_ratio / g.ds;
    d_ds += -d_ratio * g.det_raw / (g.ds * g.ds);
    d_ra += d_det_raw * g.rc;
    d_rc += d_det_raw * g.ra;
    d_rb += -2.0f * g.rb * d_det_raw;
  }
  if (out.logit_opacity != nullptr) out.logit_opacity[i] = d_sig * (1.0f - g.sig) * g.sig;
  float dp[3] = {0.0f, 0.0f, 0.0f};  // d p_cam
  const float invd = 1.0f / g.z;
  dp[2] += -G[9] * (invd * invd);

  // Screen position: u = fx p0 / z + cx.
  dp[0] += (G[0] / g.z) * cam.fx;
  dp[1] += (G[1] / g.z) * cam.fy;
  dp[2] += -G[0] * g.u_num / (g.z * g.z) - G[1] * g.v_num / (g.z * g.z);

  // Conic (c, -b, a) / det.
  const float d_inv_det = (G[2] * g.c - G[3] * g.b) + G[4] * g.a;
  float d_a = G[4] * g.inv_det, d_b = -(G[3] * g.inv_det), d_c = G[2] * g.inv_det;
  d_ds += -d_inv_det * (g.inv_det * g.inv_det);
  d_a += d_ds * g.c;  // det = a c - b^2 (> 0 on a visible slot)
  d_c += d_ds * g.a;
  d_b += -2.0f * g.b * d_ds;
  d_ra += d_a;
  d_rb += d_b;
  d_rc += d_c;

  // ra = t0' S t0, rb = t0' S t1, rc = t1' S t1.
  float st0[3], st1[3], d_t0[3], d_t1[3], d_cov[6];
  sym_times(g.cov, g.t0, st0);
  sym_times(g.cov, g.t1, st1);
  for (int k = 0; k < 3; ++k) {
    d_t0[k] = 2.0f * d_ra * st0[k] + d_rb * st1[k];
    d_t1[k] = d_rb * st0[k] + 2.0f * d_rc * st1[k];
  }
  const int pr[6][2] = {{0, 0}, {0, 1}, {0, 2}, {1, 1}, {1, 2}, {2, 2}};
  for (int e = 0; e < 6; ++e) {
    const int p = pr[e][0], q = pr[e][1];
    const float both = d_ra * (g.t0[p] * g.t0[q]) + d_rb * (g.t0[p] * g.t1[q]) + d_rc * (g.t1[p] * g.t1[q]);
    const float swap = d_ra * (g.t0[q] * g.t0[p]) + d_rb * (g.t0[q] * g.t1[p]) + d_rc * (g.t1[q] * g.t1[p]);
    d_cov[e] = p == q ? both : both + swap;
  }

  // t0 = j00 R0 + j02 R2, t1 = j11 R1 + j12 R2 (rows of R).
  float d_j00 = 0.0f, d_j02 = 0.0f, d_j11 = 0.0f, d_j12 = 0.0f;
  for (int k = 0; k < 3; ++k) {
    d_j00 += d_t0[k] * cam.R[k];
    d_j02 += d_t0[k] * cam.R[6 + k];
    d_j11 += d_t1[k] * cam.R[3 + k];
    d_j12 += d_t1[k] * cam.R[6 + k];
    dR[k] += g.j00 * d_t0[k];
    dR[3 + k] += g.j11 * d_t1[k];
    dR[6 + k] += g.j02 * d_t0[k] + g.j12 * d_t1[k];
  }
  const float d_inv_z = ((d_j00 * cam.fx + d_j02 * (-cam.fx * g.txtz)) + d_j11 * cam.fy) +
                        d_j12 * (-cam.fy * g.tytz);
  const float d_txtz = d_j02 * g.inv_z * -cam.fx;
  const float d_tytz = d_j12 * g.inv_z * -cam.fy;
  dp[2] += -d_inv_z * (g.inv_z * g.inv_z);
  if (in_range(g.qx, -cam.limx, cam.limx)) {
    dp[0] += d_txtz / g.z;
    dp[2] += -d_txtz * g.qx / g.z;
  }
  if (in_range(g.qy, -cam.limy, cam.limy)) {
    dp[1] += d_tytz / g.z;
    dp[2] += -d_tytz * g.qy / g.z;
  }

  // p = R x + t.
  for (int r = 0; r < 3; ++r) {
    for (int k = 0; k < 3; ++k) {
      dx[k] += dp[r] * cam.R[3 * r + k];
      dR[3 * r + k] += dp[r] * g.x[k];
    }
    dt[r] += dp[r];
  }

  // Sigma = M M^T: rows m_i; then M = rot * diag(s).
  const float* m = g.m;
  float dm[9];
  const float d11 = d_cov[0], d12 = d_cov[1], d13 = d_cov[2], d22 = d_cov[3], d23 = d_cov[4], d33 = d_cov[5];
  for (int k = 0; k < 3; ++k) {
    dm[k] = 2.0f * d11 * m[k] + d12 * m[3 + k] + d13 * m[6 + k];
    dm[3 + k] = d12 * m[k] + 2.0f * d22 * m[3 + k] + d23 * m[6 + k];
    dm[6 + k] = d13 * m[k] + d23 * m[3 + k] + 2.0f * d33 * m[6 + k];
  }
  float ds_[3] = {0.0f, 0.0f, 0.0f}, dr[9];
  for (int k = 0; k < 9; ++k) {
    ds_[k % 3] += dm[k] * g.r[k];
    dr[k] = dm[k] * g.s[k % 3];
  }
  if (out.log_scale != nullptr) {
    for (int k = 0; k < 3; ++k) out.log_scale[3 * i + k] = (ds_[k] * a.scale_modifier) * g.e[k];
  }
  if (out.quat != nullptr) {
    const float w = g.qn[0], x = g.qn[1], y = g.qn[2], z = g.qn[3];
    float dq[4];
    dq[0] = 2.0f * (((-z * dr[1] + y * dr[2]) + (z * dr[3] - x * dr[5])) + (-y * dr[6] + x * dr[7]));
    dq[1] = 2.0f * ((((y * dr[1] + z * dr[2]) + (y * dr[3] - 2.0f * x * dr[4])) + (-w * dr[5] + z * dr[6])) +
                    (w * dr[7] - 2.0f * x * dr[8]));
    dq[2] = 2.0f * ((((-2.0f * y * dr[0] + x * dr[1]) + (w * dr[2] + x * dr[3])) + (z * dr[5] - w * dr[6])) +
                    (z * dr[7] - 2.0f * y * dr[8]));
    dq[3] = 2.0f * ((((-2.0f * z * dr[0] - w * dr[1]) + (x * dr[2] + w * dr[3])) + (-2.0f * z * dr[4] + y * dr[5])) +
                    (x * dr[6] + y * dr[7]));
    float dquat[4];
    normalize_vjp<4>(g.q, g.qnorm, g.qnc, dq, dquat);
    for (int k = 0; k < 4; ++k) out.quat[4 * i + k] = dquat[k];
  }
  if (out.xyz != nullptr) {
    for (int k = 0; k < 3; ++k) out.xyz[3 * i + k] = dx[k];
  }
  for (int k = 0; k < 9; ++k) cam_g[k] = dR[k];
  for (int k = 0; k < 3; ++k) cam_g[9 + k] = dt[k];
}

}  // namespace dogs_pre

#ifdef DOGS_PREPROCESS_HOST
// Host loops over every slot, for the CPU tests: the forward's rows and
// radii, and the backward's outputs with the camera term summed in slot
// order into out.camera[0:12].
namespace dogs_pre {

template <int kDeg, bool kOverride>
void host_forward(const Args& a, float* ent, float* radius) {
  const Cam cam = load_camera(a);
  constexpr int kRest = kOverride ? 0 : num_bases<kDeg>() - 1;
  float rest[3 * kRest + 1];
  for (long long i = 0; i < a.n; ++i) {
    for (int k = 0; k < 3 * kRest; ++k) rest[k] = a.feat_rest[i * 3 * a.rest_rows + k];
    forward_one<kDeg, kOverride>(a, cam, i, rest, ent + kEntWidth * i, radius + i);
  }
}

template <int kDeg, bool kOverride>
void host_backward(const Args& a, const Grads& g) {
  const Cam cam = load_camera(a);
  constexpr int kRest = kOverride ? 0 : num_bases<kDeg>() - 1;
  float rest[3 * kRest + 1], cam_g[kCamGrads], sum[kCamGrads] = {};
  for (long long i = 0; i < a.n; ++i) {
    for (int k = 0; k < 3 * kRest; ++k) rest[k] = a.feat_rest[i * 3 * a.rest_rows + k];
    backward_one<kDeg, kOverride>(a, cam, i, rest, g.d_ent + kEntWidth * i, g.radius[i], g, rest, cam_g);
    for (int k = 0; k < kCamGrads; ++k) sum[k] += cam_g[k];
    if (g.feat_rest != nullptr) {
      for (int k = 0; k < 3 * a.rest_rows; ++k) g.feat_rest[i * 3 * a.rest_rows + k] = k < 3 * kRest ? rest[k] : 0.0f;
    }
  }
  if (g.camera != nullptr) {
    for (int k = 0; k < kCamGrads; ++k) g.camera[k] = sum[k];
  }
}

}  // namespace dogs_pre

extern "C" int dogs_preprocess_forward_host(const dogs_pre::Args* a, float* ent, float* radius) {
  using namespace dogs_pre;
  if (a->color != nullptr) return host_forward<0, true>(*a, ent, radius), 0;
  switch (a->degree) {
    case 0: return host_forward<0, false>(*a, ent, radius), 0;
    case 1: return host_forward<1, false>(*a, ent, radius), 0;
    case 2: return host_forward<2, false>(*a, ent, radius), 0;
    case 3: return host_forward<3, false>(*a, ent, radius), 0;
    case 4: return host_forward<4, false>(*a, ent, radius), 0;
  }
  return 1;
}

extern "C" int dogs_preprocess_backward_host(const dogs_pre::Args* a, const dogs_pre::Grads* g) {
  using namespace dogs_pre;
  if (a->color != nullptr) return host_backward<0, true>(*a, *g), 0;
  switch (a->degree) {
    case 0: return host_backward<0, false>(*a, *g), 0;
    case 1: return host_backward<1, false>(*a, *g), 0;
    case 2: return host_backward<2, false>(*a, *g), 0;
    case 3: return host_backward<3, false>(*a, *g), 0;
    case 4: return host_backward<4, false>(*a, *g), 0;
  }
  return 1;
}
#endif  // DOGS_PREPROCESS_HOST
