// What the slicing kernels share (csrc/slice4d_fwd.cu, csrc/slice4d_bwd.cu):
// the per-Gaussian forward of 4D Gaussian Splatting's slice at time t, the
// 3DGS real SH basis with its Jacobian, and the staging of a block's feature
// rows through shared memory.
//
// The arithmetic is the plain version's (ops/slice4d.py::slice4d_plain,
// _forward_parts, sh_basis), term for term; nvcc may fuse it, so the kernels
// agree with the plain versions to rounding, not bit for bit.
#pragma once

#include <cuda_runtime.h>

namespace slice4d {

constexpr int kBlock = 64;          // Gaussians (threads) per block
constexpr int kBand = 16;           // basis functions of SH degree 3: feature rows per time band
constexpr int kMaxBands = 3;        // time degrees 0..2
constexpr int kMaxRest = (kBand * kMaxBands - 1) * 3;  // f_rest floats per Gaussian, at most
constexpr float kMarginalMin = 0.05f;
constexpr float kTwoPi = 6.283185307179586f;

constexpr float C0 = 0.28209479177387814f;
constexpr float C1 = 0.4886025119029199f;
// scalars, not arrays: a constexpr array is not visible in device code
constexpr float C2_0 = 1.0925484305920792f, C2_1 = -1.0925484305920792f,
                C2_2 = 0.31539156525252005f, C2_3 = -1.0925484305920792f,
                C2_4 = 0.5462742152960396f;
constexpr float C3_0 = -0.5900435899266435f, C3_1 = 2.890611442640554f,
                C3_2 = -0.4570457994644658f, C3_3 = 0.3731763325901154f,
                C3_4 = -0.4570457994644658f, C3_5 = 1.445305721320277f,
                C3_6 = -0.5900435899266435f;

// One Gaussian's slice at t, and what its gradient needs again.
struct Slice {
  float ul[4], ur[4], nl, nr;  // unit quaternions and the raw ones' norms
  float ml[4][4], mr[4][4], rot[4][4];
  float var[4];     // diag(exp(s))^2
  float sig[4][4];  // R D R^T
  float c[3], v, dt, marg;
  float mean[3];
};

__device__ __forceinline__ void unit(float4 q, float u[4], float& n) {
  n = sqrtf(q.x * q.x + q.y * q.y + q.z * q.z + q.w * q.w);
  u[0] = q.x / n;
  u[1] = q.y / n;
  u[2] = q.z / n;
  u[3] = q.w / n;
}

__device__ __forceinline__ void slice_at(const float* xyz, float mu_t, const float* scaling,
                                         float scaling_t, float4 ql, float4 qr, float t,
                                         Slice& s) {
  unit(ql, s.ul, s.nl);
  unit(qr, s.ur, s.nr);
  const float a = s.ul[0], b = s.ul[1], c = s.ul[2], d = s.ul[3];
  const float p = s.ur[0], q = s.ur[1], r = s.ur[2], w = s.ur[3];
  const float ml[4][4] = {{a, -b, -c, -d}, {b, a, -d, c}, {c, d, a, -b}, {d, -c, b, a}};
  const float mr[4][4] = {{p, q, r, w}, {-q, p, -w, r}, {-r, w, p, -q}, {-w, -r, q, p}};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s.ml[i][j] = ml[i][j];
      s.mr[i][j] = mr[i][j];
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) acc += ml[i][k] * mr[k][j];
      s.rot[i][j] = acc;
    }
  }
  const float sc[4] = {expf(scaling[0]), expf(scaling[1]), expf(scaling[2]), expf(scaling_t)};
#pragma unroll
  for (int k = 0; k < 4; ++k) s.var[k] = sc[k] * sc[k];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = i; j < 4; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) acc += s.rot[i][k] * s.var[k] * s.rot[j][k];
      s.sig[i][j] = acc;
      s.sig[j][i] = acc;
    }
  }
  s.v = s.sig[3][3];
  s.dt = t - mu_t;
  const float k = s.dt / s.v;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    s.c[i] = s.sig[i][3];
    s.mean[i] = xyz[i] + s.c[i] * k;
  }
  s.marg = expf(-0.5f * s.dt * s.dt / s.v);
}

// The basis B[16] at the unit direction (x, y, z), zero from nb on.
__device__ __forceinline__ void sh_basis(float x, float y, float z, int nb, float B[kBand]) {
  const float xx = x * x, yy = y * y, zz = z * z;
  const float all[kBand] = {C0, -C1 * y, C1 * z, -C1 * x,
                            C2_0 * x * y, C2_1 * y * z, C2_2 * (2.f * zz - xx - yy),
                            C2_3 * x * z, C2_4 * (xx - yy),
                            C3_0 * y * (3.f * xx - yy), C3_1 * x * y * z,
                            C3_2 * y * (4.f * zz - xx - yy),
                            C3_3 * z * (2.f * zz - 3.f * xx - 3.f * yy),
                            C3_4 * x * (4.f * zz - xx - yy), C3_5 * z * (xx - yy),
                            C3_6 * x * (xx - 3.f * yy)};
#pragma unroll
  for (int j = 0; j < kBand; ++j) B[j] = j < nb ? all[j] : 0.f;
}

// g . dB/dd for the basis' cotangent gB[16] (zero from nb on).
__device__ __forceinline__ void sh_basis_vjp(float x, float y, float z, const float gB[kBand],
                                             float gd[3]) {
  const float xx = x * x, yy = y * y, zz = z * z;
  float gx = 0.f, gy = 0.f, gz = 0.f;
  gy += -C1 * gB[1];
  gz += C1 * gB[2];
  gx += -C1 * gB[3];
  gx += C2_0 * y * gB[4];
  gy += C2_0 * x * gB[4];
  gy += C2_1 * z * gB[5];
  gz += C2_1 * y * gB[5];
  gx += -2.f * C2_2 * x * gB[6];
  gy += -2.f * C2_2 * y * gB[6];
  gz += 4.f * C2_2 * z * gB[6];
  gx += C2_3 * z * gB[7];
  gz += C2_3 * x * gB[7];
  gx += 2.f * C2_4 * x * gB[8];
  gy += -2.f * C2_4 * y * gB[8];
  gx += 6.f * C3_0 * x * y * gB[9];
  gy += C3_0 * (3.f * xx - 3.f * yy) * gB[9];
  gx += C3_1 * y * z * gB[10];
  gy += C3_1 * x * z * gB[10];
  gz += C3_1 * x * y * gB[10];
  gx += -2.f * C3_2 * x * y * gB[11];
  gy += C3_2 * (4.f * zz - xx - 3.f * yy) * gB[11];
  gz += 8.f * C3_2 * y * z * gB[11];
  gx += -6.f * C3_3 * x * z * gB[12];
  gy += -6.f * C3_3 * y * z * gB[12];
  gz += C3_3 * (6.f * zz - 3.f * xx - 3.f * yy) * gB[12];
  gx += C3_4 * (4.f * zz - 3.f * xx - yy) * gB[13];
  gy += -2.f * C3_4 * x * y * gB[13];
  gz += 8.f * C3_4 * x * z * gB[13];
  gx += 2.f * C3_5 * x * z * gB[14];
  gy += -2.f * C3_5 * y * z * gB[14];
  gz += C3_5 * (xx - yy) * gB[14];
  gx += C3_6 * (3.f * xx - 3.f * yy) * gB[15];
  gy += -6.f * C3_6 * x * y * gB[15];
  gd[0] = gx;
  gd[1] = gy;
  gd[2] = gz;
}

// The active counts: basis functions nb = (degree + 1)^2 and time bands
// up to degree_t, each clamped to what the rows hold.
__device__ __forceinline__ int active_basis(int degree) {
  const int d = degree < 0 ? 0 : (degree > 3 ? 3 : degree);
  return (d + 1) * (d + 1);
}

// cos(2 pi k (mu_t - t) / l) for k < bands, zero past degree_t.
__device__ __forceinline__ void time_weights(float mu_t, float t, float span, int degree_t,
                                             int bands, float w[kMaxBands]) {
#pragma unroll
  for (int k = 0; k < kMaxBands; ++k) {
    w[k] = (k < bands && k <= degree_t) ? cosf(kTwoPi * k * (mu_t - t) / span) : 0.f;
  }
}

// Copy the block's f_rest rows (n Gaussians from g0, nrest floats each,
// contiguous in global memory) into shared memory, coalesced.
__device__ __forceinline__ void stage_rest(const float* __restrict__ f_rest, long long g0, int n,
                                           int nrest, float* s_rest) {
  const long long base = g0 * nrest;
  for (int i = threadIdx.x; i < n * nrest; i += kBlock) s_rest[i] = f_rest[base + i];
}

}  // namespace slice4d
