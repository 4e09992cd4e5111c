// Backward of the slicing and the 4D harmonics (csrc/slice4d_fwd.cu) for
// NVIDIA Hopper (sm_90a). The plain version is
// ops/slice4d.py::slice4d_bwd_plain, whose terms this kernel computes in
// the same order of derivation:
//
//   colour   g_pre = g_rgb where the clamp's input >= 0; g_f[k, j] = w_k B_j g_pre;
//            the basis' cotangent F_j . g_pre (F_j = sum_k w_k f[k, j]) through
//            dB/dd and the normalisation of d into the mean's gradient
//   alpha    g_o = g_alpha m s (1 - s); g_m = g_alpha s m carries to dt and v
//   mean     g_c = g_mean dt / v, g_mu_t -= (g_mean . c) / v, g_v -= (g_mean . c) dt / v^2
//   cov3d    Gs the symmetric gradient of Sigma_xyz; g_c -= 2 Gs c / v,
//            g_v += c^T Gs c / v^2
//   Sigma    G (4x4, symmetric) from Gs, g_c and g_v; g_R = 2 G R D,
//            g_D_k = (R^T G R)_kk, g_s_k = 2 D_k g_D_k
//   R        g_Ml = g_R Mr^T, g_Mr = Ml^T g_R, each to its quaternion's
//            components by the matrices' sign patterns, then through the
//            normalisation q / |q|
//
// The time argument of the harmonics (mu_t - t) is detached, as in the
// source: no colour gradient reaches t.
//
// One thread per Gaussian in blocks of slice4d::kBlock, as the forward.
// The feature rows are staged through shared memory both ways: the block
// reads its Gaussians' f_rest in one coalesced run, each thread forms F_j
// from its own rows and then overwrites them with its gradient rows, and
// the block writes the run back out coalesced. Every output is one plain
// store, so two launches give the same bits.
#include <cuda_runtime.h>

#include <cstdint>

#include "slice4d_common.cuh"

using namespace slice4d;

__global__ void __launch_bounds__(kBlock) slice4d_bwd_kernel(
    const float* __restrict__ xyz, const float* __restrict__ mu_t,
    const float* __restrict__ scaling, const float* __restrict__ scaling_t,
    const float4* __restrict__ rotation, const float4* __restrict__ rotation_r,
    const float* __restrict__ opacity, const float* __restrict__ f_dc,
    const float* __restrict__ f_rest, const float* __restrict__ tq,
    const float* __restrict__ campos, const int* __restrict__ degree_p,
    const int* __restrict__ degree_t_p, const float* __restrict__ g_mean,
    const float* __restrict__ g_cov, const float* __restrict__ g_alpha,
    const float* __restrict__ g_rgb, long long P, int bands, float span,
    float* __restrict__ d_xyz, float* __restrict__ d_mu_t, float* __restrict__ d_scaling,
    float* __restrict__ d_scaling_t, float4* __restrict__ d_rotation,
    float4* __restrict__ d_rotation_r, float* __restrict__ d_opacity,
    float* __restrict__ d_f_dc, float* __restrict__ d_f_rest) {
  __shared__ float s_rest[kBlock * kMaxRest];
  const int nrest = (kBand * bands - 1) * 3;
  const long long g0 = static_cast<long long>(blockIdx.x) * kBlock;
  const int n = static_cast<int>(P - g0 < kBlock ? P - g0 : kBlock);
  stage_rest(f_rest, g0, n, nrest, s_rest);
  __syncthreads();
  if (threadIdx.x < n) {
    const long long g = g0 + threadIdx.x;
    const float t = *tq;
    Slice s;
    slice_at(xyz + 3 * g, mu_t[g], scaling + 3 * g, scaling_t[g], rotation[g], rotation_r[g],
             t, s);
    const float v = s.v, dt = s.dt, marg = s.marg;

    // colour
    const float dirv[3] = {s.mean[0] - campos[0], s.mean[1] - campos[1], s.mean[2] - campos[2]};
    const float dn = sqrtf(dirv[0] * dirv[0] + dirv[1] * dirv[1] + dirv[2] * dirv[2]);
    const float d[3] = {dirv[0] / dn, dirv[1] / dn, dirv[2] / dn};
    const int nb = active_basis(*degree_p);
    float B[kBand];
    sh_basis(d[0], d[1], d[2], nb, B);
    float w[kMaxBands];
    time_weights(mu_t[g], t, span, *degree_t_p, bands, w);
    float* rest = s_rest + threadIdx.x * nrest;
    float gB[kBand];
    float gpre[3];
    {
      float eff[kBand][3];
#pragma unroll
      for (int j = 0; j < kBand; ++j) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          float acc = 0.f;
          for (int k = 0; k < bands; ++k) {
            const int row = kBand * k + j;
            const float f = row == 0 ? f_dc[3 * g + ch] : rest[3 * (row - 1) + ch];
            acc += w[k] * f;
          }
          eff[j][ch] = acc;
        }
      }
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        float pre = 0.f;
#pragma unroll
        for (int j = 0; j < kBand; ++j) pre += B[j] * eff[j][ch];
        pre += 0.5f;
        gpre[ch] = pre >= 0.f ? g_rgb[3 * g + ch] : 0.f;
      }
      // the basis functions past the active degree are constant 0
#pragma unroll
      for (int j = 0; j < kBand; ++j) {
        gB[j] = j < nb ? eff[j][0] * gpre[0] + eff[j][1] * gpre[1] + eff[j][2] * gpre[2] : 0.f;
      }
    }
    // the feature rows' gradients, written over the staged rows
    for (int k = 0; k < bands; ++k) {
#pragma unroll
      for (int j = 0; j < kBand; ++j) {
        const int row = kBand * k + j;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const float gf = w[k] * B[j] * gpre[ch];
          if (row == 0) {
            d_f_dc[3 * g + ch] = gf;
          } else {
            rest[3 * (row - 1) + ch] = gf;
          }
        }
      }
    }
    float gd[3];
    sh_basis_vjp(d[0], d[1], d[2], gB, gd);
    const float dot_d = d[0] * gd[0] + d[1] * gd[1] + d[2] * gd[2];
    float gm[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) gm[i] = g_mean[3 * g + i] + (gd[i] - d[i] * dot_d) / dn;

    // alpha = sigmoid(o) m
    const float sg = 1.f / (1.f + expf(-opacity[g]));
    const float ga = g_alpha[g];
    d_opacity[g] = ga * marg * sg * (1.f - sg);
    const float gmarg = ga * sg * marg;

    // mean = xyz + c dt / v
    const float h = gm[0] * s.c[0] + gm[1] * s.c[1] + gm[2] * s.c[2];
    float gc[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      d_xyz[3 * g + i] = gm[i];
      gc[i] = gm[i] * (dt / v);
    }
    d_mu_t[g] = -h / v + gmarg * dt / v;
    float gv = -h * dt / (v * v) + gmarg * 0.5f * dt * dt / (v * v);

    // cov3d = Sigma_xyz - c c^T / v
    float gs[3][3];
    {
      const float* gcv = g_cov + 6 * g;
      gs[0][0] = gcv[0];
      gs[0][1] = gs[1][0] = 0.5f * gcv[1];
      gs[0][2] = gs[2][0] = 0.5f * gcv[2];
      gs[1][1] = gcv[3];
      gs[1][2] = gs[2][1] = 0.5f * gcv[4];
      gs[2][2] = gcv[5];
    }
    float gsc[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) gsc[i] = gs[i][0] * s.c[0] + gs[i][1] * s.c[1] + gs[i][2] * s.c[2];
#pragma unroll
    for (int i = 0; i < 3; ++i) gc[i] = gc[i] - 2.f * gsc[i] / v;
    gv = gv + (s.c[0] * gsc[0] + s.c[1] * gsc[1] + s.c[2] * gsc[2]) / (v * v);

    // Sigma = R D R^T
    float G[4][4];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) G[i][j] = gs[i][j];
      G[i][3] = G[3][i] = 0.5f * gc[i];
    }
    G[3][3] = gv;
    float gR[4][4], GR[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) acc += G[i][k] * s.rot[k][j];
        GR[i][j] = acc;
        gR[i][j] = 2.f * acc * s.var[j];
      }
    }
    float gsc4[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float gvar = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) gvar += s.rot[i][k] * GR[i][k];
      gsc4[k] = 2.f * gvar * s.var[k];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) d_scaling[3 * g + i] = gsc4[i];
    d_scaling_t[g] = gsc4[3];

    // R = M_l M_r
    float gml[4][4], gmr[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float a = 0.f, b = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          a += gR[i][k] * s.mr[j][k];
          b += s.ml[k][i] * gR[k][j];
        }
        gml[i][j] = a;
        gmr[i][j] = b;
      }
    }
    const float gul[4] = {gml[0][0] + gml[1][1] + gml[2][2] + gml[3][3],
                          -gml[0][1] + gml[1][0] - gml[2][3] + gml[3][2],
                          -gml[0][2] + gml[1][3] + gml[2][0] - gml[3][1],
                          -gml[0][3] - gml[1][2] + gml[2][1] + gml[3][0]};
    const float gur[4] = {gmr[0][0] + gmr[1][1] + gmr[2][2] + gmr[3][3],
                          gmr[0][1] - gmr[1][0] - gmr[2][3] + gmr[3][2],
                          gmr[0][2] + gmr[1][3] - gmr[2][0] - gmr[3][1],
                          gmr[0][3] - gmr[1][2] + gmr[2][1] - gmr[3][0]};
    const float pl = s.ul[0] * gul[0] + s.ul[1] * gul[1] + s.ul[2] * gul[2] + s.ul[3] * gul[3];
    const float pr = s.ur[0] * gur[0] + s.ur[1] * gur[1] + s.ur[2] * gur[2] + s.ur[3] * gur[3];
    d_rotation[g] = make_float4((gul[0] - s.ul[0] * pl) / s.nl, (gul[1] - s.ul[1] * pl) / s.nl,
                                (gul[2] - s.ul[2] * pl) / s.nl, (gul[3] - s.ul[3] * pl) / s.nl);
    d_rotation_r[g] = make_float4((gur[0] - s.ur[0] * pr) / s.nr, (gur[1] - s.ur[1] * pr) / s.nr,
                                  (gur[2] - s.ur[2] * pr) / s.nr,
                                  (gur[3] - s.ur[3] * pr) / s.nr);
  }
  __syncthreads();
  const long long base = g0 * nrest;
  for (int i = threadIdx.x; i < n * nrest; i += kBlock) d_f_rest[base + i] = s_rest[i];
}

extern "C" int slice4d_bwd(const void* xyz, const void* mu_t, const void* scaling,
                           const void* scaling_t, const void* rotation, const void* rotation_r,
                           const void* opacity, const void* f_dc, const void* f_rest,
                           const void* tq, const void* campos, const void* degree,
                           const void* degree_t, const void* g_mean, const void* g_cov,
                           const void* g_alpha, const void* g_rgb, long long P, int bands,
                           float span, void* d_xyz, void* d_mu_t,
                           void* d_scaling, void* d_scaling_t, void* d_rotation,
                           void* d_rotation_r, void* d_opacity, void* d_f_dc, void* d_f_rest,
                           void* stream) {
  const unsigned blocks = static_cast<unsigned>((P + kBlock - 1) / kBlock);
  slice4d_bwd_kernel<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const float*>(mu_t),
      static_cast<const float*>(scaling), static_cast<const float*>(scaling_t),
      static_cast<const float4*>(rotation), static_cast<const float4*>(rotation_r),
      static_cast<const float*>(opacity), static_cast<const float*>(f_dc),
      static_cast<const float*>(f_rest), static_cast<const float*>(tq),
      static_cast<const float*>(campos), static_cast<const int*>(degree),
      static_cast<const int*>(degree_t), static_cast<const float*>(g_mean),
      static_cast<const float*>(g_cov), static_cast<const float*>(g_alpha),
      static_cast<const float*>(g_rgb), P, bands, span, static_cast<float*>(d_xyz),
      static_cast<float*>(d_mu_t), static_cast<float*>(d_scaling),
      static_cast<float*>(d_scaling_t), static_cast<float4*>(d_rotation),
      static_cast<float4*>(d_rotation_r), static_cast<float*>(d_opacity),
      static_cast<float*>(d_f_dc), static_cast<float*>(d_f_rest));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* slice4d_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
