// Forward slicing of 4D Gaussians at a time t and their colour by 4D
// spherindrical harmonics (4D Gaussian Splatting, Yang et al., ICLR 2024),
// for NVIDIA Hopper (sm_90a). The plain version is
// ops/slice4d.py::slice4d_plain; the equations are in that module's
// docstring.
//
// One thread per Gaussian, in blocks of slice4d::kBlock. Per Gaussian it
// reads the raw parameters (161 floats at SH degree 3 and time degree 2)
// and the mask, and writes mean[3], cov3d[6], alpha, rgb[3] and live.
//
// What bounds it on the H100: bytes. 144 of the 161 floats are the feature
// rows, 576 bytes per Gaussian; thread g reading its own rows would make a
// warp touch 32 rows 564 bytes apart at each load. So the block first
// copies its Gaussians' f_rest, one contiguous run of kBlock x 141 floats,
// into shared memory with consecutive threads on consecutive words, and
// each thread then reads its rows there (a stride of 141 words, odd, so
// the 32 lanes hit 32 banks). The rest (the 4x4 rotation, the covariance,
// the basis) is some 600 floating-point operations a Gaussian, far under
// the bytes' time at the float32 peak.
#include <cuda_runtime.h>

#include <cstdint>

#include "slice4d_common.cuh"

using namespace slice4d;

__global__ void __launch_bounds__(kBlock) slice4d_fwd_kernel(
    const float* __restrict__ xyz, const float* __restrict__ mu_t,
    const float* __restrict__ scaling, const float* __restrict__ scaling_t,
    const float4* __restrict__ rotation, const float4* __restrict__ rotation_r,
    const float* __restrict__ opacity, const float* __restrict__ f_dc,
    const float* __restrict__ f_rest, const bool* __restrict__ mask,
    const float* __restrict__ tq, const float* __restrict__ campos,
    const int* __restrict__ degree_p, const int* __restrict__ degree_t_p, long long P, int bands,
    float span, float* __restrict__ mean_out, float* __restrict__ cov_out,
    float* __restrict__ alpha_out, float* __restrict__ rgb_out, bool* __restrict__ live_out) {
  __shared__ float s_rest[kBlock * kMaxRest];
  const int nrest = (kBand * bands - 1) * 3;
  const long long g0 = static_cast<long long>(blockIdx.x) * kBlock;
  const int n = static_cast<int>(P - g0 < kBlock ? P - g0 : kBlock);
  stage_rest(f_rest, g0, n, nrest, s_rest);
  __syncthreads();
  if (threadIdx.x >= n) return;
  const long long g = g0 + threadIdx.x;
  const float t = *tq;

  Slice s;
  slice_at(xyz + 3 * g, mu_t[g], scaling + 3 * g, scaling_t[g], rotation[g], rotation_r[g], t,
           s);
  const float inv_v = 1.f / s.v;
  const int pack[6][2] = {{0, 0}, {0, 1}, {0, 2}, {1, 1}, {1, 2}, {2, 2}};
#pragma unroll
  for (int e = 0; e < 6; ++e) {
    const int i = pack[e][0], j = pack[e][1];
    cov_out[6 * g + e] = s.sig[i][j] - s.c[i] * s.c[j] * inv_v;
  }
  const float sg = 1.f / (1.f + expf(-opacity[g]));
  alpha_out[g] = sg * s.marg;
  live_out[g] = mask[g] && s.marg > kMarginalMin;
#pragma unroll
  for (int i = 0; i < 3; ++i) mean_out[3 * g + i] = s.mean[i];

  // colour
  float dx = s.mean[0] - campos[0], dy = s.mean[1] - campos[1], dz = s.mean[2] - campos[2];
  const float dn = sqrtf(dx * dx + dy * dy + dz * dz);
  dx /= dn;
  dy /= dn;
  dz /= dn;
  float B[kBand];
  sh_basis(dx, dy, dz, active_basis(*degree_p), B);
  float w[kMaxBands];
  time_weights(mu_t[g], t, span, *degree_t_p, bands, w);
  const float* rest = s_rest + threadIdx.x * nrest;
  float rgb[3] = {0.f, 0.f, 0.f};
  for (int k = 0; k < bands; ++k) {
    if (w[k] == 0.f) continue;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kBand; ++j) {
        const int row = kBand * k + j;
        const float f = row == 0 ? f_dc[3 * g + ch] : rest[3 * (row - 1) + ch];
        acc += B[j] * f;
      }
      rgb[ch] += w[k] * acc;
    }
  }
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) rgb_out[3 * g + ch] = fmaxf(rgb[ch] + 0.5f, 0.f);
}

extern "C" int slice4d_fwd(const void* xyz, const void* mu_t, const void* scaling,
                           const void* scaling_t, const void* rotation, const void* rotation_r,
                           const void* opacity, const void* f_dc, const void* f_rest,
                           const void* mask, const void* tq, const void* campos,
                           const void* degree, const void* degree_t, long long P, int bands,
                           float span, void* mean, void* cov, void* alpha,
                           void* rgb, void* live, void* stream) {
  const unsigned blocks = static_cast<unsigned>((P + kBlock - 1) / kBlock);
  slice4d_fwd_kernel<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const float*>(mu_t),
      static_cast<const float*>(scaling), static_cast<const float*>(scaling_t),
      static_cast<const float4*>(rotation), static_cast<const float4*>(rotation_r),
      static_cast<const float*>(opacity), static_cast<const float*>(f_dc),
      static_cast<const float*>(f_rest), static_cast<const bool*>(mask),
      static_cast<const float*>(tq), static_cast<const float*>(campos),
      static_cast<const int*>(degree), static_cast<const int*>(degree_t), P, bands, span,
      static_cast<float*>(mean), static_cast<float*>(cov), static_cast<float*>(alpha),
      static_cast<float*>(rgb), static_cast<bool*>(live));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* slice4d_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
