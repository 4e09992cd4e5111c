// Backward of 4D-GS's HexPlane field (Wu et al., CVPR 2024) for NVIDIA
// Hopper (sm_90a). The plain version is ops/hexplane.py::hexplane_bwd_plain;
// it replaces no TPU kernel (the JAX package has no deformation field).
//
// One thread per (point, channel), 16 points a block, as the forward. For
// each scale the thread samples the six planes again, then for each plane
// k takes g_k = dL/df times the product of the other five samples (the
// product rule, in the plain version's order), adds g_k times each corner's
// weight into that corner of the plane's gradient with an atomic add, and
// g_k times the sample's derivative along each of its two coordinates
// (times (R - 1) / 2, 0 where the coordinate was clamped) into the thread's
// share of the coordinate gradient. The 16 threads of a point then sum
// their shares with shuffles, and the first writes the point's 4 values.
//
// The atomics add in the order the threads arrive, which changes from
// launch to launch. So that the sum does not depend on it, the planes'
// gradients are summed in 64-bit fixed point: each term, rounded once to a
// multiple of 2^-(62 - e), is added as an integer, and integer addition
// does not round. e is the exponent of P times `bound`, a bound of every
// term's size (max |g| times the largest plane value to the fifth, the
// wrapper's), so no cell's sum of at most P terms overflows; a second
// kernel turns the sums into float32. Two launches give the same bits; the
// plain version's float32 index_add_ differs from them by its own rounding
// and by terms under 2^-(63 - e), which the fixed point drops. A bound that
// is not finite makes every plane gradient NaN. The coordinate gradients
// are a fixed sum and repeat bit for bit too.
//
// What bounds it on the H100: the atomics. A point adds 4 corners x 16
// channels x 12 planes = 768 values into 9.46 MB of gradients; in a view
// every point has the same t, so the time planes' adds fall on two rows of
// each, and the spatial ones on the cells the cloud covers: many threads
// add into one address, and L2 serialises them.
#include <cuda_runtime.h>

#include "hexplane_common.cuh"

using namespace hexplane;

struct Grads {
  unsigned long long* acc;          // the planes' fixed-point sums, one run a plane
  long long off[kMaxPlanes];        // plane n's run starts at acc + off[n]
};

// 2^(62 - e) with P bound < 2^e: the fixed point's scale.
__device__ __forceinline__ double fixed_scale(float bound, long long P) {
  int e;
  frexp(static_cast<double>(bound) * static_cast<double>(P), &e);
  return ldexp(1.0, 62 - e);
}

__device__ __forceinline__ void add_fixed(unsigned long long* cell, float term, double scale) {
  atomicAdd(cell, static_cast<unsigned long long>(llrint(static_cast<double>(term) * scale)));
}

__global__ void __launch_bounds__(kBlock) hexplane_bwd_kernel(
    const float4* __restrict__ coords, Planes planes, const float* __restrict__ g_f,
    long long P, float4* __restrict__ g_coords, Grads grads, const float* __restrict__ bound) {
  const double scale = fixed_scale(*bound, P);
  const long long p = static_cast<long long>(blockIdx.x) * kPoints + threadIdx.x / kChannels;
  const int channel = threadIdx.x % kChannels;
  const bool live = p < P;
  float gc[4] = {0.f, 0.f, 0.f, 0.f};
  if (live) {
    const float4 c4 = coords[p];
    const float c[4] = {c4.x, c4.y, c4.z, c4.w};
    const int scales = planes.n / kPairs;
    for (int s = 0; s < scales; ++s) {
      const float g = g_f[(p * scales + s) * kChannels + channel];
      Axis xa[kPairs], xb[kPairs];
      Sample sm[kPairs];
#pragma unroll
      for (int k = 0; k < kPairs; ++k) {
        const int n = s * kPairs + k;
        int a, b;
        pair(k, a, b);
        xa[k] = axis(c[a], planes.ra[n]);
        xb[k] = axis(c[b], planes.rb[n]);
        sm[k] = sample(planes.p[n], planes.ra[n], planes.rb[n], channel, xa[k], xb[k]);
      }
#pragma unroll
      for (int k = 0; k < kPairs; ++k) {
        const int n = s * kPairs + k;
        float others = 1.f;
#pragma unroll
        for (int j = 0; j < kPairs; ++j)
          if (j != k) others = __fmul_rn(others, sm[j].s);
        const float gs = __fmul_rn(g, others);
        const float wa = xa[k].w, wb = xb[k].w;
        const float ma = __fsub_rn(1.f, wa), mb = __fsub_rn(1.f, wb);
        const int ra = planes.ra[n];
        unsigned long long* gp = grads.acc + grads.off[n] +
                                 static_cast<long long>(channel) * ra * planes.rb[n] + sm[k].o00;
        add_fixed(gp, __fmul_rn(gs, __fmul_rn(ma, mb)), scale);
        add_fixed(gp + 1, __fmul_rn(gs, __fmul_rn(wa, mb)), scale);
        add_fixed(gp + ra, __fmul_rn(gs, __fmul_rn(ma, wb)), scale);
        add_fixed(gp + ra + 1, __fmul_rn(gs, __fmul_rn(wa, wb)), scale);
        const Sample& v = sm[k];
        const float du_a = __fadd_rn(__fmul_rn(mb, __fsub_rn(v.v01, v.v00)),
                                     __fmul_rn(wb, __fsub_rn(v.v11, v.v10)));
        const float du_b = __fadd_rn(__fmul_rn(ma, __fsub_rn(v.v10, v.v00)),
                                     __fmul_rn(wa, __fsub_rn(v.v11, v.v01)));
        int a, b;
        pair(k, a, b);
        gc[a] = __fadd_rn(gc[a], __fmul_rn(__fmul_rn(gs, du_a), xa[k].dudc));
        gc[b] = __fadd_rn(gc[b], __fmul_rn(__fmul_rn(gs, du_b), xb[k].dudc));
      }
    }
  }
  // the point's 16 channels: a fixed butterfly within each half-warp
#pragma unroll
  for (int off = kChannels / 2; off > 0; off /= 2) {
#pragma unroll
    for (int i = 0; i < 4; ++i) gc[i] += __shfl_xor_sync(0xffffffffu, gc[i], off, kChannels);
  }
  if (live && channel == 0) g_coords[p] = make_float4(gc[0], gc[1], gc[2], gc[3]);
}

// The planes' gradients from their fixed-point sums.
__global__ void hexplane_bwd_kernel_finish(const unsigned long long* __restrict__ acc,
                                           long long n, const float* __restrict__ bound,
                                           long long P, float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float b = *bound;
  out[i] = isfinite(b) ? static_cast<float>(static_cast<double>(static_cast<long long>(acc[i])) /
                                            fixed_scale(b, P))
                       : __int_as_float(0x7fc00000);
}

extern "C" int hexplane_bwd(const void* coords, const void* plane_ptrs, const void* ra,
                            const void* rb, int n_planes, const void* g_f, long long P,
                            void* g_coords, void* acc, const void* bound, void* g_planes,
                            void* stream) {
  Planes planes;
  Grads grads;
  planes.n = n_planes;
  grads.acc = static_cast<unsigned long long*>(acc);
  long long total = 0;
  for (int i = 0; i < n_planes; ++i) {
    planes.p[i] = static_cast<const float* const*>(plane_ptrs)[i];
    planes.ra[i] = static_cast<const int*>(ra)[i];
    planes.rb[i] = static_cast<const int*>(rb)[i];
    grads.off[i] = total;
    total += static_cast<long long>(kChannels) * planes.ra[i] * planes.rb[i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((P + kPoints - 1) / kPoints);
  hexplane_bwd_kernel<<<blocks, kBlock, 0, s>>>(
      static_cast<const float4*>(coords), planes, static_cast<const float*>(g_f), P,
      static_cast<float4*>(g_coords), grads, static_cast<const float*>(bound));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  hexplane_bwd_kernel_finish<<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(
      grads.acc, total, static_cast<const float*>(bound), P, static_cast<float*>(g_planes));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hexplane_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
