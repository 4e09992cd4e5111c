// Layout probe P2 for NVIDIA Hopper (sm_90a): narrow per-pixel blocks
// against wide channel-major ones, for the per-tile outputs of kernel A and
// the per-tile inputs of kernel B.
//
// Replaces the TPU probes of tools/tpu_probes/_tpu_outspec.py, one C entry
// point per call site. One block per tile, one thread per pixel (512):
//
//   outspec_a (kernel_a, run_a)  kernel A's output layout as the TPU probe
//             asks it, stored as kernel A stores it: 1.0 into
//             accum[T, 512, 8] through composite_common.cuh's dense store
//             (restage included), 2.0 into tfinal[T, 512, 1] and the int 3
//             into bestidx[T, 512, 1], one coalesced store per thread each;
//   outspec_b (kernel_b, run_b)  1.0 into the wide out[T, 16, 512], the
//             tile's 32 KiB as 2048 float4: thread p stores float4 p,
//             p + 512, p + 1024 and p + 1536 of its tile (16-byte stores,
//             a warp's four stores each 512 contiguous bytes);
//   outspec_c (kernel_b, run_c)  1.0 into accum[T, 512, 8] alone, through
//             composite_common.cuh's dense store, restage included: kernel
//             A's accum store measured alone;
//   outspec_d (kernel_d, run_d)  kernel B's input layout: each pixel reads its
//             8 + 1 + 1 + 1 floats of gacc[T, 512, 8] and a1, a2, a3
//             [T, 512, 1], as csrc/composite_bwd.cu reads gacc, acdot, gend and
//             tfinal; the tile's sum is written over the wide out[T, 16, 512];
//   outspec_e (kernel_e, run_e)  the same over the wide gin[T, 16, 512].
//
// The tile sums of d and e are a warp xor-shuffle tree, then thread 0 adds
// the 16 warps' sums in warp order: no atomics, so two launches are
// bit-equal.
//
// What bounds them on the H100: bytes (40, 64, 32, 108 and 128 per pixel),
// with next to no arithmetic; the question is how near each layout comes to
// the memory rate. b's first design, 16 4-byte stores per thread, read
// slower than the fill_ that writes the same bytes in some runs. Its
// redesign stores 16 bytes at a time, as fill_'s vectorised kernel does.
// On the H100 it ties fill_, and reads 1-4% slower than the first design
// in most runs of the two in turns (PERF.md, P2b): float4 blocks of 128 to
// 1024 threads, a persistent grid striding over the output and streaming
// (st.global.cs) stores were tried as well, and every layout of this pure
// write stops near the same rate, short of the data sheet's.
#include <cuda_runtime.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

constexpr int kPix = 512;    // pixels of a 32x16 tile, one thread each
constexpr int kWide = 16;    // channels of the wide layout
constexpr int kWarps = kPix / 32;
constexpr int kTileFloat4 = kWide * kPix / 4;  // one wide tile: 2048 float4

__device__ __forceinline__ long long pixel_index() {
  return static_cast<long long>(blockIdx.x) * kPix + threadIdx.x;
}

// Sum of v over the block's pixels, in a fixed order; every thread gets it.
__device__ float tile_sum(float v) {
  __shared__ float s_warp[kWarps];
  __shared__ float s_total;
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += s_warp[w];
    s_total = t;
  }
  __syncthreads();
  return s_total;
}

// out[t, r, p] = v for r < 16: each row a coalesced 2 KiB store.
__device__ __forceinline__ void store_wide(float* __restrict__ out, float v) {
  float* o = out + static_cast<long long>(blockIdx.x) * kWide * kPix + threadIdx.x;
#pragma unroll
  for (int r = 0; r < kWide; ++r) o[r * kPix] = v;
}

__global__ void __launch_bounds__(kPix)
outspec_a_kernel(float* __restrict__ accum, float* __restrict__ tfinal,
                 int32_t* __restrict__ bestidx) {
  __shared__ float4 stage[2 * kPix];
  const float acc[8] = {1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f};
  const long long o = pixel_index();
  ex4dgs::store_accum_dense(stage, acc, accum + static_cast<long long>(blockIdx.x) * kPix * 8);
  tfinal[o] = 2.f;
  bestidx[o] = 3;
}

__global__ void __launch_bounds__(kPix) outspec_b_kernel(float4* __restrict__ out) {
  const float4 v = make_float4(1.f, 1.f, 1.f, 1.f);
  float4* o = out + static_cast<long long>(blockIdx.x) * kTileFloat4 + threadIdx.x;
#pragma unroll
  for (int u = 0; u < kTileFloat4 / kPix; ++u) o[u * kPix] = v;
}

__global__ void __launch_bounds__(kPix) outspec_c_kernel(float* __restrict__ accum) {
  __shared__ float4 stage[2 * kPix];
  const float acc[8] = {1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f};
  ex4dgs::store_accum_dense(stage, acc, accum + static_cast<long long>(blockIdx.x) * kPix * 8);
}

__global__ void __launch_bounds__(kPix)
outspec_d_kernel(const float* __restrict__ gacc, const float* __restrict__ a1,
                 const float* __restrict__ a2, const float* __restrict__ a3,
                 float* __restrict__ out) {
  const long long o = pixel_index();
  const float4* g4 = reinterpret_cast<const float4*>(gacc + o * 8);
  const float4 g0 = g4[0];
  const float4 g1 = g4[1];
  float v = g0.x + g0.y + g0.z + g0.w + g1.x + g1.y + g1.z + g1.w;
  v += a1[o] + a2[o] + a3[o];
  store_wide(out, tile_sum(v));
}

__global__ void __launch_bounds__(kPix)
outspec_e_kernel(const float* __restrict__ gin, float* __restrict__ out) {
  const float* g = gin + static_cast<long long>(blockIdx.x) * kWide * kPix + threadIdx.x;
  float v = 0.f;
#pragma unroll
  for (int r = 0; r < kWide; ++r) v += g[r * kPix];
  store_wide(out, tile_sum(v));
}

cudaStream_t as_stream(void* stream) { return static_cast<cudaStream_t>(stream); }

}  // namespace

extern "C" int outspec_a(void* accum, void* tfinal, void* bestidx, int num_tiles,
                         void* stream) {
  outspec_a_kernel<<<num_tiles, kPix, 0, as_stream(stream)>>>(
      static_cast<float*>(accum), static_cast<float*>(tfinal), static_cast<int32_t*>(bestidx));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int outspec_b(void* out, int num_tiles, void* stream) {
  outspec_b_kernel<<<num_tiles, kPix, 0, as_stream(stream)>>>(static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int outspec_c(void* accum, int num_tiles, void* stream) {
  outspec_c_kernel<<<num_tiles, kPix, 0, as_stream(stream)>>>(static_cast<float*>(accum));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int outspec_d(const void* gacc, const void* a1, const void* a2, const void* a3,
                         void* out, int num_tiles, void* stream) {
  outspec_d_kernel<<<num_tiles, kPix, 0, as_stream(stream)>>>(
      static_cast<const float*>(gacc), static_cast<const float*>(a1),
      static_cast<const float*>(a2), static_cast<const float*>(a3), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int outspec_e(const void* gin, void* out, int num_tiles, void* stream) {
  outspec_e_kernel<<<num_tiles, kPix, 0, as_stream(stream)>>>(static_cast<const float*>(gin),
                                                             static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* probe_outspec_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
