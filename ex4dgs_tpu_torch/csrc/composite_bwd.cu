// Backward tile compositing for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel ex4dgs_tpu/ops/rasterize_pallas.py::_backward_kernel.
// For each tile it walks the depth-sorted instance range [starts[t], stops[t])
// of the packed buffer data[16, capacity] front to back exactly as the forward
// kernel (csrc/composite_fwd.cu) does, and writes each instance's gradient row
// dgrad[:, i], summed over the tile's pixels:
//
//   rows 0-1   dxy       rows 2-4  dconic (a, b, c)     row 5  dopacity
//   rows 6-13  dfeat = sum_p w_p gacc_p                 rows 14-15 untouched (0)
//
// For a pixel and an instance i it applies (before the pixel's latch):
//
//   dL/dalpha = T_i (c_i . gc) - (S_i + tfinal gend) / max(1 - alpha, 0.01)
//   S_i       = acdot - sum_{j <= i} w_j (c_j . gc)
//   dL/dpower = opacity e^power dL/dalpha   (the 0.99 clamp is straight-through)
//   dL/dopac  = e^power dL/dalpha
//
// with gc = gacc[0:3], c_i the instance's rgb (data rows 6-8), T_i the
// transmittance before it and w_i = alpha_i T_i; the geometry rows follow
// from power = -0.5 (a dx^2 + c dy^2) - b dx dy with dx, dy = mean - pixel.
// Instances the tile never reaches (every pixel latched) and columns outside
// every range keep the zeros the wrapper fills in.
//
// Design: one thread block per tile, one thread per pixel, as the forward.
// The block stages kBatch instances' rows in shared memory (one coalesced
// load per row), every pixel computes its 14 contributions per instance, a
// warp sums them with xor shuffles (skipped when no lane of the warp applied
// the instance: its sums are then exactly zero), lane 0 parks the warp's sums
// in shared memory, and after the batch one thread per (row, instance) adds
// the warps' sums in warp order and stores the result. Every instance belongs
// to exactly one tile, so each output is one plain store: no atomics, and the
// result is the same bit for bit on every run.
//
// Bit-level agreement with the forward: alpha, the alpha floor and the latch
// are recomputed with the same explicitly rounded operations and the same
// accurate expf as the forward kernel, so an instance is applied here exactly
// where it was applied there; the running colour prefix uses the forward's
// fused multiply-adds in the forward's order, so at the last applied instance
// it equals the forward's accum and S_i there is acdot minus the same dot
// (no cancellation beyond the dot's own rounding). Do not build with
// --use_fast_math.
//
// What bounds it on the H100: instance x pixel pairs. An evaluated pair costs
// the forward's 15 fp32 instructions and one exp; an applied pair about 43
// more for the gradient terms, and its 14 contributions must each be added
// once into its instance's sums. The bytes moved (14 rows read and 16 written
// per instance, 44 bytes of cotangents per pixel) are far below the memory
// roofline. What this simple design leaves on the table: the shuffle tree
// spends 5 shuffles and 5 adds per value and lane where one add per
// contribution is the minimum; latched pixels idle until the tile exits; the
// staging is not overlapped with the walk.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBatch = 32;  // instances staged and reduced per batch
constexpr int kRows = 14;   // data rows read: xy, conic, opacity, 8 features
constexpr int kOut = 14;    // gradient rows written: dxy, dconic, dopac, dfeat
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;

__global__ void __launch_bounds__(1024)
composite_bwd_kernel(const float* __restrict__ data, const int32_t* __restrict__ starts,
                     const int32_t* __restrict__ stops, const float* __restrict__ gacc,
                     const float* __restrict__ acdot, const float* __restrict__ gend,
                     const float* __restrict__ tfinal, float* __restrict__ dgrad,
                     long long capacity, int grid_x, int tile_x, int tile_y) {
  extern __shared__ float smem[];
  float* s_rows = smem;                 // [kRows][kBatch]
  float* s_part = smem + kRows * kBatch;  // [warps][kBatch][kOut]

  const int tile = blockIdx.x;
  const int npix = blockDim.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int nwarps = npix >> 5;
  const float px = static_cast<float>((tile % grid_x) * tile_x + p % tile_x);
  const float py = static_cast<float>((tile / grid_x) * tile_y + p / tile_x);
  const int start = starts[tile];
  const int stop = stops[tile];

  const long long o = static_cast<long long>(tile) * npix + p;
  const float4* g4 = reinterpret_cast<const float4*>(gacc + o * 8);
  const float4 ga = g4[0];
  const float4 gb = g4[1];
  const float g[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
  const float acd = acdot[o];
  const float tf_term = tfinal[o] * gend[o];

  float T = 1.f;
  float pr = 0.f, pg = 0.f, pb = 0.f;  // the forward's colour accumulators
  bool done = false;

  for (int base = start; base < stop; base += kBatch) {
    const int n = min(kBatch, stop - base);
    __syncthreads();  // the previous batch's rows and sums are consumed
    for (int k = p; k < kRows * kBatch; k += npix) {
      const int r = k / kBatch;
      const int c = k - r * kBatch;
      if (c < n) s_rows[r * kBatch + c] = data[r * capacity + base + c];
    }
    __syncthreads();

    for (int i = 0; i < n; ++i) {
      float v[kOut];
#pragma unroll
      for (int k = 0; k < kOut; ++k) v[k] = 0.f;
      bool applied = false;
      if (!done) {
        const float dx = __fsub_rn(s_rows[0 * kBatch + i], px);
        const float dy = __fsub_rn(s_rows[1 * kBatch + i], py);
        const float ca = s_rows[2 * kBatch + i];
        const float cb = s_rows[3 * kBatch + i];
        const float cc = s_rows[4 * kBatch + i];
        const float op = s_rows[5 * kBatch + i];
        const float q = __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx),
                                  __fmul_rn(__fmul_rn(cc, dy), dy));
        const float power = __fsub_rn(__fmul_rn(-0.5f, q), __fmul_rn(__fmul_rn(cb, dx), dy));
        if (power <= 0.f) {
          const float e = expf(power);
          const float raw = __fmul_rn(op, e);
          const float alpha = raw > kAlphaMax ? kAlphaMax : raw;
          if (alpha >= kAlphaMin) {
            const float one_m = __fsub_rn(1.f, alpha);
            const float t_next = __fmul_rn(T, one_m);
            if (t_next < kTEps) {
              done = true;
            } else {
              applied = true;
              const float w = __fmul_rn(alpha, T);
              const float r = s_rows[6 * kBatch + i];
              const float gr = s_rows[7 * kBatch + i];
              const float b = s_rows[8 * kBatch + i];
              pr = fmaf(w, r, pr);
              pg = fmaf(w, gr, pg);
              pb = fmaf(w, b, pb);
              const float cdot = r * g[0] + gr * g[1] + b * g[2];
              const float s_i = acd - (pr * g[0] + pg * g[1] + pb * g[2]);
              const float dl_dalpha = T * cdot - (s_i + tf_term) / fmaxf(one_m, 0.01f);
              const float e_term = e * dl_dalpha;
              const float dlp = op * e_term;
              v[0] = -(ca * dx + cb * dy) * dlp;
              v[1] = -(cc * dy + cb * dx) * dlp;
              v[2] = -0.5f * dx * dx * dlp;
              v[3] = -dx * dy * dlp;
              v[4] = -0.5f * dy * dy * dlp;
              v[5] = e_term;
#pragma unroll
              for (int f = 0; f < 8; ++f) v[6 + f] = w * g[f];
              T = t_next;
            }
          }
        }
      }
      // The branch is uniform across the warp: every lane sees the same vote.
      if (__any_sync(0xffffffffu, applied)) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
          for (int k = 0; k < kOut; ++k) v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
        }
      }
      if (lane == 0) {
        float* dst = s_part + (warp * kBatch + i) * kOut;
#pragma unroll
        for (int k = 0; k < kOut; ++k) dst[k] = v[k];
      }
    }
    __syncthreads();
    // One thread per (row, instance): the warps' sums in warp order, then
    // one plain store; consecutive threads write consecutive columns.
    for (int k = p; k < kOut * kBatch; k += npix) {
      const int r = k / kBatch;
      const int c = k - r * kBatch;
      if (c < n) {
        float sum = 0.f;
        for (int w = 0; w < nwarps; ++w) sum += s_part[(w * kBatch + c) * kOut + r];
        dgrad[r * capacity + base + c] = sum;
      }
    }
    // Whole-tile early exit; the count is the same in every thread.
    if (__syncthreads_count(done) == npix) break;
  }
}

}  // namespace

extern "C" int composite_bwd(const void* data, const void* starts, const void* stops,
                             const void* gacc, const void* acdot, const void* gend,
                             const void* tfinal, void* dgrad, long long capacity,
                             int num_tiles, int grid_x, int tile_x, int tile_y,
                             void* stream) {
  const int npix = tile_x * tile_y;
  const size_t smem = sizeof(float) * (kRows * kBatch + (npix / 32) * kBatch * kOut);
  cudaError_t err = cudaFuncSetAttribute(
      composite_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  composite_bwd_kernel<<<num_tiles, npix, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(data), static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(stops), static_cast<const float*>(gacc),
      static_cast<const float*>(acdot), static_cast<const float*>(gend),
      static_cast<const float*>(tfinal), static_cast<float*>(dgrad), capacity, grid_x,
      tile_x, tile_y);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* composite_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
