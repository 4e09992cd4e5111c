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
// every range keep the zeros the wrapper fills in. With the forward's
// subpixel offsets off[T, P, 2] (null: none), the pixel is its centre plus
// off[t, p], one rounded add per coordinate, as in the forward. Block t
// walks the grid's tile tile0 + t (the JAX kernel's tids[t],
// rasterize_pallas.py:760), as the forward: the global index sets the pixels
// and the warp boxes, the local t indexes starts, stops, the offsets and the
// cotangents.
//
// Design: one thread block per tile, one thread per pixel, as the forward.
// The block stages a batch of 32 instances in shared memory, every pixel
// computes its 14 contributions per instance, each warp sums them over its
// 32 pixels and parks the sums in shared memory, and after the batch one
// thread per (row, instance) adds the warps' sums in warp order and stores
// the result. Every instance belongs to exactly one tile, so each output is
// one plain store: no atomics, and the result is the same bit for bit on
// every run.
//
// Bit-level agreement with the forward: alpha, the alpha floor and the latch
// are recomputed with the same explicitly rounded operations and the same
// accurate expf as the forward kernel, so an instance is applied here exactly
// where it was applied there. Do not build with --use_fast_math.
//
// Bit-level agreement with the plain version's walk: every gradient
// quantity is computed with explicitly rounded operations in the order of
// ops/rasterize_cuda.py::composite_tiles_bwd_plain, S_i from the running sum
// of w c . gc as the plain version and the TPU kernel form it, so nvcc fuses
// nothing and the result does not depend on how a build schedules the
// arithmetic. Per pixel the kernel then computes what the plain version
// walked one instance at a time computes, and its sums over the pixels are
// the pairwise tree of the warp reduction followed by the warps in order:
// ops/rasterize_cuda.py::composite_tiles_bwd_walk repeats both, and the
// kernel's output equals it bit for bit.
//
// What bounds it on the H100: instance x pixel pairs. A contributing pair
// costs the forward's 15 fp32 instructions and one exp; an applied pair about
// 43 more for the gradient terms, and its 14 contributions must each be
// added once into its instance's sums. The bytes moved (14 rows read and 16
// written per instance, 44 bytes of cotangents per pixel) are far below the
// memory roofline. What the design does about the work outside that count:
//  * Per-warp culling, as kernel A (composite_common.cuh::warp_box, or
//    warp_box_of from the offset pixels, and warp_skips, conservative in
//    fp32; one instantiation per box, kSubpixel). After a batch is staged,
//    lane l of each warp tests instance l against the warp's pixel box, and
//    the warp walks only the survivors, in ascending (depth) order (a
//    ballot mask, __ffs); a warp whose 32 pixels have all latched walks
//    nothing. A skipped instance is one no pixel of the warp would have
//    applied, so T, the running sum and the latch are unchanged and the
//    warp's sums for it are zero. Each warp records in s_mask which
//    instances it parked sums for; the cross-warp sum adds only those, so
//    no slot of an earlier batch is read and no zero is written. Skipping a
//    +0.0 term of a sum that starts at +0.0 changes no bit.
//  * Vectorised staging (composite_common.cuh::stage_batch, shared with
//    kernel A): an evaluated pair reads two broadcast 16-byte loads and an
//    applied pair one more, where scalar rows took 6 and 9 loads.
//  * A transposed warp reduction (warp_sum_transposed). The 14 values are
//    padded to 16, and at each xor level every lane sends the half of its
//    values that its partner keeps: 8 + 4 + 2 + 1 + 1 = 16 shuffles and 16
//    adds per lane, where a butterfly per value takes 5 x 14 = 70 of each.
//    Lanes 2r and 2r + 1 end with value r's warp sum, and the even lanes
//    write the 14 rows to shared memory in one store each. Every value is
//    summed over the pairwise tree of lane bits 16, 8, 4, 2, 1, the tree of
//    a butterfly, so the sums are a butterfly's bit for bit. A warp step in
//    which no lane applied the instance reduces nothing (a vote).
//
// On the bench frame (NVIDIA H100 80GB HBM3, 700 W) the cull leaves 6.04 M
// of 10.78 M warp steps, 97.5% of them with an applied lane; the butterfly
// spent 412 M warp shuffles on them (1.58 ms of the shuffle unit's one
// shuffle per clock and SM), the transposed reduction 94 M. What bounds the
// kernel after that is the instructions a warp step issues (about 270 issue
// slots per step at 1.56 ms). What it leaves on the table: a warp step pays
// the union of its lanes' paths; latched pixels idle until their warp is
// done; the staging is not overlapped with the walk (prefetching the next
// batch into registers and batches of 64 each gained under 3%).
#include <cuda_runtime.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

using ex4dgs::kAlphaMax;
using ex4dgs::kAlphaMin;
using ex4dgs::kTEps;

constexpr int kBatch = 32;       // instances staged, walked and reduced per batch
constexpr int kOut = 14;         // gradient rows written: dxy, dconic, dopac, dfeat
constexpr int kVals = 16;        // kOut padded to a power of two for the reduction
constexpr int kPartStride = 17;  // s_part floats per (warp, instance): column reads
                                 // by consecutive threads fall on distinct banks
constexpr unsigned kFull = 0xffffffffu;

// (x g[0] + y g[1]) + z g[2], each operation rounded: the order of the
// plain version's sum over the colour channels.
__device__ __forceinline__ float dot3(float x, float y, float z, const float (&g)[8]) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, g[0]), __fmul_rn(y, g[1])), __fmul_rn(z, g[2]));
}

// One level of the transposed warp sum. v[0 .. 2 kHalf) hold the values
// whose indices share this lane's higher lane bits; the lane keeps the half
// whose next index bit equals its lane bit 2 kHalf and adds its partner's
// copy of that half, which the partner sends in exchange for the other half.
template <int kHalf>
__device__ __forceinline__ void transpose_level(float (&v)[kVals], int lane) {
  const bool upper = lane & (2 * kHalf);
#pragma unroll
  for (int k = 0; k < kHalf; ++k) {
    const float keep = upper ? v[k + kHalf] : v[k];
    const float send = upper ? v[k] : v[k + kHalf];
    v[k] = keep + __shfl_xor_sync(kFull, send, 2 * kHalf);
  }
}

// The warp sum of v[0..15] over the 32 lanes, transposed: after the levels
// of lane bits 16, 8, 4 and 2, lane l holds value l >> 1 summed over its 16
// lanes of equal bit 0, and the xor-1 level completes the sum in both lanes
// of the pair (a + b and b + a: the same bits). 8 + 4 + 2 + 1 + 1 shuffles.
// Clobbers v.
__device__ __forceinline__ float warp_sum_transposed(float (&v)[kVals], int lane) {
  transpose_level<8>(v, lane);
  transpose_level<4>(v, lane);
  transpose_level<2>(v, lane);
  transpose_level<1>(v, lane);
  return v[0] + __shfl_xor_sync(kFull, v[0], 1);
}

template <bool kSubpixel>
__global__ void __launch_bounds__(1024)
composite_bwd_kernel(const float* __restrict__ data, const int32_t* __restrict__ starts,
                     const int32_t* __restrict__ stops, const float2* __restrict__ offsets,
                     const float* __restrict__ gacc,
                     const float* __restrict__ acdot, const float* __restrict__ gend,
                     const float* __restrict__ tfinal, float* __restrict__ dgrad,
                     long long capacity, int tile0, int grid_x, int tile_x, int tile_y) {
  // s4[g * kBatch + c]: rows 4g .. 4g + 3 of instance c of the batch;
  // s_part[(w * kBatch + c) * kPartStride + r]: warp w's sum of row r for
  // instance c, valid where bit c of s_mask[w] is set.
  extern __shared__ float4 s4[];
  float* s_part = reinterpret_cast<float*>(s4 + ex4dgs::kStageGroups * kBatch);
  const int npix = blockDim.x;
  const int nwarps = npix >> 5;
  unsigned* s_mask = reinterpret_cast<unsigned*>(s_part + nwarps * kBatch * kPartStride);

  const int tile = blockIdx.x;  // local: starts, stops, offsets, cotangents
  const int gtile = tile0 + tile;  // global: the pixels
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int tx0 = (gtile % grid_x) * tile_x;
  const int ty0 = (gtile / grid_x) * tile_y;
  const long long o = static_cast<long long>(tile) * npix + p;
  float px = static_cast<float>(tx0 + p % tile_x);
  float py = static_cast<float>(ty0 + p / tile_x);
  ex4dgs::WarpBox box;
  if constexpr (kSubpixel) {
    const float2 off = offsets[o];
    px = __fadd_rn(px, off.x);
    py = __fadd_rn(py, off.y);
    box = ex4dgs::warp_box_of(px, py);
  } else {
    box = ex4dgs::warp_box(p - lane, tile_x, tx0, ty0);
  }
  const int start = starts[tile];
  const int stop = stops[tile];

  const float4* g4 = reinterpret_cast<const float4*>(gacc + o * 8);
  const float4 ga = g4[0];
  const float4 gb = g4[1];
  const float g[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
  const float acd = acdot[o];
  const float tf_term = tfinal[o] * gend[o];

  float T = 1.f;
  float incl = 0.f;  // sum of w c . gc over the instances applied so far
  bool done = false;

  for (int base = start; base < stop; base += kBatch) {
    const int n = min(kBatch, stop - base);
    __syncthreads();  // the previous batch's rows, sums and masks are consumed
    ex4dgs::stage_batch<kBatch>(s4, data, capacity, base, n, p, npix);
    __syncthreads();

    unsigned parked = 0;  // instances of the batch whose sums this warp parked
    if (__any_sync(kFull, !done)) {  // else every pixel of the warp latched
      bool keep = false;
      if (lane < n) {
        const float4 g0 = s4[lane];
        const float4 g1 = s4[kBatch + lane];
        keep = !ex4dgs::warp_skips(g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, box);
      }
      unsigned live = __ballot_sync(kFull, keep);
      while (live) {
        const int i = __ffs(live) - 1;
        live &= live - 1;
        float v[kVals];
#pragma unroll
        for (int k = 0; k < kVals; ++k) v[k] = 0.f;
        bool applied = false;
        if (!done) {
          const float4 g0 = s4[i];           // x, y, a, b
          const float4 g1 = s4[kBatch + i];  // c, opacity, r, g
          const float ca = g0.z, cb = g0.w, cc = g1.x, op = g1.y;
          const float dx = __fsub_rn(g0.x, px);
          const float dy = __fsub_rn(g0.y, py);
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
                const float r = g1.z;
                const float gr = g1.w;
                const float b = s4[2 * kBatch + i].x;
                const float cdot = dot3(r, gr, b, g);
                incl = __fadd_rn(__fmul_rn(w, cdot), incl);
                const float s_i = __fsub_rn(acd, incl);
                const float dl_dalpha =
                    __fsub_rn(__fmul_rn(T, cdot), __fdiv_rn(__fadd_rn(s_i, tf_term),
                                                            fmaxf(one_m, 0.01f)));
                const float e_term = __fmul_rn(e, dl_dalpha);
                const float dlp = __fmul_rn(op, e_term);
                v[0] = __fmul_rn(-__fadd_rn(__fmul_rn(ca, dx), __fmul_rn(cb, dy)), dlp);
                v[1] = __fmul_rn(-__fadd_rn(__fmul_rn(cc, dy), __fmul_rn(cb, dx)), dlp);
                v[2] = __fmul_rn(__fmul_rn(__fmul_rn(-0.5f, dx), dx), dlp);
                v[3] = __fmul_rn(__fmul_rn(-dx, dy), dlp);
                v[4] = __fmul_rn(__fmul_rn(__fmul_rn(-0.5f, dy), dy), dlp);
                v[5] = e_term;
#pragma unroll
                for (int f = 0; f < 8; ++f) v[6 + f] = __fmul_rn(w, g[f]);
                T = t_next;
              }
            }
          }
        }
        // The vote is the same in every lane: the branch is uniform.
        if (__any_sync(kFull, applied)) {
          const float sum = warp_sum_transposed(v, lane);
          const int row = lane >> 1;
          if (!(lane & 1) && row < kOut) s_part[(warp * kBatch + i) * kPartStride + row] = sum;
          parked |= 1u << i;
        }
      }
    }
    if (lane == 0) s_mask[warp] = parked;
    __syncthreads();
    // One thread per (row, instance): the parked sums of the warps in warp
    // order, then one plain store; consecutive threads write consecutive
    // columns.
    for (int k = p; k < kOut * kBatch; k += npix) {
      const int r = k / kBatch;
      const int c = k - r * kBatch;
      if (c < n) {
        float sum = 0.f;
        for (int w = 0; w < nwarps; ++w) {
          if (s_mask[w] >> c & 1u) sum += s_part[(w * kBatch + c) * kPartStride + r];
        }
        dgrad[r * capacity + base + c] = sum;
      }
    }
    // Whole-tile early exit; the count is the same in every thread.
    if (__syncthreads_count(done) == npix) break;
  }
}

template <bool kSubpixel>
cudaError_t launch(const void* data, const void* starts, const void* stops,
                   const void* offsets, const void* gacc, const void* acdot, const void* gend,
                   const void* tfinal, void* dgrad, long long capacity, int num_tiles,
                   int tile0, int grid_x, int tile_x, int tile_y, cudaStream_t stream) {
  const int npix = tile_x * tile_y;
  const int nwarps = npix / 32;
  const size_t smem = sizeof(float4) * ex4dgs::kStageGroups * kBatch +
                      sizeof(float) * nwarps * kBatch * kPartStride +
                      sizeof(unsigned) * nwarps;
  cudaError_t err = cudaFuncSetAttribute(composite_bwd_kernel<kSubpixel>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  composite_bwd_kernel<kSubpixel><<<num_tiles, npix, smem, stream>>>(
      static_cast<const float*>(data), static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(stops), static_cast<const float2*>(offsets),
      static_cast<const float*>(gacc), static_cast<const float*>(acdot),
      static_cast<const float*>(gend), static_cast<const float*>(tfinal),
      static_cast<float*>(dgrad), capacity, tile0, grid_x, tile_x, tile_y);
  return cudaGetLastError();
}

}  // namespace

// offsets: the forward's f32 [T, P, 2], or null for pixel centres on the
// integer grid. tile0: the grid index of the first tile (0 for a whole frame).
extern "C" int composite_bwd(const void* data, const void* starts, const void* stops,
                             const void* offsets, const void* gacc, const void* acdot,
                             const void* gend, const void* tfinal, void* dgrad,
                             long long capacity, int num_tiles, int tile0, int grid_x,
                             int tile_x, int tile_y, void* stream) {
  const auto run = offsets ? launch<true> : launch<false>;
  return static_cast<int>(run(data, starts, stops, offsets, gacc, acdot, gend, tfinal, dgrad,
                              capacity, num_tiles, tile0, grid_x, tile_x, tile_y,
                              static_cast<cudaStream_t>(stream)));
}

extern "C" const char* composite_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
