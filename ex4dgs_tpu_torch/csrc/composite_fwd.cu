// Forward tile compositing for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel ex4dgs_tpu/ops/rasterize_pallas.py::_forward_kernel.
// Each tile's depth-sorted instance range [starts[t], stops[t]) of the packed
// feature-major buffer data[16, capacity] is blended front to back into the
// tile's pixels:
//
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy     (dx, dy: mean - pixel)
//   alpha = min(opacity * exp(power), 0.99), skipped if power > 0 or
//           alpha < 1/255
//   w     = alpha * T;  T *= 1 - alpha           while T (1 - alpha) >= 1e-4
//
// With subpixel offsets off[T, P, 2] (null: none), pixel p of tile t is
// evaluated at its centre plus off[t, p], one rounded add per coordinate
// (the JAX kernel's pixel + offset, rasterize_pallas.py:464-467).
//
// Block t composites the grid's tile tile0 + t (the JAX kernel's tile id
// tids[t], rasterize_pallas.py:456-458, which is t0 + arange on a slab of a
// tile-sharded frame and arange on a whole one): the global index sets the
// pixel coordinates and the warp boxes; starts, stops, the offsets and the
// outputs are indexed by the local t.
//
// Outputs per tile t and pixel p (p = y * tile_x + x in tile-local order):
//   accum[t, p, 0:8]  sum of w * (r, g, b, depth, fx, fy, fz, 1) (data rows 6-13)
//   tfinal[t, p]      T after the last applied sample (1 if none applied)
//   bestidx[t, p]     Gaussian id (from the int32 gid buffer) of the largest w,
//                     the earliest in depth order on ties; -1 if none or when
//                     ids are not tracked.
//
// Design: one thread block per tile, one thread per pixel. The block stages
// batches of 256 instances in shared memory, then every pixel runs the
// sequential blend over the batch. A pixel latches once T would drop below
// 1e-4; the block leaves its range as soon as __syncthreads_count shows every
// pixel latched.
//
// What bounds it on the H100: the fp32 instructions of the instance x pixel
// pairs, 15 for each pair that contributes and 13 more for each that is
// applied, plus an exp on the SFU; the bytes (each instance row read once
// per tile, 40 bytes per pixel written) are far below the memory roofline.
// What the design does about the work that is not in that count:
//  * Per-warp culling. Most of a tile's splats reach none of a warp's 32
//    pixels. After a batch is staged, each warp tests its lanes' instances
//    (lane l takes instances l, l + 32, ...) against the bounding box of its
//    pixels (composite_common.cuh::warp_skips, conservative in fp32), and
//    its pixels walk only the survivors of each group of 32, in ascending
//    order (a ballot mask, __ffs), which is still depth order. A skipped
//    pair is one the exact test below would have skipped, so the outputs
//    are those of the kernel without the cull, bit for bit. Without
//    offsets the box comes from the tile's geometry (warp_box); with them,
//    from the warp's own rounded pixel coordinates by warp shuffles once per
//    tile (warp_box_of). The two paths are two instantiations of the kernel
//    (kSubpixel), so the path without offsets does none of the offsets'
//    work.
//  * Vectorised staging (composite_common.cuh::stage_batch, shared with
//    kernel B). The batch sits in shared memory as four float4 groups per
//    instance (x y a b | c op r g | b depth fx fy | fz one - -): an
//    evaluated pair reads two broadcast 16-byte loads, an applied pair two
//    more, where scalar rows took 6 and 8.
//  * The dense accum store of composite_common.cuh, through the staging
//    buffer (which is sized to at least P * 32 bytes for it).
//
// The power and alpha are computed with explicitly rounded operations in the
// same order as the plain PyTorch version (ops/rasterize_cuda.py), and with the
// same accurate expf, so the alpha-floor decisions agree bit for bit with it.
// Do not build with --use_fast_math: it would change exp and flush denormals.
//
// What it leaves on the table: pixels that latched early idle until their
// warp (and the tile) is done; the staging loads are not overlapped with the
// blend; tiles run in launch order, so a long range may start in the last
// wave; and the pixel dimension never reaches the tensor cores.
#include <cuda_runtime.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

using ex4dgs::kAlphaMax;
using ex4dgs::kAlphaMin;
using ex4dgs::kTEps;

constexpr int kBatch = 256;  // instances staged per shared-memory batch
constexpr unsigned kFull = 0xffffffffu;

template <bool kSubpixel>
__global__ void __launch_bounds__(1024)
composite_fwd_kernel(const float* __restrict__ data, const int32_t* __restrict__ gid,
                     const int32_t* __restrict__ starts, const int32_t* __restrict__ stops,
                     const float2* __restrict__ offsets, float* __restrict__ accum,
                     float* __restrict__ tfinal,
                     int32_t* __restrict__ bestidx, long long capacity, int tile0,
                     int grid_x, int tile_x, int tile_y, int track_idx) {
  // s4[g * kBatch + c]: rows 4g .. 4g + 3 of instance c of the batch; at the
  // end, the dense store's staging buffer.
  extern __shared__ float4 s4[];
  __shared__ int32_t s_gid[kBatch];

  const int tile = blockIdx.x;  // local: starts, stops, offsets, outputs
  const int gtile = tile0 + tile;  // global: the pixels
  const int npix = blockDim.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int tx0 = (gtile % grid_x) * tile_x;
  const int ty0 = (gtile / grid_x) * tile_y;
  // Pixel centres are exact integers in float; mean - pixel is then one
  // rounding, the same subtraction the plain version performs. An offset
  // pixel is the rounded centre + offset, as in the plain version.
  float px = static_cast<float>(tx0 + p % tile_x);
  float py = static_cast<float>(ty0 + p / tile_x);
  ex4dgs::WarpBox box;
  if constexpr (kSubpixel) {
    const float2 off = offsets[static_cast<long long>(tile) * npix + p];
    px = __fadd_rn(px, off.x);
    py = __fadd_rn(py, off.y);
    box = ex4dgs::warp_box_of(px, py);
  } else {
    box = ex4dgs::warp_box(p - lane, tile_x, tx0, ty0);
  }
  const int start = starts[tile];
  const int stop = stops[tile];

  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float T = 1.f;
  float best_w = 0.f;
  int32_t best_id = -1;
  bool done = false;

  for (int base = start; base < stop; base += kBatch) {
    const int n = min(kBatch, stop - base);
    __syncthreads();  // the previous batch is consumed by every pixel
    ex4dgs::stage_batch<kBatch>(s4, data, capacity, base, n, p, npix);
    for (int c = p; c < n; c += npix) s_gid[c] = gid[base + c];
    __syncthreads();

    for (int c0 = 0; c0 < n; c0 += 32) {
      if (!__any_sync(kFull, !done)) break;  // every pixel of the warp latched
      const int cl = c0 + lane;
      bool keep = false;
      if (cl < n) {
        const float4 g0 = s4[cl];
        const float4 g1 = s4[kBatch + cl];
        keep = !ex4dgs::warp_skips(g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, box);
      }
      unsigned live = __ballot_sync(kFull, keep);
      if (done) continue;
      while (live) {
        const int i = c0 + __ffs(live) - 1;
        live &= live - 1;
        const float4 g0 = s4[i];           // x, y, a, b
        const float4 g1 = s4[kBatch + i];  // c, opacity, r, g
        const float dx = __fsub_rn(g0.x, px);
        const float dy = __fsub_rn(g0.y, py);
        const float q = __fadd_rn(__fmul_rn(__fmul_rn(g0.z, dx), dx),
                                  __fmul_rn(__fmul_rn(g1.x, dy), dy));
        const float power = __fsub_rn(__fmul_rn(-0.5f, q), __fmul_rn(__fmul_rn(g0.w, dx), dy));
        // Negated tests, and a min that keeps NaN, so a NaN power or opacity
        // is skipped as the plain version's masks skip it (fminf would turn
        // a NaN alpha into 0.99).
        if (!(power <= 0.f)) continue;
        const float raw = __fmul_rn(g1.y, expf(power));
        const float alpha = raw > kAlphaMax ? kAlphaMax : raw;
        if (!(alpha >= kAlphaMin)) continue;
        const float t_next = T * (1.f - alpha);
        if (t_next < kTEps) {
          done = true;
          break;
        }
        const float w = alpha * T;
        const float4 g2 = s4[2 * kBatch + i];  // b, depth, fx, fy
        const float4 g3 = s4[3 * kBatch + i];  // fz, one
        acc[0] = fmaf(w, g1.z, acc[0]);
        acc[1] = fmaf(w, g1.w, acc[1]);
        acc[2] = fmaf(w, g2.x, acc[2]);
        acc[3] = fmaf(w, g2.y, acc[3]);
        acc[4] = fmaf(w, g2.z, acc[4]);
        acc[5] = fmaf(w, g2.w, acc[5]);
        acc[6] = fmaf(w, g3.x, acc[6]);
        acc[7] = fmaf(w, g3.y, acc[7]);
        T = t_next;
        if (w > best_w) {
          best_w = w;
          best_id = s_gid[i];
        }
      }
    }
    // Whole-tile early exit; the count is the same in every thread.
    if (__syncthreads_count(done) == npix) break;
  }

  const long long o = static_cast<long long>(tile) * npix + p;
  ex4dgs::store_accum_dense(s4, acc, accum + static_cast<long long>(tile) * npix * 8);
  tfinal[o] = T;
  bestidx[o] = track_idx ? best_id : -1;
}

template <bool kSubpixel>
void launch(const void* data, const void* gid, const void* starts, const void* stops,
            const void* offsets, void* accum, void* tfinal, void* bestidx, long long capacity,
            int num_tiles, int tile0, int grid_x, int tile_x, int tile_y, int track_idx,
            cudaStream_t stream) {
  const int npix = tile_x * tile_y;
  // The staging buffer: the batch, or the dense store's P float4 pairs.
  const size_t stage = sizeof(float4) * max(ex4dgs::kStageGroups * kBatch, 2 * npix);
  composite_fwd_kernel<kSubpixel><<<num_tiles, npix, stage, stream>>>(
      static_cast<const float*>(data), static_cast<const int32_t*>(gid),
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(stops),
      static_cast<const float2*>(offsets), static_cast<float*>(accum),
      static_cast<float*>(tfinal), static_cast<int32_t*>(bestidx), capacity, tile0, grid_x,
      tile_x, tile_y, track_idx);
}

}  // namespace

// offsets: f32 [T, P, 2], or null for pixel centres on the integer grid.
// tile0: the grid index of the first tile (0 for a whole frame).
extern "C" int composite_fwd(const void* data, const void* gid, const void* starts,
                             const void* stops, const void* offsets, void* accum,
                             void* tfinal, void* bestidx, long long capacity, int num_tiles,
                             int tile0, int grid_x, int tile_x, int tile_y, int track_idx,
                             void* stream) {
  const auto run = offsets ? launch<true> : launch<false>;
  run(data, gid, starts, stops, offsets, accum, tfinal, bestidx, capacity, num_tiles, tile0,
      grid_x, tile_x, tile_y, track_idx, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* composite_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
