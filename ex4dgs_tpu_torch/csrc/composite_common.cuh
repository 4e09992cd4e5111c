// Device pieces shared by the compositing kernels and the layout probes
// (NVIDIA Hopper, sm_90a):
//
//   stage_batch        a batch of instances of the packed buffer
//                      data[16, capacity] staged in shared memory as four
//                      float4 groups per instance;
//   store_accum_dense  the per-pixel accumulators of one tile, accum[P, 8],
//                      restaged through shared memory and stored so that a
//                      warp's store covers 512 contiguous bytes;
//   warp_box, warp_skips
//                      the per-warp cull: whether no pixel of a warp's 32 can
//                      pass the exact per-pixel test of an instance.
//
// Every source that includes this header is rebuilt when it changes
// (kernels.py hashes each source together with every csrc/*.cuh).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace ex4dgs {

constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;

// ---------------------------------------------------------------------------
// The batch staging.
//
// Instance c of a batch sits in shared memory as four float4 groups,
// s4[g * kBatch + c] holding data rows 4g .. 4g + 3:
//
//   g = 0  x  y  a  b        g = 2  blue  depth  fx  fy
//   g = 1  c  op r  g        g = 3  fz    one    -   -
//
// so that a pixel's test of an instance is two broadcast 16-byte loads
// (groups 0 and 1), and its colours and features come from the rest. A
// thread loads four rows of one instance (each row a coalesced 4-byte read
// of the feature-major buffer from the batch's arbitrary start) and writes
// one float4; neighbouring threads write neighbouring float4s. Columns
// c >= n are left as they were. Kernels A and B both stage through it.

constexpr int kStageGroups = 4;

// p: this thread's index in the block, npix: the block's threads.
template <int kBatch>
__device__ __forceinline__ void stage_batch(float4* s4, const float* __restrict__ data,
                                            long long capacity, int base, int n, int p,
                                            int npix) {
  for (int k = p; k < kStageGroups * kBatch; k += npix) {
    const int g = k / kBatch;
    const int c = k - g * kBatch;
    if (c < n) {
      const float* col = data + 4 * g * capacity + base + c;
      float4 v;
      v.x = col[0];
      v.y = col[capacity];
      v.z = g < 3 ? col[2 * capacity] : 0.f;
      v.w = g < 3 ? col[3 * capacity] : 0.f;
      s4[k] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// The dense tile store.
//
// Thread p holds pixel p's acc[8], that is float4 number 2p and 2p + 1 of the
// tile's 2P. Stored straight from registers, a warp's float4 store touches 32
// half-filled 32-byte sectors (1 KB at half density). Restaged, thread p
// stores float4 number p and p + P: each warp store covers 512 contiguous
// bytes in 16 full sectors, as a fill does.
//
// Bank conflicts: a 16-byte shared access is served eight threads at a time,
// and float4 slot s lies in bank group s mod 8. The writes of slots 2p (and
// 2p + 1) by eight neighbouring threads would fall on four groups twice; the
// swizzle s ^ ((s >> 3) & 1) moves the upper four onto the odd (even) groups.
// The reads of slots p are unchanged inside each aligned group of eight.

__device__ __forceinline__ int dense_slot(int s) { return s ^ ((s >> 3) & 1); }

// out: the tile's accum block, float[P * 8] with P = blockDim.x, 16-byte
// aligned. stage: shared memory of at least P * 32 bytes, free for reuse
// once every thread of the block reaches this call (it starts with a
// barrier).
__device__ __forceinline__ void store_accum_dense(float4* stage, const float (&acc)[8],
                                                  float* __restrict__ out) {
  const int p = threadIdx.x;
  const int npix = blockDim.x;
  __syncthreads();
  stage[dense_slot(2 * p)] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  stage[dense_slot(2 * p + 1)] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  __syncthreads();
  float4* o4 = reinterpret_cast<float4*>(out);
  o4[p] = stage[dense_slot(p)];
  o4[p + npix] = stage[dense_slot(p + npix)];
}

// ---------------------------------------------------------------------------
// The per-warp cull.
//
// The exact per-pixel test (composite_fwd.cu) keeps an instance at a pixel
// when power <= 0 and min(op * expf(power), 0.99) >= 1/255, with
// power = -Q/2, Q = a dx^2 + 2 b dx dy + c dy^2, (dx, dy) = mean - pixel.
// warp_skips says that no pixel of the warp's box can pass it. It is
// conservative for the test as computed in fp32, not only in real numbers:
//
//  * op below 1/255, or NaN, is skipped exactly: expf(power <= 0) <= 1, so
//    the rounded alpha is at most op.
//  * A non-finite input, or a conic that is not positive definite (a <= 0
//    or ac - b^2 <= 0), is never skipped: the exact test decides.
//  * Otherwise the smallest Q over the box: 0 when the box holds the mean,
//    else the least of the four edges' minima (on an edge Q is a convex
//    parabola in the free coordinate; its vertex clamped to the edge). The
//    box's corners are the kernel's own differences x - px, y - py at the
//    box's extreme pixels; rounding is monotone, so every pixel's rounded
//    (dx, dy) lies inside it.
//  * A pixel passes only if op * exp(power) >= 1/255 up to expf's 2 ulp and
//    one rounding, i.e. Q <= 2 ln(255 op) + 6e-7. The kernel's rounded power
//    and this Q are each within 4u M of the exact quadratic (u = 2^-24,
//    M = a X^2 + c Y^2 + 2|b| X Y, X and Y the box's largest |dx| and |dy|;
//    three roundings of each product and two of the sums), and logf is
//    within 1 ulp. The instance is kept when
//        Qmin <= 2 logf(255 op) + delta,  delta = 1e-4 + 1e-5 M,
//    whose relative part is 1e-5 / (8u) ~ 20 times what the roundings need
//    and whose absolute part covers the threshold's (6e-7 and 1 ulp of the
//    logarithm) more than 20 times over. Written as `qmin > lim`, a NaN
//    (an overflowed box: lim is then infinite) never skips.
// All products and sums are explicitly rounded, so nvcc contracts none of
// them into an FMA; ops/rasterize_cuda.py::warp_cull_plain is the same
// sequence of operations in PyTorch.

struct WarpBox {
  float x0, x1, y0, y1;  // pixel centres: columns x0..x1, rows y0..y1
};

// The bounding box of pixels first .. first + 31 of the tile whose top-left
// pixel is (tx0, ty0). A warp that spans rows covers every column of the
// tile (it wraps when tile_x is not a multiple of 32).
__device__ __forceinline__ WarpBox warp_box(int first, int tile_x, int tx0, int ty0) {
  const int r0 = first / tile_x;
  const int r1 = (first + 31) / tile_x;
  int c0 = first - r0 * tile_x;
  int c1 = first + 31 - r1 * tile_x;
  if (r1 != r0) {
    c0 = 0;
    c1 = tile_x - 1;
  }
  return {static_cast<float>(tx0 + c0), static_cast<float>(tx0 + c1),
          static_cast<float>(ty0 + r0), static_cast<float>(ty0 + r1)};
}

// min over t in [lo, hi] of p t^2 + 2 b t s + q s^2, s fixed, p > 0.
__device__ __forceinline__ float edge_min(float p, float b, float q, float s, float lo,
                                          float hi) {
  const float t = fminf(fmaxf(__fdiv_rn(-__fmul_rn(b, s), p), lo), hi);
  return __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(p, t), t),
                             __fmul_rn(__fmul_rn(__fmul_rn(2.f, b), t), s)),
                   __fmul_rn(__fmul_rn(q, s), s));
}

__device__ __forceinline__ bool warp_skips(float x, float y, float a, float b, float c,
                                           float op, const WarpBox& box) {
  if (!(op >= kAlphaMin)) return true;
  if (!(isfinite(x) && isfinite(y) && isfinite(a) && isfinite(b) && isfinite(c) &&
        isfinite(op)))
    return false;
  if (!(a > 0.f) || !(__fsub_rn(__fmul_rn(a, c), __fmul_rn(b, b)) > 0.f)) return false;
  const float lx = __fsub_rn(x, box.x1), hx = __fsub_rn(x, box.x0);
  const float ly = __fsub_rn(y, box.y1), hy = __fsub_rn(y, box.y0);
  float qmin = 0.f;
  if (!(lx <= 0.f && hx >= 0.f && ly <= 0.f && hy >= 0.f)) {
    qmin = fminf(fminf(edge_min(a, b, c, ly, lx, hx), edge_min(a, b, c, hy, lx, hx)),
                 fminf(edge_min(c, b, a, lx, ly, hy), edge_min(c, b, a, hx, ly, hy)));
  }
  const float bx = fmaxf(fabsf(lx), fabsf(hx));
  const float by = fmaxf(fabsf(ly), fabsf(hy));
  const float m = __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(a, bx), bx),
                                      __fmul_rn(__fmul_rn(c, by), by)),
                            __fmul_rn(__fmul_rn(__fmul_rn(2.f, fabsf(b)), bx), by));
  const float lim = __fadd_rn(__fadd_rn(__fmul_rn(2.f, logf(__fmul_rn(255.f, op))), 1e-4f),
                              __fmul_rn(1e-5f, m));
  return qmin > lim;
}

}  // namespace ex4dgs
