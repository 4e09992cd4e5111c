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
// Outputs per tile t and pixel p (p = y * tile_x + x in tile-local order):
//   accum[t, p, 0:8]  sum of w * (r, g, b, depth, fx, fy, fz, 1) (data rows 6-13)
//   tfinal[t, p]      T after the last applied sample (1 if none applied)
//   bestidx[t, p]     Gaussian id (from the int32 gid buffer) of the largest w,
//                     the earliest in depth order on ties; -1 if none or when
//                     ids are not tracked.
//
// Design: one thread block per tile, one thread per pixel. The block stages
// batches of the tile's instances in shared memory (rows are feature-major, so
// each row of a batch is one coalesced load), then every pixel runs the
// sequential blend over the batch. A pixel latches once T would drop below
// 1e-4; the block leaves its range as soon as __syncthreads_count shows every
// pixel latched.
//
// What bounds it on the H100: instance x pixel evaluations. Each pair costs one
// exp (SFU) and 15 fp32 instructions, and an applied pair 13 more (8 of them
// the feature FMAs); at one fp32 instruction per lane per clock that outweighs
// the SFU's exp. The bytes moved (each instance row read once per tile, 40
// bytes per pixel written) are far below the memory roofline.
//
// The power and alpha are computed with explicitly rounded operations in the
// same order as the plain PyTorch version (ops/rasterize_cuda.py), and with the
// same accurate expf, so the alpha-floor decisions agree bit for bit with it.
// Do not build with --use_fast_math: it would change exp and flush denormals.
//
// What this simple design leaves on the table: pixels of a tile that latched
// early idle until the whole tile exits; the staging loads are not overlapped
// with the blend (no cp.async/TMA double buffering); every instance is
// evaluated at all pixels of its tile, with no per-warp culling against the
// splat's extent; and the pixel dimension never reaches the tensor cores.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBatch = 256;  // instances staged per shared-memory batch
constexpr int kRows = 14;    // data rows read: xy, conic, opacity, 8 features
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;

__global__ void __launch_bounds__(1024)
composite_fwd_kernel(const float* __restrict__ data, const int32_t* __restrict__ gid,
                     const int32_t* __restrict__ starts, const int32_t* __restrict__ stops,
                     float* __restrict__ accum, float* __restrict__ tfinal,
                     int32_t* __restrict__ bestidx, long long capacity, int grid_x,
                     int tile_x, int tile_y, int track_idx) {
  __shared__ float s_rows[kRows][kBatch];
  __shared__ int32_t s_gid[kBatch];

  const int tile = blockIdx.x;
  const int npix = blockDim.x;
  const int p = threadIdx.x;
  // Pixel centres are exact integers in float; mean - pixel is then one
  // rounding, the same subtraction the plain version performs.
  const float px = static_cast<float>((tile % grid_x) * tile_x + p % tile_x);
  const float py = static_cast<float>((tile / grid_x) * tile_y + p / tile_x);
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
    for (int k = p; k < kRows * kBatch; k += npix) {
      const int r = k / kBatch;
      const int c = k - r * kBatch;
      if (c < n) s_rows[r][c] = data[r * capacity + base + c];
    }
    for (int c = p; c < n; c += npix) s_gid[c] = gid[base + c];
    __syncthreads();

    if (!done) {
      for (int i = 0; i < n; ++i) {
        const float dx = __fsub_rn(s_rows[0][i], px);
        const float dy = __fsub_rn(s_rows[1][i], py);
        const float q = __fadd_rn(__fmul_rn(__fmul_rn(s_rows[2][i], dx), dx),
                                  __fmul_rn(__fmul_rn(s_rows[4][i], dy), dy));
        const float power =
            __fsub_rn(__fmul_rn(-0.5f, q), __fmul_rn(__fmul_rn(s_rows[3][i], dx), dy));
        // Negated tests, and a min that keeps NaN, so a NaN power or opacity
        // is skipped as the plain version's masks skip it (fminf would turn
        // a NaN alpha into 0.99).
        if (!(power <= 0.f)) continue;
        const float raw = __fmul_rn(s_rows[5][i], expf(power));
        const float alpha = raw > kAlphaMax ? kAlphaMax : raw;
        if (!(alpha >= kAlphaMin)) continue;
        const float t_next = T * (1.f - alpha);
        if (t_next < kTEps) {
          done = true;
          break;
        }
        const float w = alpha * T;
#pragma unroll
        for (int f = 0; f < 8; ++f) acc[f] = fmaf(w, s_rows[6 + f][i], acc[f]);
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
  float4* a4 = reinterpret_cast<float4*>(accum + o * 8);
  a4[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  a4[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  tfinal[o] = T;
  bestidx[o] = track_idx ? best_id : -1;
}

}  // namespace

extern "C" int composite_fwd(const void* data, const void* gid, const void* starts,
                             const void* stops, void* accum, void* tfinal, void* bestidx,
                             long long capacity, int num_tiles, int grid_x, int tile_x,
                             int tile_y, int track_idx, void* stream) {
  composite_fwd_kernel<<<num_tiles, tile_x * tile_y, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(data), static_cast<const int32_t*>(gid),
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(stops),
      static_cast<float*>(accum), static_cast<float*>(tfinal), static_cast<int32_t*>(bestidx),
      capacity, grid_x, tile_x, tile_y, track_idx);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* composite_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
