// The pack VJP (ops/rasterize_cuda.py::PackSorted.backward) for NVIDIA
// Hopper (sm_90a): each Gaussian's gradient row is the sum of the cotangent
// columns of its own instances. The plain version is
// ops/rasterize_cuda.py::pack_vjp_plain, equal to it bit for bit.
//
//   d_rows[r, g] = sum over the expansion slots j in [lo, hi) of the
//                  cotangent column of the sorted instance in slot j,
//                  lo = cum[g] - counts[g], hi = cum[g]
//
// (both clamped to [0, capacity]). A Gaussian with no instance gets 0, and
// the tail slots, past every segment, are summed into nothing.
//
// Two kernels on the caller's stream.
//
// pack_vjp_kernel_scatter puts the live instances' cotangents in expansion
// order: thread k reads slot[k] (Binning.slot) and, if that slot is below
// the live count min(cum[P - 1], capacity), moves column k of ct [16,
// capacity] to row slot[k] of by_slot [capacity, 16]. Reading `slot` is the
// one piece of work the size of the capacity; only the live columns move (a
// prefix of the sorted order, so the reads are coalesced along each row).
// A warp's 32 columns go through shared memory so that each store writes
// whole 64-byte rows, 8 of them, rather than a quarter of 32.
//
// pack_vjp_kernel sums the segments. A warp takes 16 consecutive Gaussians:
// lane i loads Gaussian i's cum and counts, the segments of the 16 follow
// one another in by_slot, and up to 128 of their rows go to shared memory
// in one burst of asynchronous copies. The warp then walks the Gaussians
// with instances (a ballot; a Gaussian with none keeps its 0). For each,
// lane l owns the stream of instances m = l, l + 32, l + 64, ... of the
// segment (m = j - lo) and sums each of the 16 rows of them in float64, in
// that order; the 32 lanes' sums are combined by one fixed butterfly
// (partners at lane distance 16, 8, 4, 2, 1) and rounded to float32 once.
// The order depends on the expansion slots alone, not on the sorted columns
// nor on the scheduling, and no atomics are used: two launches give the
// same bits, and an instance whose cotangent is 0 (one the tight cull moved
// past the last tile) leaves every sum as it was. The butterfly is
// transposed, as kernel B's row sums are: at each distance a lane keeps
// half of the rows it holds and sends the other half, so 16 shuffles (of
// doubles) reduce the 16 rows, and lanes 2r and 2r + 1 end holding row r.
// The results are staged in shared memory and stored as 16 runs of 16
// consecutive floats.
//
// What bounds it on the H100: bytes and instructions. The count is 68 bytes
// a live instance and 72 a visible Gaussian
// (gsbench/metrics/pack_vjp_roofline.py); the scatter moves each live
// instance's 64 bytes twice more (read along the rows, written as a row)
// so that the sums read whole rows, where gathering the 16 rows of an
// instance's column would touch 16 sectors. Most Gaussians touch 5-7 tiles
// (a few hundred bytes), so one memory latency per Gaussian, or a warp's
// reduction spent on a Gaussian with no instance, would set the time: hence
// a chunk's rows in one burst and the ballot. A splat that covers much of
// the frame touches thousands of tiles: a thread that walked it alone would
// set the kernel's time; here its warp's 32 lanes read two rounds (4 KB)
// at a time from global memory (its rows do not fit the stage), so its n
// instances take about n / 64 memory latencies.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 16;   // rows of the packed buffer (DATA_ROWS)
constexpr int kWarps = 4;   // warps per block of the sums
constexpr int kChunk = 16;  // consecutive Gaussians per warp
constexpr int kStage = 128; // rows of a warp's chunk held in shared memory
constexpr int kScatterBlock = 256;
constexpr unsigned kFull = 0xffffffffu;

// One level of the transposed butterfly: a lane holding H * 2 rows keeps H
// of them (the upper half where `lane & offset`) and adds its partner's
// sum of the same rows.
template <int H>
__device__ __forceinline__ void fold(const double (&in)[2 * H], double (&out)[H], int lane,
                                     int offset) {
  const bool upper = (lane & offset) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const double send = upper ? in[i] : in[i + H];
    const double keep = upper ? in[i + H] : in[i];
    out[i] = keep + __shfl_xor_sync(kFull, send, offset);
  }
}

__device__ __forceinline__ long long clamp_slot(long long x, long long capacity) {
  return x < 0 ? 0 : (x > capacity ? capacity : x);
}

// Where float4 q of staged row r sits: rows are 64 bytes (16 banks), so
// without the swizzle the 8 lanes of a 128-bit access phase, one row each,
// would meet in two groups of banks.
__device__ __forceinline__ int swizzle(int r, int q) { return q ^ ((r >> 1) & 3); }

__device__ __forceinline__ void add_row(double (&acc)[kRows], const float4 (&v)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    acc[4 * q] += static_cast<double>(v[q].x);
    acc[4 * q + 1] += static_cast<double>(v[q].y);
    acc[4 * q + 2] += static_cast<double>(v[q].z);
    acc[4 * q + 3] += static_cast<double>(v[q].w);
  }
}

}  // namespace

__global__ void __launch_bounds__(kScatterBlock) pack_vjp_kernel_scatter(
    const float* __restrict__ ct, const int* __restrict__ slot, const int* __restrict__ cum,
    float4* __restrict__ by_slot, long long capacity, long long P) {
  // a warp's 32 columns as rows of 4 float4, padded to 5 (80 bytes) so that
  // the 8 lanes of an access phase, one row each, meet in no bank
  __shared__ float4 s_v[kScatterBlock / 32][32][5];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long k = static_cast<long long>(blockIdx.x) * kScatterBlock + threadIdx.x;
  const long long live = clamp_slot(cum[P - 1], capacity);
  const int j = k < capacity ? slot[k] : 0;
  const bool ok = k < capacity && j < live;
  if (ok) {
    float v[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) v[r] = ct[r * capacity + k];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      s_v[warp][lane][q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
  const unsigned live_lanes = __ballot_sync(kFull, ok);
  __syncwarp();
  // store q: lanes 4c .. 4c + 3 write row 8q + c of the warp, whole
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = 8 * q + (lane >> 2), part = lane & 3;
    const int jr = __shfl_sync(kFull, j, r);
    if ((live_lanes >> r) & 1u)
      by_slot[4 * static_cast<long long>(jr) + part] = s_v[warp][r][part];
  }
}

__global__ void __launch_bounds__(32 * kWarps) pack_vjp_kernel(
    const float4* __restrict__ by_slot, const int* __restrict__ cum,
    const int* __restrict__ counts, float* __restrict__ d_rows, long long capacity,
    long long P) {
  __shared__ float4 s_rows[kWarps][kStage][4];
  __shared__ float s_out[kWarps][kRows][kChunk];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long g0 = (static_cast<long long>(blockIdx.x) * kWarps + warp) * kChunk;
  if (g0 >= P) return;
  const int cap = static_cast<int>(capacity);
  const int width = static_cast<int>(P - g0 < kChunk ? P - g0 : kChunk);
  // lane i < width: the segment [lo, hi) of Gaussian g0 + i, n instances
  int lo = 0, hi = 0;
  if (lane < width) {
    const int c = cum[g0 + lane];
    const int b = c - counts[g0 + lane];
    hi = min(max(c, 0), cap);
    lo = min(max(b, 0), cap);
  }
  const int n = max(hi - lo, 0);
  // the segments follow one another: the chunk's rows are [lo of the
  // first, hi of the last); the first kStage of them go to shared memory,
  // each row's four float4 in swizzled places, by asynchronous copies all
  // in flight at once
  const int first = __shfl_sync(kFull, lo, 0);
  const int staged = min(max(__shfl_sync(kFull, hi, width - 1) - first, 0), kStage);
  for (int t = lane; t < 4 * staged; t += 32)
    __pipeline_memcpy_async(&s_rows[warp][t >> 2][swizzle(t >> 2, t & 3)],
                            by_slot + 4 * static_cast<long long>(first) + t, sizeof(float4));
  __pipeline_commit();
  for (int t = lane; t < kRows * kChunk; t += 32) s_out[warp][t / kChunk][t % kChunk] = 0.f;
  const unsigned visible = __ballot_sync(kFull, lane < width && n > 0);
  __pipeline_wait_prior(0);
  __syncwarp();
  // Each Gaussian with instances: lane l sums instances l, l + 32, ... in
  // turn, from shared memory where they are staged, then the butterfly.
  for (unsigned left = visible; left; left &= left - 1) {
    const int i = __ffs(left) - 1;
    const int seg_lo = __shfl_sync(kFull, lo, i), seg_n = __shfl_sync(kFull, n, i);
    const int seg_at = seg_lo - first;
    const bool from_stage = seg_at >= 0 && seg_at + seg_n <= staged;
    auto fetch = [&](int m, float4(&v)[4]) {
      if (m >= seg_n) {
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = make_float4(0.f, 0.f, 0.f, 0.f);
      } else if (from_stage) {
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = s_rows[warp][seg_at + m][swizzle(seg_at + m, q)];
      } else {
        const float4* row = by_slot + 4 * (static_cast<long long>(seg_lo) + m);
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = row[q];
      }
    };
    double acc[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) acc[k] = 0.0;
    int m = lane;
    for (; m + 32 < seg_n; m += 64) {  // two rounds at a time: m, then m + 32
      float4 v0[4], v1[4];
      fetch(m, v0);
      fetch(m + 32, v1);
      add_row(acc, v0);
      add_row(acc, v1);
    }
    if (m < seg_n) {
      float4 v0[4];
      fetch(m, v0);
      add_row(acc, v0);
    }
    double a8[8], a4[4], a2[2], a1[1];
    fold<8>(acc, a8, lane, 16);
    fold<4>(a8, a4, lane, 8);
    fold<2>(a4, a2, lane, 4);
    fold<1>(a2, a1, lane, 2);
    const double sum = a1[0] + __shfl_xor_sync(kFull, a1[0], 1);  // row lane >> 1
    // (+ 0.0: a sum of -0.0 gives +0.0, as running sums from +0.0 do)
    if ((lane & 1) == 0) s_out[warp][lane >> 1][i] = __double2float_rn(sum + 0.0);
  }
  __syncwarp();
  for (int t = lane; t < kRows * kChunk; t += 32) {
    const int row = t / kChunk, i = t % kChunk;
    if (i < width) d_rows[row * P + g0 + i] = s_out[warp][row][i];
  }
}

extern "C" int pack_vjp(const void* ct, const void* slot, const void* cum, const void* counts,
                        void* by_slot, void* d_rows, long long capacity, long long P,
                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  pack_vjp_kernel_scatter<<<static_cast<unsigned>((capacity + kScatterBlock - 1) /
                                                  kScatterBlock),
                            kScatterBlock, 0, s>>>(
      static_cast<const float*>(ct), static_cast<const int*>(slot),
      static_cast<const int*>(cum), static_cast<float4*>(by_slot), capacity, P);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long per_block = static_cast<long long>(kWarps) * kChunk;
  pack_vjp_kernel<<<static_cast<unsigned>((P + per_block - 1) / per_block), 32 * kWarps, 0,
                    s>>>(static_cast<const float4*>(by_slot), static_cast<const int*>(cum),
                         static_cast<const int*>(counts), static_cast<float*>(d_rows),
                         capacity, P);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pack_vjp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
