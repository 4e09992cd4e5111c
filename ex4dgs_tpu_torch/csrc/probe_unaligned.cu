// Layout probe P1 for NVIDIA Hopper (sm_90a): staging windows of a
// feature-major buffer from unaligned starts.
//
// Replaces the TPU probe tools/tpu_probes/_tpu_unaligned.py::kern, which
// DMAs a [16, 256] window at a dynamic lane offset of f32[16, N] into VMEM
// and writes it out. Here one block per window copies
//
//   out[p, r, c] = src[r, offsets[p] + c]      r < 16, c < 256
//
// through shared memory. It asks what kernels A and B pay for staging a
// tile's instance rows of data[16, capacity] from the tile's own start,
// which is arbitrary (csrc/composite_fwd.cu's and composite_bwd.cu's
// staging loops): a warp reading 32 floats of a row from an unaligned start
// touches five 32-byte sectors instead of four.
//
// Design: 256 threads, thread c loads column c of all 16 rows into
// buf[16][256] (each warp reads 128 consecutive bytes of a row, the loads of
// a thread all in flight together), then __syncthreads, then stores
// out[p, r, c] coalesced. This is kernel A's staging loop as a kernel of its
// own. The loads are plain 4-byte loads, which need no alignment: 16-byte
// vector loads or cp.async would need a 16-byte-aligned src + offset, and
// the offsets are arbitrary (a TMA variant is later work).
//
// What bounds it on the H100: bytes. Each window is read once and written
// once (2 * 16 KiB per block) and there is no arithmetic, so at best it runs
// at the memory rate; windows that overlap may be served from L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 16;
constexpr int kWindow = 256;

__global__ void __launch_bounds__(kWindow)
probe_unaligned_kernel(const float* __restrict__ src, const int32_t* __restrict__ offsets,
                       float* __restrict__ out, long long n) {
  __shared__ float buf[kRows][kWindow];
  const int c = threadIdx.x;
  const long long off = offsets[blockIdx.x];
#pragma unroll
  for (int r = 0; r < kRows; ++r) buf[r][c] = src[r * n + off + c];
  __syncthreads();
  float* o = out + static_cast<long long>(blockIdx.x) * kRows * kWindow;
#pragma unroll
  for (int r = 0; r < kRows; ++r) o[r * kWindow + c] = buf[r][c];
}

}  // namespace

extern "C" int probe_unaligned(const void* src, const void* offsets, void* out, long long n,
                               int num_windows, void* stream) {
  probe_unaligned_kernel<<<num_windows, kWindow, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const int32_t*>(offsets),
      static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* probe_unaligned_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
