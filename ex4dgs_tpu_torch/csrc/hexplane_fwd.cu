// Forward of 4D-GS's HexPlane field (Wu et al., CVPR 2024) for NVIDIA Hopper
// (sm_90a): each point's bilinear samples of the six planes of every scale,
// multiplied per scale, the scales side by side. It replaces no TPU kernel
// (the JAX package has no deformation field); it is the first kernel of the
// port that samples a feature grid. The plain version is
// ops/hexplane.py::hexplane_plain; the equations are in that module's
// docstring, and the arithmetic is the plain version's, rounded the same way
// (hexplane_common.cuh), so the two give the same bits.
//
// One thread per (point, channel), 16 points a block. A thread reads its
// point's four coordinates, then for each plane the four corners of its
// channel, and keeps the running product; the 16 threads of a point write
// its 16 features of a scale as one 64-byte run.
//
// What bounds it on the H100: the gathers. A point reads 4 corners x 16
// channels x 12 planes, 3 KB, from 9.46 MB of planes that stay in L2 (the
// least traffic, every plane read once and 144 B a point, would take ~16 us
// a view at HBM's rate); a corner's channels lie a whole channel slab apart
// in the source's [C, R_b, R_a] layout, so each 4-byte read is its own
// sector. The operations, ~1,700 a point, are far under either.
#include <cuda_runtime.h>

#include "hexplane_common.cuh"

using namespace hexplane;

__global__ void __launch_bounds__(kBlock) hexplane_fwd_kernel(
    const float4* __restrict__ coords, Planes planes, long long P, float* __restrict__ out) {
  const long long p = static_cast<long long>(blockIdx.x) * kPoints + threadIdx.x / kChannels;
  const int channel = threadIdx.x % kChannels;
  if (p >= P) return;
  const float4 c4 = coords[p];
  const float c[4] = {c4.x, c4.y, c4.z, c4.w};
  const int scales = planes.n / kPairs;
  for (int s = 0; s < scales; ++s) {
    float f = 1.f;
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int n = s * kPairs + k;
      int a, b;
      pair(k, a, b);
      const Axis xa = axis(c[a], planes.ra[n]);
      const Axis xb = axis(c[b], planes.rb[n]);
      f = __fmul_rn(f, sample(planes.p[n], planes.ra[n], planes.rb[n], channel, xa, xb).s);
    }
    out[(p * scales + s) * kChannels + channel] = f;
  }
}

extern "C" int hexplane_fwd(const void* coords, const void* plane_ptrs, const void* ra,
                            const void* rb, int n_planes, long long P, void* out, void* stream) {
  Planes planes;
  planes.n = n_planes;
  for (int i = 0; i < n_planes; ++i) {
    planes.p[i] = static_cast<const float* const*>(plane_ptrs)[i];
    planes.ra[i] = static_cast<const int*>(ra)[i];
    planes.rb[i] = static_cast<const int*>(rb)[i];
  }
  const unsigned blocks = static_cast<unsigned>((P + kPoints - 1) / kPoints);
  hexplane_fwd_kernel<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(coords), planes, P, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hexplane_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
