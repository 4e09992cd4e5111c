// What the HexPlane kernels share (csrc/hexplane_fwd.cu, csrc/hexplane_bwd.cu):
// the planes' descriptor passed by value, the pairs of coordinates, and one
// point's bilinear sample of one plane at one channel, as
// ops/hexplane.py::_axis and _samples compute it.
//
// Every product and sum is rounded on its own (__fmul_rn, __fadd_rn), in the
// plain version's order, so that nvcc fuses nothing: the forward gives the
// plain version's bits, and the backward differs from it only where it sums
// in another order (the coordinates' channel sums, the planes' atomics).
#pragma once

#include <cuda_runtime.h>

namespace hexplane {

constexpr int kChannels = 16;     // output_coordinate_dim: channels of every plane
constexpr int kPairs = 6;         // planes a scale
constexpr int kMaxPlanes = 24;    // up to 4 scales
constexpr int kPoints = 16;       // points a block: one thread per (point, channel)
constexpr int kBlock = kPoints * kChannels;

// The planes, scale-major, each [kChannels, rb, ra] contiguous (passed by
// value: the kernel's parameter space holds the pointers and sizes).
struct Planes {
  const float* p[kMaxPlanes];
  int ra[kMaxPlanes];
  int rb[kMaxPlanes];
  int n;
};

// Plane k's pair (a, b) of (x, y, z, t): (x,y), (x,z), (x,t), (y,z), (y,t), (z,t).
__device__ __forceinline__ void pair(int k, int& a, int& b) {
  a = k < 3 ? 0 : (k < 5 ? 1 : 2);
  b = k < 3 ? k + 1 : (k < 5 ? k - 1 : 3);
}

// One axis: u = clamp((c + 1) / 2 (R - 1), 0, R - 1) (a NaN goes to 0),
// i0 = min(floor(u), R - 2), w = u - i0, du/dc = (R - 1) / 2 strictly inside
// and 0 where u was clamped.
struct Axis {
  int i0;
  float w, dudc;
};

__device__ __forceinline__ Axis axis(float c, int R) {
  const float rm1 = static_cast<float>(R - 1);
  const float u = __fmul_rn(__fmul_rn(__fadd_rn(c, 1.f), 0.5f), rm1);
  Axis ax;
  ax.dudc = (u > 0.f && u < rm1) ? 0.5f * rm1 : 0.f;
  const float uc = fminf(fmaxf(u, 0.f), rm1);  // fmaxf(NaN, 0) = 0
  const int i0 = min(static_cast<int>(floorf(uc)), R - 2);
  ax.i0 = i0;
  ax.w = __fsub_rn(uc, static_cast<float>(i0));
  return ax;
}

// The corners of one plane at one channel, and the sample.
struct Sample {
  float v00, v01, v10, v11, s;
  long long o00;  // flat offset of (j, i) in the channel's [rb, ra] slab
};

__device__ __forceinline__ Sample sample(const float* __restrict__ plane, int ra, int rb,
                                         int channel, const Axis& xa, const Axis& xb) {
  const float* base = plane + static_cast<long long>(channel) * ra * rb;
  Sample s;
  s.o00 = static_cast<long long>(xb.i0) * ra + xa.i0;
  s.v00 = __ldg(base + s.o00);
  s.v01 = __ldg(base + s.o00 + 1);
  s.v10 = __ldg(base + s.o00 + ra);
  s.v11 = __ldg(base + s.o00 + ra + 1);
  const float ma = __fsub_rn(1.f, xa.w), mb = __fsub_rn(1.f, xb.w);
  const float lo = __fadd_rn(__fmul_rn(ma, s.v00), __fmul_rn(xa.w, s.v01));
  const float hi = __fadd_rn(__fmul_rn(ma, s.v10), __fmul_rn(xa.w, s.v11));
  s.s = __fadd_rn(__fmul_rn(mb, lo), __fmul_rn(xb.w, hi));
  return s;
}

}  // namespace hexplane
