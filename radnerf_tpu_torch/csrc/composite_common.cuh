// The per-step update of front-to-back compositing, shared by kernel C
// (composite_rays.cu) and kernel C' (composite_rays_backward.cu).
//
// C' takes the suffix sums of its gradient as C's saved outputs minus the
// prefix sums it recomputes; they end at exactly 0 only if both walks run
// the same float32 operations in the same order. Both take the step from
// here, so the two cannot drift apart, and both stay op for op with the
// plain twin (ops/marching.py composite_rays_plain); the libraries are built
// with -fmad=false.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace composite {

// Transmittance before the next step and the running sums of one ray.
struct Sums {
  float T = 1.0f;
  float ws = 0.0f, depth = 0.0f, r = 0.0f, g = 0.0f, b = 0.0f;
};

// Whether slot s is processed: slot 0 always, a later one while the
// transmittance after the previous step is at least T_thresh (the crossing
// step is included; T never rises, so once false it stays false).
__device__ __forceinline__ bool processes(int s, const Sums& a, float T_thresh) {
  return s == 0 || a.T >= T_thresh;
}

// One processed valid step: alpha = 1 - exp(-sigma dt), weight w = alpha T,
// the five weighted sums, then T *= 1 - alpha. Returns w.
__device__ __forceinline__ float step(Sums& a, float sigma, float dt, float t, float cr,
                                      float cg, float cb) {
  const float alpha = 1.0f - expf(-sigma * dt);
  const float w = alpha * a.T;
  a.ws = a.ws + w;
  a.depth = a.depth + w * (t + dt);
  a.r = a.r + w * cr;
  a.g = a.g + w * cg;
  a.b = a.b + w * cb;
  a.T = a.T * (1.0f - alpha);
  return w;
}

// valid slots c0 .. c0 + w - 1 (w <= 16) of a row as bits 0 .. w - 1
template <bool kRow16>
__device__ __forceinline__ uint32_t valid_bits(const uint8_t* __restrict__ v, int w) {
  uint32_t bits = 0;
  if (kRow16) {  // w == 16 and v 16-byte aligned (S a multiple of 16)
    const uint4 q = *reinterpret_cast<const uint4*>(v);
    const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // one bit per nonzero byte, bytes 0..3 -> bits 0..3
      const uint32_t m = __vcmpne4(words[j], 0u) & 0x01010101u;
      bits |= ((m * 0x01020408u) >> 24) << (4 * j);
    }
  } else {
    for (int j = 0; j < w; ++j) bits |= (uint32_t)(v[j] != 0) << j;
  }
  return bits;
}

}  // namespace composite
