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

}  // namespace composite
