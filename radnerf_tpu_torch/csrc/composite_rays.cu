// Kernel C: front-to-back alpha compositing of a [N, S] sample lattice.
//
// Replaces radnerf_tpu/ops/marching.py: composite_rays (:731-786). The TPU
// form is a masked cumprod over the whole lattice (every step of every ray
// is computed, then masked off past T_thresh) because a TPU has no per-ray
// early exit. On Hopper it is the reference's own structure: one thread per
// ray runs its S steps and stops once the transmittance after a step falls
// below T_thresh (the crossing step is included; transmittance never rises,
// so every later step would be masked).
//
// What bounds it on an H100: bytes. Per processed step it reads sigma, dt,
// t, valid, rgb and ambient (29 B) for ~20 flops and one expf; per ray it
// writes 24 B. Design: the valid byte is read first and an invalid step
// reads nothing else; the early exit skips the rest of the row.
//
// Arithmetic mirrors the plain twin (ops/marching.py composite_rays_plain)
// op for op, with sequential float32 sums.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void composite_rays_kernel(
    const float* __restrict__ sigmas, const float* __restrict__ rgbs,
    const float* __restrict__ dts, const float* __restrict__ ts,
    const bool* __restrict__ valid, const float* __restrict__ ambient,
    float* __restrict__ image, float* __restrict__ depth,
    float* __restrict__ weights_sum, float* __restrict__ ambient_sum,
    long long N, int S, float T_thresh) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float T = 1.0f;  // transmittance before the step
  float ws = 0.0f, dep = 0.0f, r = 0.0f, g = 0.0f, b = 0.0f, amb = 0.0f;
  for (int s = 0; s < S; ++s) {
    const long long i = n * S + s;
    if (valid[i]) {
      const float sig = sigmas[i];
      const float dt = dts[i];
      const float alpha = 1.0f - expf(-sig * dt);
      const float w = alpha * T;
      ws = ws + w;
      dep = dep + w * (ts[i] + dt);
      r = r + w * rgbs[3 * i];
      g = g + w * rgbs[3 * i + 1];
      b = b + w * rgbs[3 * i + 2];
      amb = amb + ambient[i];
      T = T * (1.0f - alpha);
    }
    if (!(T >= T_thresh)) break;  // later steps are not processed
  }
  image[3 * n] = r;
  image[3 * n + 1] = g;
  image[3 * n + 2] = b;
  depth[n] = dep;
  weights_sum[n] = ws;
  ambient_sum[n] = amb;
}

}  // namespace

extern "C" int composite_rays_fwd(const void* sigmas, const void* rgbs,
                                  const void* dts, const void* ts,
                                  const void* valid, const void* ambient,
                                  void* image, void* depth, void* weights_sum,
                                  void* ambient_sum, long long N, int S,
                                  float T_thresh, void* stream) {
  const int threads = 128;
  const unsigned blocks = (unsigned)((N + threads - 1) / threads);
  composite_rays_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)sigmas, (const float*)rgbs, (const float*)dts,
      (const float*)ts, (const bool*)valid, (const float*)ambient,
      (float*)image, (float*)depth, (float*)weights_sum, (float*)ambient_sum, N,
      S, T_thresh);
  return (int)cudaGetLastError();
}
