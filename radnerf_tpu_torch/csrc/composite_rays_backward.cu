// Kernel C': front-to-back alpha compositing, backward.
//
// Replaces the gradient of radnerf_tpu/ops/marching.py: composite_rays
// (:757-786), which JAX takes by autodiff of its masked cumprod. With
// c_k = g_ws + g_depth * (t_k + dt_k) + g_image . rgb_k the loss is
// sum_k w_k c_k over the processed steps, and for a processed valid step s
//
//   d sigma_s   = dt_s * (c_s * T_after_s - sum_{k > s} w_k c_k)
//   d rgb_s     = g_image * w_s
//   d ambient_s = g_ambient_sum
//
// with T_after_s the transmittance after step s. The suffix sums
// sum_{k > s} come from the saved forward outputs minus the prefix sums
// recomputed here (reference raymarching.cu:711-809), so one pass suffices.
// The processed mask carries no gradient; invalid steps, and steps past the
// early stop, get exactly zero.
//
// What bounds it on an H100: bytes. Per processed step it reads sigma, dt,
// t, valid and rgb (25 B) and writes 20 B of gradients for ~40 flops and
// one expf; every step of the [N, S] lattice is written (zeros past the
// stop). Design: one thread per ray, the walk of kernel C repeated with the
// same float32 operations in the same order, so the prefix sums at the last
// processed step equal the saved outputs exactly and the suffixes end at 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void composite_rays_bwd_kernel(
    const float* __restrict__ sigmas, const float* __restrict__ rgbs,
    const float* __restrict__ dts, const float* __restrict__ ts,
    const bool* __restrict__ valid, const float* __restrict__ image,
    const float* __restrict__ depth, const float* __restrict__ weights_sum,
    const float* __restrict__ grad_image, const float* __restrict__ grad_depth,
    const float* __restrict__ grad_ws, const float* __restrict__ grad_amb,
    float* __restrict__ grad_sigmas, float* __restrict__ grad_rgbs,
    float* __restrict__ grad_ambient, long long N, int S, float T_thresh) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const float gr = grad_image[3 * n], gg = grad_image[3 * n + 1],
              gb = grad_image[3 * n + 2];
  const float gd = grad_depth[n], gw = grad_ws[n], ga = grad_amb[n];
  const float r_fin = image[3 * n], g_fin = image[3 * n + 1],
              b_fin = image[3 * n + 2];
  const float d_fin = depth[n], ws_fin = weights_sum[n];

  float T = 1.0f;  // transmittance before the step
  float ws = 0.0f, dep = 0.0f, r = 0.0f, g = 0.0f, b = 0.0f;
  int s = 0;
  for (; s < S; ++s) {
    const long long i = n * S + s;
    if (valid[i]) {
      const float sig = sigmas[i];
      const float dt = dts[i];
      const float alpha = 1.0f - expf(-sig * dt);
      const float w = alpha * T;
      const float td = ts[i] + dt;
      const float cr = rgbs[3 * i], cg = rgbs[3 * i + 1], cb = rgbs[3 * i + 2];
      ws = ws + w;
      dep = dep + w * td;
      r = r + w * cr;
      g = g + w * cg;
      b = b + w * cb;
      T = T * (1.0f - alpha);
      const float own = gw * T + gd * (td * T) + gr * (cr * T) + gg * (cg * T) +
                        gb * (cb * T);
      const float later = gw * (ws_fin - ws) + gd * (d_fin - dep) +
                          gr * (r_fin - r) + gg * (g_fin - g) + gb * (b_fin - b);
      grad_sigmas[i] = dt * (own - later);
      grad_rgbs[3 * i] = gr * w;
      grad_rgbs[3 * i + 1] = gg * w;
      grad_rgbs[3 * i + 2] = gb * w;
      grad_ambient[i] = ga;
    } else {
      grad_sigmas[i] = 0.0f;
      grad_rgbs[3 * i] = 0.0f;
      grad_rgbs[3 * i + 1] = 0.0f;
      grad_rgbs[3 * i + 2] = 0.0f;
      grad_ambient[i] = 0.0f;
    }
    if (!(T >= T_thresh)) {  // later steps were not processed
      ++s;
      break;
    }
  }
  for (; s < S; ++s) {
    const long long i = n * S + s;
    grad_sigmas[i] = 0.0f;
    grad_rgbs[3 * i] = 0.0f;
    grad_rgbs[3 * i + 1] = 0.0f;
    grad_rgbs[3 * i + 2] = 0.0f;
    grad_ambient[i] = 0.0f;
  }
}

}  // namespace

extern "C" int composite_rays_bwd(
    const void* sigmas, const void* rgbs, const void* dts, const void* ts,
    const void* valid, const void* image, const void* depth,
    const void* weights_sum, const void* grad_image, const void* grad_depth,
    const void* grad_ws, const void* grad_amb, void* grad_sigmas,
    void* grad_rgbs, void* grad_ambient, long long N, int S, float T_thresh,
    void* stream) {
  const int threads = 128;
  const unsigned blocks = (unsigned)((N + threads - 1) / threads);
  composite_rays_bwd_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)sigmas, (const float*)rgbs, (const float*)dts,
      (const float*)ts, (const bool*)valid, (const float*)image,
      (const float*)depth, (const float*)weights_sum, (const float*)grad_image,
      (const float*)grad_depth, (const float*)grad_ws, (const float*)grad_amb,
      (float*)grad_sigmas, (float*)grad_rgbs, (float*)grad_ambient, N, S,
      T_thresh);
  return (int)cudaGetLastError();
}
